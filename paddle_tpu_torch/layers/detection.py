"""Detection layers (reference: python/paddle/fluid/layers/detection.py).

A copy of `paddle_tpu/layers/detection.py`: the same ops, slots and attrs,
so programs built by either package serialize alike."""

from __future__ import annotations

from ..framework.layer_helper import LayerHelper

__all__ = ["deformable_roi_pooling", "retinanet_target_assign",
           "multi_box_head",
           "prior_box", "anchor_generator", "box_coder", "iou_similarity",
           "yolo_box", "multiclass_nms", "roi_align", "box_clip",
           "detection_output", "sigmoid_focal_loss", "yolov3_loss",
           "density_prior_box", "polygon_box_transform",
           "box_decoder_and_assign", "bipartite_match", "target_assign",
           "mine_hard_examples", "rpn_target_assign", "roi_pool",
           "generate_proposals", "distribute_fpn_proposals",
           "collect_fpn_proposals", "retinanet_detection_output",
           "ssd_loss", "generate_proposal_labels", "generate_mask_labels",
           "roi_perspective_transform", "deformable_psroi_pooling",
           "detection_map"]


def _op(name, op_type, ins, out_slots, attrs=None, persist=()):
    helper = LayerHelper(name)
    outs = {}
    ret = []
    for slot in out_slots:
        v = helper.create_variable_for_type_inference("float32")
        outs[slot] = [v.name]
        ret.append(v)
    helper.append_op(op_type, ins, outs, attrs or {})
    return ret if len(ret) > 1 else ret[0]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=None, flip=True, clip=True, steps=None, offset=0.5,
              name=None):
    """reference: layers/detection.py prior_box."""
    steps = steps or [0.0, 0.0]
    return _op("prior_box", "prior_box",
               {"Input": [input.name], "Image": [image.name]},
               ["Boxes", "Variances"],
               {"min_sizes": list(min_sizes),
                "max_sizes": list(max_sizes or []),
                "aspect_ratios": list(aspect_ratios or [1.0]),
                "variances": list(variance or [0.1, 0.1, 0.2, 0.2]),
                "flip": flip, "clip": clip,
                "step_w": steps[0], "step_h": steps[1], "offset": offset})


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=None, stride=None, offset=0.5, name=None):
    return _op("anchor_generator", "anchor_generator",
               {"Input": [input.name]}, ["Anchors", "Variances"],
               {"anchor_sizes": list(anchor_sizes or [64., 128., 256.]),
                "aspect_ratios": list(aspect_ratios or [0.5, 1.0, 2.0]),
                "variances": list(variance or [0.1, 0.1, 0.2, 0.2]),
                "stride": list(stride or [16.0, 16.0]), "offset": offset})


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None, axis=0):
    ins = {"PriorBox": [prior_box.name], "TargetBox": [target_box.name]}
    if prior_box_var is not None:
        ins["PriorBoxVar"] = [prior_box_var.name]
    return _op("box_coder", "box_coder", ins, ["OutputBox"],
               {"code_type": code_type, "box_normalized": box_normalized})


def iou_similarity(x, y, box_normalized=True, name=None):
    return _op("iou_similarity", "iou_similarity",
               {"X": [x.name], "Y": [y.name]}, ["Out"],
               {"box_normalized": box_normalized})


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, name=None):
    return _op("yolo_box", "yolo_box",
               {"X": [x.name], "ImgSize": [img_size.name]},
               ["Boxes", "Scores"],
               {"anchors": list(anchors), "class_num": class_num,
                "conf_thresh": conf_thresh,
                "downsample_ratio": downsample_ratio,
                "clip_bbox": clip_bbox})


def multiclass_nms(bboxes, scores, score_threshold=0.01, nms_top_k=64,
                   keep_top_k=16, nms_threshold=0.3, normalized=True,
                   background_label=-1, name=None):
    """Fixed-size result: [n, keep_top_k, 6] rows (label, score, box),
    label -1 = padding; second output is the per-image valid count."""
    return _op("multiclass_nms", "multiclass_nms",
               {"BBoxes": [bboxes.name], "Scores": [scores.name]},
               ["Out", "NmsRoisNum"],
               {"score_threshold": score_threshold, "nms_top_k": nms_top_k,
                "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
                "normalized": normalized,
                "background_label": background_label})


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, rois_num=None,
              name=None):
    ins = {"X": [input.name], "ROIs": [rois.name]}
    if rois_num is not None:
        ins["RoisNum"] = [rois_num.name]
    return _op("roi_align", "roi_align", ins, ["Out"],
               {"pooled_height": pooled_height, "pooled_width": pooled_width,
                "spatial_scale": spatial_scale,
                "sampling_ratio": sampling_ratio})


def box_clip(input, im_info, name=None):
    return _op("box_clip", "box_clip",
               {"Input": [input.name], "ImInfo": [im_info.name]},
               ["Output"])


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=64,
                     keep_top_k=16, score_threshold=0.01, name=None):
    """SSD head: decode loc against priors then NMS (reference
    layers/detection.py detection_output)."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    return multiclass_nms(decoded, scores, score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label)


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25, name=None):
    """reference: layers/detection.py sigmoid_focal_loss."""
    return _op("sigmoid_focal_loss", "sigmoid_focal_loss",
               {"X": [x.name], "Label": [label.name],
                "FgNum": [fg_num.name]}, ["Out"],
               {"gamma": gamma, "alpha": alpha})


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    """reference: layers/detection.py yolov3_loss. Returns Loss [n]."""
    helper = LayerHelper(name or "yolov3_loss")
    ins = {"X": [x.name], "GTBox": [gt_box.name],
           "GTLabel": [gt_label.name]}
    if gt_score is not None:
        ins["GTScore"] = [gt_score.name]
    loss = helper.create_variable_for_type_inference("float32")
    obj = helper.create_variable_for_type_inference("float32")
    match = helper.create_variable_for_type_inference("int32")
    helper.append_op("yolov3_loss", ins,
                     {"Loss": [loss.name], "ObjectnessMask": [obj.name],
                      "GTMatchMask": [match.name]},
                     {"anchors": list(anchors),
                      "anchor_mask": list(anchor_mask),
                      "class_num": class_num,
                      "ignore_thresh": ignore_thresh,
                      "downsample_ratio": downsample_ratio,
                      "use_label_smooth": use_label_smooth})
    return loss


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=None, clip=False, steps=None, offset=0.5,
                      flatten_to_2d=False, name=None):
    steps = steps or [0.0, 0.0]
    boxes, variances = _op(
        "density_prior_box", "density_prior_box",
        {"Input": [input.name], "Image": [image.name]},
        ["Boxes", "Variances"],
        {"densities": list(densities), "fixed_sizes": list(fixed_sizes),
         "fixed_ratios": list(fixed_ratios),
         "variances": list(variance or [0.1, 0.1, 0.2, 0.2]),
         "clip": clip, "step_w": steps[0], "step_h": steps[1],
         "offset": offset})
    if flatten_to_2d:
        from . import tensor as t_layers
        boxes = t_layers.reshape(boxes, [-1, 4])
        variances = t_layers.reshape(variances, [-1, 4])
    return boxes, variances


def polygon_box_transform(input, name=None):
    return _op("polygon_box_transform", "polygon_box_transform",
               {"Input": [input.name]}, ["Output"])


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip, name=None):
    return _op("box_decoder_and_assign", "box_decoder_and_assign",
               {"PriorBox": [prior_box.name],
                "PriorBoxVar": [prior_box_var.name],
                "TargetBox": [target_box.name],
                "BoxScore": [box_score.name]},
               ["DecodeBox", "OutputAssignBox"], {"box_clip": box_clip})


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    helper = LayerHelper(name or "bipartite_match")
    midx = helper.create_variable_for_type_inference("int32")
    mdist = helper.create_variable_for_type_inference("float32")
    helper.append_op("bipartite_match",
                     {"DistMat": [dist_matrix.name]},
                     {"ColToRowMatchIndices": [midx.name],
                      "ColToRowMatchDist": [mdist.name]},
                     {"match_type": match_type,
                      "dist_threshold": dist_threshold})
    return midx, mdist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    helper = LayerHelper(name or "target_assign")
    ins = {"X": [input.name], "MatchIndices": [matched_indices.name]}
    if negative_indices is not None:
        ins["NegIndices"] = [negative_indices.name]
    out = helper.create_variable_for_type_inference("float32")
    wt = helper.create_variable_for_type_inference("float32")
    helper.append_op("target_assign", ins,
                     {"Out": [out.name], "OutWeight": [wt.name]},
                     {"mismatch_value": mismatch_value})
    return out, wt


def mine_hard_examples(cls_loss, match_indices, match_dist, loc_loss=None,
                       neg_pos_ratio=3.0, neg_dist_threshold=0.5,
                       mining_type="max_negative", sample_size=0,
                       name=None):
    helper = LayerHelper(name or "mine_hard_examples")
    ins = {"ClsLoss": [cls_loss.name],
           "MatchIndices": [match_indices.name],
           "MatchDist": [match_dist.name]}
    if loc_loss is not None:
        ins["LocLoss"] = [loc_loss.name]
    neg = helper.create_variable_for_type_inference("int32")
    cnt = helper.create_variable_for_type_inference("int32")
    upd = helper.create_variable_for_type_inference("int32")
    helper.append_op("mine_hard_examples", ins,
                     {"NegIndices": [neg.name], "NegCount": [cnt.name],
                      "UpdatedMatchIndices": [upd.name]},
                     {"neg_pos_ratio": neg_pos_ratio,
                      "neg_dist_threshold": neg_dist_threshold,
                      "mining_type": mining_type,
                      "sample_size": sample_size})
    return neg, upd


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, im_info, is_crowd=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True,
                      name=None):
    """Fixed-shape redesign (see ops/detection_ops.py). Returns, in the
    reference's order: (loc_index, score_index, target_bbox,
    target_label, bbox_inside_weight) — the index tensors are fixed-size
    [n, A] padded with -1; targets/labels/weights are per-anchor."""
    helper = LayerHelper(name or "rpn_target_assign")
    ins = {"Anchor": [anchor_box.name], "GtBoxes": [gt_boxes.name],
           "ImInfo": [im_info.name]}
    if is_crowd is not None:
        ins["IsCrowd"] = [is_crowd.name]
    lbl = helper.create_variable_for_type_inference("int32")
    tgt = helper.create_variable_for_type_inference("float32")
    inw = helper.create_variable_for_type_inference("float32")
    loc = helper.create_variable_for_type_inference("int32")
    sc = helper.create_variable_for_type_inference("int32")
    helper.append_op("rpn_target_assign", ins,
                     {"TargetLabel": [lbl.name], "TargetBBox": [tgt.name],
                      "BBoxInsideWeight": [inw.name],
                      "LocationIndex": [loc.name],
                      "ScoreIndex": [sc.name]},
                     {"rpn_batch_size_per_im": rpn_batch_size_per_im,
                      "rpn_straddle_thresh": rpn_straddle_thresh,
                      "rpn_fg_fraction": rpn_fg_fraction,
                      "rpn_positive_overlap": rpn_positive_overlap,
                      "rpn_negative_overlap": rpn_negative_overlap,
                      "use_random": use_random})
    return loc, sc, tgt, lbl, inw


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_num=None, name=None):
    helper = LayerHelper(name or "roi_pool")
    ins = {"X": [input.name], "ROIs": [rois.name]}
    if rois_num is not None:
        ins["RoisNum"] = [rois_num.name]
    out = helper.create_variable_for_type_inference("float32")
    argmax = helper.create_variable_for_type_inference("int64")
    helper.append_op("roi_pool", ins,
                     {"Out": [out.name], "Argmax": [argmax.name]},
                     {"pooled_height": pooled_height,
                      "pooled_width": pooled_width,
                      "spatial_scale": spatial_scale})
    return out


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    """Fixed-size redesign: RpnRois [n, post_nms_top_n, 4] zero-padded,
    RpnRoiProbs [n, post_nms_top_n, 1], RpnRoisNum [n] valid counts."""
    return _op("generate_proposals", "generate_proposals",
               {"Scores": [scores.name], "BboxDeltas": [bbox_deltas.name],
                "ImInfo": [im_info.name], "Anchors": [anchors.name],
                "Variances": [variances.name]},
               ["RpnRois", "RpnRoiProbs", "RpnRoisNum"],
               {"pre_nms_topN": pre_nms_top_n,
                "post_nms_topN": post_nms_top_n,
                "nms_thresh": nms_thresh, "min_size": min_size,
                "eta": eta})


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None, name=None):
    helper = LayerHelper(name or "distribute_fpn_proposals")
    num_level = max_level - min_level + 1
    outs = [helper.create_variable_for_type_inference("float32")
            for _ in range(num_level)]
    counts = helper.create_variable_for_type_inference("int32")
    restore = helper.create_variable_for_type_inference("int32")
    ins = {"FpnRois": [fpn_rois.name]}
    if rois_num is not None:
        ins["RoisNum"] = [rois_num.name]
    helper.append_op("distribute_fpn_proposals",
                     ins,
                     {"MultiFpnRois": [o.name for o in outs],
                      "MultiLevelCounts": [counts.name],
                      "RestoreIndex": [restore.name]},
                     {"min_level": min_level, "max_level": max_level,
                      "refer_level": refer_level,
                      "refer_scale": refer_scale})
    return outs, restore


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None):
    helper = LayerHelper(name or "collect_fpn_proposals")
    out = helper.create_variable_for_type_inference("float32")
    cnt = helper.create_variable_for_type_inference("int32")
    helper.append_op("collect_fpn_proposals",
                     {"MultiLevelRois": [r.name for r in multi_rois],
                      "MultiLevelScores": [s.name for s in multi_scores]},
                     {"FpnRois": [out.name], "RoisCount": [cnt.name]},
                     {"post_nms_topN": post_nms_top_n})
    return out


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0, name=None):
    helper = LayerHelper(name or "retinanet_detection_output")
    out = helper.create_variable_for_type_inference("float32")
    cnt = helper.create_variable_for_type_inference("int32")
    helper.append_op("retinanet_detection_output",
                     {"BBoxes": [b.name for b in bboxes],
                      "Scores": [s.name for s in scores],
                      "Anchors": [a.name for a in anchors],
                      "ImInfo": [im_info.name]},
                     {"Out": [out.name], "NmsRoisNum": [cnt.name]},
                     {"score_threshold": score_threshold,
                      "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                      "nms_threshold": nms_threshold})
    return out


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, mismatch_value=0, name=None):
    """SSD multibox loss composed from the matching/assignment primitives
    (reference: layers/detection.py ssd_loss). Dense redesign: gt_box
    [n, b, 4], gt_label [n, b, 1] int; location [n, p, 4] encoded deltas,
    confidence [n, p, cls]; prior_box [p, 4]. Returns [n, p, 1] loss.

    Pipeline (as in the reference): iou -> bipartite match -> hard-negative
    mining -> target assign (loc + conf) -> smooth_l1 + softmax xent.
    """
    from . import nn as nn_layers
    from . import tensor as t_layers
    from . import math as m_layers

    n, b = gt_box.shape[0], gt_box.shape[1]
    p = prior_box.shape[0]
    # 1. per-image IoU between gts [b,4] and priors [p,4] -> match
    iou = iou_similarity(t_layers.reshape(gt_box, [-1, 4]), prior_box)
    iou3 = t_layers.reshape(iou, [n, b, p])
    midx, mdist = bipartite_match(iou3, "per_prediction",
                                  overlap_threshold)
    # 2. mining loss proxy: background probability shortfall per prior
    conf_sm = nn_layers.softmax(confidence)
    bg_prob = t_layers.reshape(
        t_layers.slice(conf_sm, axes=[2], starts=[background_label],
                       ends=[background_label + 1]), [n, p])
    mine_loss = m_layers.scale(bg_prob, scale=-1.0, bias=1.0)
    neg_idx, upd_idx = mine_hard_examples(
        mine_loss, midx, mdist, neg_pos_ratio=neg_pos_ratio,
        neg_dist_threshold=neg_overlap)
    # 3. targets. Location regression is trained against ENCODED deltas:
    # box_coder(encode) gives per-(gt, prior) deltas [n*b, p, 4], and the
    # 4-D target_assign gathers row (matched gt, prior) for each prior —
    # matching the reference's encoded-bbox path. Without a variance var
    # the encode uses unit variances.
    enc = box_coder(prior_box, prior_box_var,
                    t_layers.reshape(gt_box, [-1, 4]),
                    code_type="encode_center_size")
    enc4 = t_layers.reshape(enc, [n, b, p, 4])
    loc_tgt, loc_w = target_assign(enc4, upd_idx, mismatch_value=0)
    lbl_tgt, conf_w = target_assign(gt_label, upd_idx,
                                    negative_indices=neg_idx,
                                    mismatch_value=background_label)
    # 4. losses (smooth_l1 sums all but dim 0, so flatten priors into the
    # batch dim first — the reference ssd_loss does the same 2-D reshape)
    loc_l = nn_layers.smooth_l1(
        t_layers.reshape(location, [-1, 4]),
        t_layers.reshape(loc_tgt, [-1, 4]),
        inside_weight=t_layers.reshape(loc_w, [-1, 1]),
        outside_weight=t_layers.reshape(loc_w, [-1, 1]))
    loc_l = t_layers.reshape(loc_l, [n, p, 1])
    conf_l = nn_layers.softmax_with_cross_entropy(
        confidence, t_layers.cast(lbl_tgt, "int64"))
    loss = m_layers.elementwise_add(
        m_layers.scale(loc_l, scale=loc_loss_weight),
        m_layers.scale(m_layers.elementwise_mul(conf_l, conf_w),
                       scale=conf_loss_weight))
    return loss


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=None, class_nums=None,
                             use_random=True, is_cls_agnostic=False,
                             is_cascade_rcnn=False, name=None):
    """reference: layers/detection.py generate_proposal_labels (detection/
    generate_proposal_labels_op.cc). Dense shapes: rpn_rois [n, R, 4],
    gt_* [n, G, ...]; outputs are [n, batch_size_per_im, ...]."""
    ins = {"RpnRois": [rpn_rois.name], "GtClasses": [gt_classes.name],
           "GtBoxes": [gt_boxes.name], "ImInfo": [im_info.name]}
    if is_crowd is not None:
        ins["IsCrowd"] = [is_crowd.name]
    return _op("generate_proposal_labels", "generate_proposal_labels",
               ins,
               ["Rois", "LabelsInt32", "BboxTargets", "BboxInsideWeights",
                "BboxOutsideWeights", "MatchedGtInt32", "FgMask"],
               {"batch_size_per_im": batch_size_per_im,
                "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
                "bg_thresh_hi": bg_thresh_hi, "bg_thresh_lo": bg_thresh_lo,
                "bbox_reg_weights": bbox_reg_weights or [0.1, 0.1, 0.2, 0.2],
                "class_nums": class_nums or 81,
                "use_random": use_random,
                "is_cls_agnostic": is_cls_agnostic,
                "is_cascade_rcnn": is_cascade_rcnn})


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution,
                         matched_gt_int32=None, name=None):
    """reference: layers/detection.py generate_mask_labels (detection/
    generate_mask_labels_op.cc). gt_segms here are RASTERIZED dense masks
    [n, G, Hm, Wm] (see ops/detection_extra_ops.py docstring)."""
    ins = {"ImInfo": [im_info.name], "GtClasses": [gt_classes.name],
           "GtSegms": [gt_segms.name], "Rois": [rois.name],
           "LabelsInt32": [labels_int32.name]}
    if is_crowd is not None:
        ins["IsCrowd"] = [is_crowd.name]
    if matched_gt_int32 is not None:
        ins["MatchedGtInt32"] = [matched_gt_int32.name]
    return _op("generate_mask_labels", "generate_mask_labels", ins,
               ["MaskRois", "RoiHasMaskInt32", "MaskInt32"],
               {"num_classes": num_classes, "resolution": resolution})


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              name=None):
    """reference: layers/detection.py roi_perspective_transform
    (detection/roi_perspective_transform_op.cc). rois: [n, R, 8] quads."""
    return _op("roi_perspective_transform", "roi_perspective_transform",
               {"X": [input.name], "ROIs": [rois.name]},
               ["Out", "Mask", "TransformMatrix", "Out2InIdx",
                "Out2InWeights"],
               {"transformed_height": transformed_height,
                "transformed_width": transformed_width,
                "spatial_scale": spatial_scale})


def deformable_psroi_pooling(input, rois, trans=None, no_trans=False,
                             spatial_scale=1.0, output_dim=None,
                             group_size=None, pooled_height=1,
                             pooled_width=1, part_size=None,
                             sample_per_part=1, trans_std=0.1, name=None):
    """reference: layers/nn.py deformable_roi_pooling
    (deformable_psroi_pooling_op.cc)."""
    if output_dim is None:
        raise ValueError(
            "deformable_psroi_pooling requires output_dim (the number of "
            "output channels; Input channels must equal "
            "output_dim * pooled_height * pooled_width)")
    ins = {"Input": [input.name], "ROIs": [rois.name]}
    if trans is not None:
        ins["Trans"] = [trans.name]
    return _op("deformable_psroi_pooling", "deformable_psroi_pooling",
               ins, ["Output", "TopCount"],
               {"no_trans": no_trans or trans is None,
                "spatial_scale": spatial_scale,
                "output_dim": output_dim,
                "group_size": group_size or [pooled_height, pooled_width],
                "pooled_height": pooled_height,
                "pooled_width": pooled_width,
                "part_size": part_size or [pooled_height, pooled_width],
                "sample_per_part": sample_per_part,
                "trans_std": trans_std})


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.5, evaluate_difficult=True,
                  ap_version="integral", has_state=True,
                  return_states=False, name=None):
    """Streaming mAP metric (reference: layers/metric_op.py via
    DetectionMAP, detection_map_op.cc). detect_res [n, D, 6],
    label [n, G, 6]. has_state=True accumulates in persistable bucketized
    TP/FP state vars across steps; has_state=False computes the
    current-batch mAP only. Returns the scalar mAP var, or
    (map, [state vars]) with return_states=True."""
    helper = LayerHelper("detection_map", name=name)
    C = int(class_num)
    m = helper.create_variable_for_type_inference("float32", True)
    ins = {"DetectRes": [detect_res.name], "Label": [label.name]}
    if has_state:
        pos = helper.create_global_state_var("dmap_pos_count", [C],
                                             "int32")
        tp = helper.create_global_state_var("dmap_true_pos", [C, 1000],
                                            "int32")
        fp = helper.create_global_state_var("dmap_false_pos", [C, 1000],
                                            "int32")
        ins.update({"PosCount": [pos.name], "TruePos": [tp.name],
                    "FalsePos": [fp.name]})
    else:  # fresh zero state: out vars only, never read back
        pos = helper.create_variable_for_type_inference("int32", True)
        tp = helper.create_variable_for_type_inference("int32", True)
        fp = helper.create_variable_for_type_inference("int32", True)
    helper.append_op(
        "detection_map", ins,
        {"MAP": [m.name], "AccumPosCount": [pos.name],
         "AccumTruePos": [tp.name], "AccumFalsePos": [fp.name]},
        {"class_num": C, "background_label": background_label,
         "overlap_threshold": overlap_threshold,
         "evaluate_difficult": evaluate_difficult,
         "ap_type": ap_version}, infer_shape=False)
    if return_states:
        return m, [pos, tp, fp]
    return m


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=None,
                           pooled_height=1, pooled_width=1, part_size=None,
                           sample_per_part=1, trans_std=0.1,
                           position_sensitive=False, name=None):
    """reference: layers/nn.py deformable_roi_pooling — same kernel as
    deformable_psroi_pooling; output_dim derives from the input channels
    and the pooled grid."""
    c = int(input.shape[1])
    if position_sensitive:
        output_dim = c // (pooled_height * pooled_width)
    else:
        output_dim = c
    out = deformable_psroi_pooling(
        input, rois, trans, no_trans=no_trans, spatial_scale=spatial_scale,
        output_dim=output_dim, group_size=group_size,
        pooled_height=pooled_height, pooled_width=pooled_width,
        part_size=part_size, sample_per_part=sample_per_part,
        trans_std=trans_std, name=name)
    return out[0] if isinstance(out, list) else out


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd, im_info,
                            num_classes=1, positive_overlap=0.5,
                            negative_overlap=0.4):
    """reference: layers/detection.py retinanet_target_assign. Dense
    per-anchor outputs; -1 labels mark ignored anchors (see the op)."""
    ins = {"BBoxPred": [bbox_pred.name], "ClsLogits": [cls_logits.name],
           "Anchor": [anchor_box.name], "GtBoxes": [gt_boxes.name],
           "GtLabels": [gt_labels.name], "ImInfo": [im_info.name]}
    if is_crowd is not None:
        ins["IsCrowd"] = [is_crowd.name]
    return _op("retinanet_target_assign", "retinanet_target_assign", ins,
               ["PredScores", "PredBBox", "TargetLabel", "TargetBBox",
                "BBoxInsideWeight", "ForegroundNumber"],
               {"positive_overlap": positive_overlap,
                "negative_overlap": negative_overlap,
                "num_classes": num_classes})


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """reference: layers/detection.py multi_box_head — the SSD prediction
    head: per feature map a 3x3 (kernel_size) conv yields loc [n, P, 4]
    and conf [n, P, C] predictions, prior_box yields the anchors; all maps
    concatenate. Returns (mbox_locs, mbox_confs, boxes, variances)."""
    from . import nn as nn_layers
    from . import tensor as t_layers

    n_layer = len(inputs)
    if min_sizes is None:
        # reference ratio schedule: evenly spaced between min/max ratio
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n_layer - 2))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes
        max_sizes = [base_size * 0.20] + max_sizes

    locs, confs, boxes_l, vars_l = [], [], [], []
    for i, feat in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i]
        if steps:
            step_i = steps[i]
            if not isinstance(step_i, (list, tuple)):
                step_i = [step_i, step_i]  # fluid's scalar-per-layer form
        else:
            step_i = [step_w[i] if step_w else 0.0,
                      step_h[i] if step_h else 0.0]
        box, var = prior_box(
            feat, image,
            mins if isinstance(mins, (list, tuple)) else [mins],
            None if maxs is None else (
                maxs if isinstance(maxs, (list, tuple)) else [maxs]),
            ar if isinstance(ar, (list, tuple)) else [ar],
            list(variance), flip, clip, step_i, offset)
        num_priors = int(box.shape[2]) if len(box.shape) >= 3 else \
            int(box.shape[0] // (feat.shape[2] * feat.shape[3]))

        loc = nn_layers.conv2d(feat, num_priors * 4, kernel_size,
                               padding=pad, stride=stride)
        # [n, P*4, h, w] -> [n, h, w, P*4] -> [n, h*w*P, 4]
        loc = t_layers.transpose(loc, [0, 2, 3, 1])
        loc = t_layers.reshape(loc, [0, -1, 4])
        conf = nn_layers.conv2d(feat, num_priors * num_classes,
                                kernel_size, padding=pad, stride=stride)
        conf = t_layers.transpose(conf, [0, 2, 3, 1])
        conf = t_layers.reshape(conf, [0, -1, num_classes])
        locs.append(loc)
        confs.append(conf)
        boxes_l.append(t_layers.reshape(box, [-1, 4]))
        vars_l.append(t_layers.reshape(var, [-1, 4]))

    mbox_locs = t_layers.concat(locs, axis=1)
    mbox_confs = t_layers.concat(confs, axis=1)
    boxes = t_layers.concat(boxes_l, axis=0)
    variances = t_layers.concat(vars_l, axis=0)
    return mbox_locs, mbox_confs, boxes, variances
