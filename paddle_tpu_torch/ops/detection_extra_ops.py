"""Detection tail: R-CNN label generation, perspective RoI transform,
deformable PS-RoI pooling, var_conv_2d, and the streaming detection_map
metric (reference: detection/generate_proposal_labels_op.cc,
generate_mask_labels_op.cc, roi_perspective_transform_op.cc,
deformable_psroi_pooling_op.cc, var_conv_2d_op.cc, detection_map_op.cc).

Port of `paddle_tpu/ops/detection_extra_ops.py`, with its fixed-size
redesigns: variable-length LoD outputs become padded dense tensors with
validity masks; the detection_map accumulator state is bucketized by
score (the auc-op state model) instead of unbounded LoD score lists. The
sorts, clips and loops follow `detection_ops.py`'s rules.
"""

import math

import torch
import torch.nn.functional as F

from ..framework.registry import register_op
from .detection_ops import _argsort, _inverse_perm, _iou_matrix, _rows


# ---------------------------------------------------------------------------
# generate_proposal_labels (Fast R-CNN sampling)
# ---------------------------------------------------------------------------

@register_op("generate_proposal_labels", not_differentiable=True,
             grad_free=True, stateful=True)
def _generate_proposal_labels(ctx, ins, attrs):
    """reference: detection/generate_proposal_labels_op.cc — sample
    batch_size_per_im RoIs per image into fg (IoU>=fg_thresh, gt class
    label) and bg (bg_thresh_lo<=IoU<bg_thresh_hi, label 0), emit
    per-class box regression targets. Fixed-size: RpnRois [n, R, 4] dense
    in, all outputs [n, B, ...] with B = batch_size_per_im; unsampled
    slots have label -1 and zero weights. With use_random the sampling
    priorities are uniform draws of the run's generator."""
    rois = ins["RpnRois"][0]                     # [n, R, 4]
    gt_classes = ins["GtClasses"][0]             # [n, G]
    gt_boxes = ins["GtBoxes"][0]                 # [n, G, 4]
    is_crowd = ins.get("IsCrowd", [None])[0]     # [n, G]
    B = int(attrs.get("batch_size_per_im", 256))
    fg_frac = attrs.get("fg_fraction", 0.25)
    fg_thresh = attrs.get("fg_thresh", 0.5)
    bg_hi = attrs.get("bg_thresh_hi", 0.5)
    bg_lo = attrs.get("bg_thresh_lo", 0.0)
    weights = attrs.get("bbox_reg_weights", [0.1, 0.1, 0.2, 0.2])
    C = int(attrs.get("class_nums", 81))
    use_random = bool(attrs.get("use_random", True))
    cls_agnostic = bool(attrs.get("is_cls_agnostic", False))
    cascade = bool(attrs.get("is_cascade_rcnn", False))
    n = rois.shape[0]
    dev = rois.device

    gt_valid = (gt_boxes[..., 2] > gt_boxes[..., 0]) & \
        (gt_boxes[..., 3] > gt_boxes[..., 1])
    if is_crowd is not None:
        gt_valid = gt_valid & (is_crowd == 0)
    if not cascade:
        # gt boxes join the roi candidate pool (reference AppendRois): gt
        # slots appended after the R rpn rois
        rois = torch.cat([rois, torch.where(gt_valid[..., None], gt_boxes,
                                            0.0)], dim=1)
    roi_valid = (rois[..., 2] > rois[..., 0]) & (rois[..., 3] > rois[..., 1])
    iou = _iou_matrix(rois, gt_boxes)                 # [n, R', G]
    iou = torch.where(gt_valid[:, None, :], iou, 0.0)
    iou = torch.where(roi_valid[:, :, None], iou, 0.0)
    max_ov = iou.amax(dim=2)
    argmax_gt = torch.argmax(iou, dim=2)

    fg_mask = roi_valid & (max_ov >= fg_thresh)
    bg_mask = roi_valid & (max_ov < bg_hi) & (max_ov >= bg_lo)
    rr = rois.shape[1]
    fg_target = int(B * fg_frac)
    if use_random:
        pri = torch.rand((n, rr), generator=ctx.rng(), device=dev)
    else:
        pri = -torch.arange(rr, dtype=torch.float32, device=dev).expand(n, rr)
    fg_rank = _inverse_perm(_argsort(-torch.where(fg_mask, pri, -math.inf)))
    fg_keep = fg_mask & (fg_rank < fg_target)
    n_fg = torch.clamp(fg_mask.sum(dim=1), max=fg_target)
    bg_target = B - n_fg
    bg_rank = _inverse_perm(_argsort(-torch.where(bg_mask, pri, -math.inf)))
    bg_keep = bg_mask & (bg_rank < bg_target[:, None])

    # gather sampled rois to the front: fg first then bg (reference
    # concatenates fg_inds + bg_inds), pad to B
    order_key = torch.where(
        fg_keep, fg_rank.float(),
        torch.where(bg_keep, (fg_target + bg_rank).float(), math.inf))
    sel = _argsort(order_key)[:, :B]
    picked = _rows(order_key, sel) != math.inf
    sel_rois = torch.where(picked[..., None], _rows(rois, sel), 0.0)
    sel_fg = _rows(fg_keep, sel)
    sel_gt = _rows(argmax_gt, sel)
    labels = torch.where(sel_fg, _rows(gt_classes, sel_gt).to(torch.int32),
                         torch.where(picked, 0, -1)).to(torch.int32)
    if cls_agnostic:
        labels = torch.where(sel_fg, 1, labels).to(torch.int32)

    # encoded regression targets vs matched gt
    mgt = _rows(gt_boxes, sel_gt)
    bw = sel_rois[..., 2] - sel_rois[..., 0] + 1
    bh = sel_rois[..., 3] - sel_rois[..., 1] + 1
    bx = sel_rois[..., 0] + bw / 2
    by = sel_rois[..., 1] + bh / 2
    gw = mgt[..., 2] - mgt[..., 0] + 1
    gh = mgt[..., 3] - mgt[..., 1] + 1
    gx = mgt[..., 0] + gw / 2
    gy = mgt[..., 1] + gh / 2
    bw_, bh_ = torch.clamp(bw, min=1e-6), torch.clamp(bh, min=1e-6)
    tgt = torch.stack(
        [(gx - bx) / bw_ / weights[0], (gy - by) / bh_ / weights[1],
         torch.log(torch.clamp(gw, min=1e-6) / bw_) / weights[2],
         torch.log(torch.clamp(gh, min=1e-6) / bh_) / weights[3]], dim=-1)
    tgt = torch.where(sel_fg[..., None], tgt, 0.0)
    # per-class slots [B, 4C]: targets land in the label's slot
    cls_slot = torch.ones_like(labels) if cls_agnostic else labels
    onehot = F.one_hot(torch.clamp(cls_slot, 0, C - 1).long(), C) \
        .to(tgt.dtype) * sel_fg[..., None]
    bbox_targets = (onehot[..., None] * tgt[..., None, :]).reshape(n, B, 4 * C)
    inside_w = (onehot[..., None] * torch.ones(
        (1, 1, 1, 4), dtype=tgt.dtype, device=dev)).reshape(n, B, 4 * C)
    return {"Rois": [sel_rois], "LabelsInt32": [labels],
            "BboxTargets": [bbox_targets], "BboxInsideWeights": [inside_w],
            "BboxOutsideWeights": [inside_w],
            # extra (beyond-reference) outputs consumed by
            # generate_mask_labels' dense redesign
            "MatchedGtInt32": [sel_gt.to(torch.int32)], "FgMask": [sel_fg]}


# ---------------------------------------------------------------------------
# generate_mask_labels (Mask R-CNN)
# ---------------------------------------------------------------------------

@register_op("generate_mask_labels", not_differentiable=True, grad_free=True)
def _generate_mask_labels(ctx, ins, attrs):
    """reference: detection/generate_mask_labels_op.cc. Dense redesign:
    GtSegms arrives RASTERIZED as [n, G, Hm, Wm] binary masks in
    normalized image coordinates (the reference takes 3-level-LoD polygon
    lists and rasterizes in C++; polygon->mask belongs in the host data
    pipeline). For each sampled fg RoI the matched gt mask is cropped to
    the RoI box, resampled to resolution^2, thresholded, and written into
    the label's class slot of MaskInt32 [n, B, C*res*res]; non-fg rows
    are -1 (ignored by the mask loss, as in the reference)."""
    im_info = ins["ImInfo"][0]                   # [n, 3]
    gt_segms = ins["GtSegms"][0]                 # [n, G, Hm, Wm] in [0,1]
    rois = ins["Rois"][0]                        # [n, B, 4] image coords
    labels = ins["LabelsInt32"][0]               # [n, B]
    matched = ins["MatchedGtInt32"][0] if "MatchedGtInt32" in ins else None
    C = int(attrs["num_classes"])
    res = int(attrs["resolution"])
    n, B = labels.shape
    hm, wm = gt_segms.shape[2], gt_segms.shape[3]
    dev = rois.device
    if matched is None:
        matched = torch.zeros((n, B), dtype=torch.int32, device=dev)

    im_h = im_info[:, 0][:, None, None]
    im_w = im_info[:, 1][:, None, None]
    x0, y0 = rois[..., 0, None], rois[..., 1, None]       # [n, B, 1]
    x1, y1 = rois[..., 2, None], rois[..., 3, None]
    # sample res x res points inside the roi, read the gt mask at the
    # matching normalized position (bilinear)
    grid = torch.arange(res, device=dev) + 0.5
    xs = (x0 + (x1 - x0) * grid / res) / torch.clamp(im_w, min=1.0) * \
        (wm - 1)                                          # [n, B, res]
    ys = (y0 + (y1 - y0) * grid / res) / torch.clamp(im_h, min=1.0) * \
        (hm - 1)
    gx = xs[:, :, None, :].expand(n, B, res, res)
    gy = ys[:, :, :, None].expand(n, B, res, res)
    x0i = torch.clamp(torch.floor(gx).to(torch.int32), 0, wm - 1)
    y0i = torch.clamp(torch.floor(gy).to(torch.int32), 0, hm - 1)
    x1i = torch.clamp(x0i + 1, 0, wm - 1)
    y1i = torch.clamp(y0i + 1, 0, hm - 1)
    fx = gx - x0i
    fy = gy - y0i
    img = torch.arange(n, device=dev)[:, None, None, None]
    gt = matched.long()[:, :, None, None]

    def at(yi, xi):
        return gt_segms[img, gt, yi.long(), xi.long()]

    v = (at(y0i, x0i) * (1 - fx) * (1 - fy) + at(y0i, x1i) * fx * (1 - fy)
         + at(y1i, x0i) * (1 - fx) * fy + at(y1i, x1i) * fx * fy)
    bin_mask = (v >= 0.5).to(torch.int32).reshape(n, B, 1, res * res)
    slot = torch.clamp(labels, 0, C - 1).long()
    in_slot = (torch.arange(C, device=dev) == slot[..., None])[..., None]
    full = torch.where(in_slot, bin_mask, 0).reshape(n, B, C * res * res)
    is_fg = labels > 0
    masks = torch.where(is_fg[..., None], full, -1).to(torch.int32)
    return {"MaskRois": [rois], "RoiHasMaskInt32": [is_fg.to(torch.int32)],
            "MaskInt32": [masks]}


# ---------------------------------------------------------------------------
# roi_perspective_transform
# ---------------------------------------------------------------------------

def _quad_homography(quad, h_out, w_out):
    """Homographies [..., 9] mapping the output rect (w_out, h_out)
    corners to each quad's 4 points (x1..x4, y1..y4 order: lt, rt, rb, lb
    — reference roi_perspective_transform_op.cc get_transform_matrix)."""
    x = quad[..., 0::2]
    y = quad[..., 1::2]                                   # [..., 4]
    sx = torch.tensor([0.0, w_out - 1.0, w_out - 1.0, 0.0],
                      dtype=quad.dtype, device=quad.device)
    sy = torch.tensor([0.0, 0.0, h_out - 1.0, h_out - 1.0],
                      dtype=quad.dtype, device=quad.device)
    sx, sy = sx.expand(x.shape), sy.expand(x.shape)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    r1 = torch.stack([sx, sy, one, zero, zero, zero, -x * sx, -x * sy], -1)
    r2 = torch.stack([zero, zero, zero, sx, sy, one, -y * sx, -y * sy], -1)
    A = torch.stack([r1, r2], dim=-2).reshape(*x.shape[:-1], 8, 8)
    b = torch.stack([x, y], dim=-1).reshape(*x.shape[:-1], 8)
    eye = torch.eye(8, dtype=A.dtype, device=A.device)
    sol = torch.linalg.solve(A + 1e-8 * eye, b)
    return torch.cat([sol, torch.ones_like(sol[..., :1])], dim=-1)


@register_op("roi_perspective_transform",
             no_grad_inputs={"ROIs", "RoisNum"},
             non_diff_outputs={"Mask", "TransformMatrix", "Out2InIdx",
                               "Out2InWeights"})
def _roi_perspective_transform(ctx, ins, attrs):
    """reference: detection/roi_perspective_transform_op.cc — warp each
    quadrilateral RoI to a fixed rectangle by perspective transform +
    bilinear sampling (OCR text rectification). Dense: ROIs [n, R, 8]
    quads per image; Out [n, R, c, H', W']. Differentiable w.r.t. X by
    the generic vjp (the reference hand-caches Out2InIdx/Out2InWeights
    for its grad kernel; those outputs are zeros, for slot parity)."""
    x = ins["X"][0]                              # [n, c, h, w]
    rois = ins["ROIs"][0]                        # [n, R, 8]
    scale = attrs.get("spatial_scale", 1.0)
    th = int(attrs["transformed_height"])
    tw = int(attrs["transformed_width"])
    n, c, h, w = x.shape
    R = rois.shape[1]
    dev = x.device

    T = _quad_homography(rois * scale, th, tw)    # [n, R, 9]
    gy = torch.arange(th, dtype=x.dtype, device=dev)[:, None]
    gx = torch.arange(tw, dtype=x.dtype, device=dev)[None, :]
    t = [T[..., i, None, None] for i in range(9)]
    denom = t[6] * gx + t[7] * gy + t[8]
    sx = (t[0] * gx + t[1] * gy + t[2]) / denom        # [n, R, th, tw]
    sy = (t[3] * gx + t[4] * gy + t[5]) / denom
    in_bound = (sx >= -0.5) & (sx <= w - 0.5) & (sy >= -0.5) & \
        (sy <= h - 0.5)
    x0 = torch.clamp(torch.floor(sx).to(torch.int32), 0, w - 1)
    y0 = torch.clamp(torch.floor(sy).to(torch.int32), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = (torch.clamp(sx, 0, w - 1.0) - x0)[:, :, None]
    fy = (torch.clamp(sy, 0, h - 1.0) - y0)[:, :, None]
    img = torch.arange(n, device=dev)[:, None, None, None]

    def at(yi, xi):                                     # [n, R, c, th, tw]
        return x[img, :, yi.long(), xi.long()].permute(0, 1, 4, 2, 3)

    v = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x1) * fx * (1 - fy)
         + at(y1, x0) * (1 - fx) * fy + at(y1, x1) * fx * fy)
    v = torch.where(in_bound[:, :, None], v, 0.0)
    return {"Out": [v], "Mask": [in_bound.to(torch.int32)[:, :, None]],
            "TransformMatrix": [T],
            "Out2InIdx": [torch.zeros((n, R, th * tw, 4), dtype=torch.int32,
                                      device=dev)],
            "Out2InWeights": [torch.zeros((n, R, th * tw, 4),
                                          dtype=x.dtype, device=dev)]}


# ---------------------------------------------------------------------------
# deformable_psroi_pooling
# ---------------------------------------------------------------------------

@register_op("deformable_psroi_pooling",
             no_grad_inputs={"ROIs", "RoisNum"},
             non_diff_outputs={"TopCount"})
def _deformable_psroi_pooling(ctx, ins, attrs):
    """reference: deformable_psroi_pooling_op.cc (R-FCN / Deformable
    ConvNets). Input [n, C, H, W] with C = output_dim*ph*pw position-
    sensitive score maps; ROIs dense [n, R, 4]; Trans [n*R or R, 2, ph,
    pw] learned offsets (ignored when no_trans). Output [n, R,
    output_dim, ph, pw]; TopCount = bilinear sample counts. Every bin's
    sample_per_part^2 samples of every roi are one gather a corner."""
    x = ins["Input"][0]
    rois = ins["ROIs"][0]
    trans = ins.get("Trans", [None])[0]
    no_trans = bool(attrs.get("no_trans", trans is None))
    scale = attrs.get("spatial_scale", 1.0)
    out_dim = int(attrs["output_dim"])
    ph = int(attrs["pooled_height"])
    pw = int(attrs["pooled_width"])
    spp = int(attrs.get("sample_per_part", 4))
    trans_std = attrs.get("trans_std", 0.1)
    gs = attrs.get("group_size")
    if isinstance(gs, (list, tuple)):
        group_h, group_w = int(gs[0]), int(gs[1])
    else:
        group_h, group_w = ph, pw
    part = attrs.get("part_size")
    part_h, part_w = (int(part[0]), int(part[1])) \
        if isinstance(part, (list, tuple)) else (ph, pw)
    n, C, H, W = x.shape
    R = rois.shape[1]
    dev = x.device

    # roi in image coords -> feature coords (reference rounds + 0.5
    # shifts); [n, R, 1, 1, 1, 1]
    def roi_col(v):
        return v[:, :, None, None, None, None]

    rx0 = roi_col(rois[..., 0] * scale - 0.5)
    ry0 = roi_col(rois[..., 1] * scale - 0.5)
    rx1 = roi_col((rois[..., 2] + 1.0) * scale - 0.5)
    ry1 = roi_col((rois[..., 3] + 1.0) * scale - 0.5)
    rw = torch.clamp(rx1 - rx0, min=0.1)
    rh = torch.clamp(ry1 - ry0, min=0.1)
    bin_w = rw / pw
    bin_h = rh / ph
    sub_w = bin_w / spp
    sub_h = bin_h / spp

    # bins [od, ph, pw] on dims 2-4, samples on dim 5 (y) / 6 (x)
    iy = torch.arange(ph, device=dev)[None, :, None]
    ix = torch.arange(pw, device=dev)[None, None, :]
    od = torch.arange(out_dim, device=dev)[:, None, None]
    if no_trans:
        dx = dy = torch.zeros((), dtype=x.dtype, device=dev)
    else:
        # learned offsets, shared across output_dim channels
        tr = trans.reshape(n, R, 2, part_h, part_w)
        py = (torch.arange(ph, device=dev) * part_h // ph)[:, None]
        px = (torch.arange(pw, device=dev) * part_w // pw)[None, :]
        dx = (tr[:, :, 0][:, :, py, px] * trans_std)[:, :, None] * rw[..., 0]
        dy = (tr[:, :, 1][:, :, py, px] * trans_std)[:, :, None] * rh[..., 0]
    # position-sensitive channel for (od, iy, ix)
    chan = (od * group_h + iy * group_h // ph) * group_w + ix * group_w // pw
    samp = torch.arange(spp, dtype=x.dtype, device=dev) + 0.5
    sy = (ry0[..., 0] + iy * bin_h[..., 0] + dy)[..., None, None] + \
        (samp * sub_h)[..., :, None]                     # [n,R,od,ph,pw,s,1]
    sx = (rx0[..., 0] + ix * bin_w[..., 0] + dx)[..., None, None] + \
        (samp * sub_w)[..., None, :]                     # [n,R,od,ph,pw,1,s]
    yy, xx = torch.broadcast_tensors(sy, sx)
    shape = (n, R, out_dim, ph, pw, spp, spp)
    yy, xx = yy.expand(shape), xx.expand(shape)
    valid = (xx >= -0.5) & (xx <= W - 0.5) & (yy >= -0.5) & (yy <= H - 0.5)
    xc = torch.clamp(xx, 0, W - 1.001)
    yc = torch.clamp(yy, 0, H - 1.001)
    x0 = torch.floor(xc).to(torch.int32)
    y0 = torch.floor(yc).to(torch.int32)
    fx = xc - x0
    fy = yc - y0
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    img = torch.arange(n, device=dev)[:, None, None, None, None, None, None]
    ch = chan[None, None, :, :, :, None, None]

    def at(yi, xi):
        return x[img, ch, yi.long(), xi.long()]

    v = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x1) * fx * (1 - fy)
         + at(y1, x0) * (1 - fx) * fy + at(y1, x1) * fx * fy)
    v = torch.where(valid, v, 0.0)
    cnt = valid.sum(dim=(5, 6))
    total = v.sum(dim=(5, 6))
    out = torch.where(cnt > 0, total / cnt, 0.0)
    return {"Output": [out], "TopCount": [cnt.to(x.dtype)]}


# ---------------------------------------------------------------------------
# var_conv_2d
# ---------------------------------------------------------------------------

def _valid_mask(h_valid, w_valid, hh, ww):
    """[b, hh, ww]: rows below ceil(h_valid) and columns below
    ceil(w_valid) of each sample."""
    my = torch.arange(hh, device=h_valid.device)[None, :, None] < \
        torch.ceil(h_valid)[:, None, None]
    mx = torch.arange(ww, device=w_valid.device)[None, None, :] < \
        torch.ceil(w_valid)[:, None, None]
    return my & mx


@register_op("var_conv_2d", no_grad_inputs={"ROW", "COLUMN"},
             non_diff_outputs={"Col"})
def _var_conv_2d(ctx, ins, attrs):
    """reference: var_conv_2d_op.cc — conv over per-sample variable-size
    feature maps (match-pyramid text models; per-sample h/w ride in
    ROW/COLUMN LoD). Dense redesign: X [b, c_in, H, W] padded, ROW [b]
    valid heights, COLUMN [b] valid widths; invalid region is zeroed
    before AND after the conv so results equal the reference's per-sample
    crops. W [c_out, c_in*kh*kw]."""
    x = ins["X"][0]
    w = ins["W"][0]
    rows = ins["ROW"][0].reshape(-1).float() if "ROW" in ins else None
    cols = ins["COLUMN"][0].reshape(-1).float() if "COLUMN" in ins else None
    cin = int(attrs["InputChannel"])
    cout = int(attrs["OutputChannel"])
    kh, kw = int(attrs["KernelH"]), int(attrs["KernelW"])
    sh, sw = int(attrs.get("StrideH", 1)), int(attrs.get("StrideW", 1))
    b, _, H, W_ = x.shape
    masked = rows is not None and cols is not None
    if masked:
        x = x * _valid_mask(rows, cols, H, W_)[:, None].to(x.dtype)
    filt = w.reshape(cout, cin, kh, kw)
    out = F.conv2d(x, filt, stride=(sh, sw), padding=(kh // 2, kw // 2))
    oh, ow = out.shape[2], out.shape[3]
    if masked:
        om = _valid_mask(torch.ceil(rows / sh), torch.ceil(cols / sw), oh, ow)
        out = out * om[:, None].to(out.dtype)
    col = F.unfold(x, (kh, kw), padding=(kh // 2, kw // 2), stride=(sh, sw))
    return {"Out": [out], "Col": [col.reshape(b, -1, oh, ow)]}


# ---------------------------------------------------------------------------
# detection_map (SSD eval metric)
# ---------------------------------------------------------------------------

_MAP_BUCKETS = 1000


@register_op("detection_map", not_differentiable=True, grad_free=True,
             is_optimizer_op=True)
def _detection_map(ctx, ins, attrs):
    """reference: detection_map_op.cc — streaming mean average precision.

    Dense redesign of the accumulator: the reference keeps unbounded LoD
    lists of (score, tp) pairs per class; the state here is static, so
    TP/FP events are bucketized by score into K=1000 buckets per class
    (the auc-op state model) — AP error from bucketing is < 1e-3 at
    K=1000. A score's bucket is int32((score * (K-1)) in float32), JAX's
    truncation.

    DetectRes [n, D, 6] (label, score, x0, y0, x1, y1; score<=0 rows are
    padding), Label [n, G, 6] (label, x0, y0, x1, y1, difficult).
    State: PosCount [C], TruePos [C, K], FalsePos [C, K] (int32).
    Outputs the same three accumulators + scalar MAP. The greedy match
    walks every image's detections in score order at once, one Python
    step a detection rank (JAX's scan)."""
    det = ins["DetectRes"][0]
    gt = ins["Label"][0]
    C = int(attrs["class_num"])
    K = _MAP_BUCKETS
    overlap_t = attrs.get("overlap_threshold", 0.5)
    eval_difficult = bool(attrs.get("evaluate_difficult", True))
    ap_type = attrs.get("ap_type", "integral")
    bg = int(attrs.get("background_label", 0))  # -1 = no background class
    has_state = ins.get("HasState", [None])[0]
    pos_count = ins.get("PosCount", [None])[0]
    true_pos = ins.get("TruePos", [None])[0]
    false_pos = ins.get("FalsePos", [None])[0]
    dev = det.device
    if pos_count is None:  # stateless single-batch use: int32 is ample
        pos_count = torch.zeros((C,), dtype=torch.int32, device=dev)
        true_pos = torch.zeros((C, K), dtype=torch.int32, device=dev)
        false_pos = torch.zeros((C, K), dtype=torch.int32, device=dev)
    if has_state is not None:
        live = has_state.reshape(-1)[0] != 0
        pos_count = torch.where(live, pos_count, 0)
        true_pos = torch.where(live, true_pos, 0)
        false_pos = torch.where(live, false_pos, 0)
    n, D = det.shape[0], det.shape[1]
    G = gt.shape[1]

    det_label = det[:, :, 0].to(torch.int32)
    det_score = det[:, :, 1]
    det_box = det[:, :, 2:6]
    det_valid = det_score > 0
    if bg >= 0:  # reference excludes the background class entirely
        det_valid = det_valid & (det_label != bg)
    gt_label = gt[:, :, 0].to(torch.int32)
    gt_box = gt[:, :, 1:5]
    gt_difficult = (gt[:, :, 5] != 0) if gt.shape[2] > 5 else \
        torch.zeros((n, G), dtype=torch.bool, device=dev)
    gt_valid = (gt_box[:, :, 2] > gt_box[:, :, 0]) & \
        (gt_box[:, :, 3] > gt_box[:, :, 1])
    if bg >= 0:
        gt_valid = gt_valid & (gt_label != bg)
    # positives per class (difficult gt excluded unless evaluate_difficult)
    counted = gt_valid & (eval_difficult | ~gt_difficult)
    per_class = torch.arange(C, device=dev) == \
        torch.clamp(gt_label, 0, C - 1)[..., None]           # [n, G, C]
    pos_count = pos_count + (per_class & counted[..., None]).sum(
        dim=(0, 1)).to(pos_count.dtype)

    iou = _iou_matrix(det_box, gt_box, normalized=True)      # [n, D, G]
    same_cls = (det_label[:, :, None] == gt_label[:, None, :]) & \
        gt_valid[:, None, :]
    iou = torch.where(same_cls, iou, 0.0)
    # greedy match in score order, every image at once
    order = _argsort(-det_score, dim=1)
    ar = torch.arange(n, device=dev)
    gcols = torch.arange(G, device=dev)[None, :]
    taken = torch.zeros((n, G), dtype=torch.bool, device=dev)
    tps, fps = [], []
    for t in range(0 if det.is_meta else D):
        di = order[:, t]
        ious = torch.where(taken, 0.0, iou[ar, di])
        best = torch.argmax(ious, dim=1)
        ok = (ious[ar, best] >= overlap_t) & det_valid[ar, di]
        diff = gt_difficult[ar, best]
        taken = taken | ((gcols == best[:, None]) & ok[:, None])
        # tp if matched non-difficult (or eval_difficult); fp if
        # unmatched; difficult matches are ignored entirely
        tps.append(ok & (eval_difficult | ~diff))
        fp = (~ok) & det_valid[ar, di]
        if not eval_difficult:
            fp = fp & ~(diff & ok)
        fps.append(fp)
    if tps:
        tp_s, fp_s = torch.stack(tps, 1), torch.stack(fps, 1)  # score order
        inv = _inverse_perm(order)
        tp_f, fp_f = torch.gather(tp_s, 1, inv), torch.gather(fp_s, 1, inv)
    else:
        tp_f = fp_f = torch.zeros((n, D), dtype=torch.bool, device=dev)
    bins = torch.clamp((det_score * (K - 1)).to(torch.int32), 0, K - 1)
    cls = torch.clamp(det_label, 0, C - 1)
    flat = (cls.long() * K + bins.long()).reshape(-1)
    tp_h = torch.zeros(C * K, dtype=true_pos.dtype, device=dev).index_add_(
        0, flat, tp_f.reshape(-1).to(true_pos.dtype))
    fp_h = torch.zeros(C * K, dtype=false_pos.dtype, device=dev).index_add_(
        0, flat, fp_f.reshape(-1).to(false_pos.dtype))
    true_pos = true_pos + tp_h.reshape(C, K)
    false_pos = false_pos + fp_h.reshape(C, K)

    # AP per class from the bucketized curve, descending score
    tp_rev = torch.cumsum(true_pos.flip(1), dim=1).to(torch.float32)
    fp_rev = torch.cumsum(false_pos.flip(1), dim=1).to(torch.float32)
    npos = torch.clamp(pos_count.to(torch.float32), min=1e-6)
    recall = tp_rev / npos[:, None]
    precision = tp_rev / torch.clamp(tp_rev + fp_rev, min=1e-6)
    has_events = (true_pos.sum(1) + false_pos.sum(1)) > 0
    if ap_type == "11point":
        # jnp.linspace(0, 1, 11)'s float32 points: i / 10 for i < 10, 1
        pts = torch.cat([torch.arange(10, dtype=torch.float32, device=dev)
                         / 10, torch.ones(1, device=dev)])
        # max precision at recall >= r for each of the 11 points
        pmax = torch.where(recall[:, None, :] >= pts[None, :, None],
                           precision[:, None, :], 0.0).amax(dim=2)  # [C, 11]
        ap = pmax.mean(dim=1)
    else:
        # integral: sum precision * delta_recall over buckets
        d_tp = torch.diff(tp_rev, dim=1, prepend=torch.zeros_like(
            tp_rev[:, :1]))
        ap = torch.sum(precision * d_tp, dim=1) / npos
    eligible = (pos_count > 0) & has_events
    if bg >= 0:
        eligible = eligible & (torch.arange(C, device=dev) != bg)
    n_elig = eligible.sum()
    m_ap = torch.where(n_elig > 0,
                       torch.sum(torch.where(eligible, ap, 0.0))
                       / torch.clamp(n_elig, min=1), 0.0)
    return {"MAP": [m_ap.to(torch.float32)],
            "AccumPosCount": [pos_count], "AccumTruePos": [true_pos],
            "AccumFalsePos": [false_pos]}
