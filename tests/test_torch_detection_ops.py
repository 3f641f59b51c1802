"""The detection ops (`ops/detection_ops.py`, `ops/detection_extra_ops.py`)
of the PyTorch port against the JAX package's rules, on the CPU.

Each case calls the two packages' lowering rules directly on the same
seeded numpy inputs (`test_torch_core_ops.py`'s harness): JAX's cases of
a family in one jitted function with `jax.vjp`, the port's rule on CPU
tensors, on meta tensors (build-time shape inference) and under
`torch.func.vjp`. Floats within op_test's 1e-5, ints exactly, and every
input gradient of a differentiable rule within op_test's 5e-3 (max
relative error). JAX without x64 gives int32 where the port declares
int64 (ROADMAP §C).

The inputs are fed on purpose where the port could part from JAX:
  * ties among scores and losses (JAX's top_k puts the lower index first,
    its argsort is stable): equal scores in the NMS and proposal rules,
    bulk-equal masked losses in mine_hard_examples, equal IoUs in
    bipartite_match, equal maxima in roi_pool (its Argmax and its
    gradient, which both packages split evenly among tied maxima);
  * unmatched -1 rows (JAX clips them before it gathers and drops their
    scatters; torch's -1 would read or write the last row): target_assign
    and its NegIndices padding, detection_map's padding detections;
  * padding rows: zero gt boxes, zero-score proposals, RoisNum that
    leaves rows to the last image;
  * the two sampling rules with use_random=False (JAX's and torch's
    random streams differ, ROADMAP §C); with use_random=True they are
    held on their invariants: the fg and bg counts, membership in the
    candidate sets, equal draws for equal seeds.
"""

import numpy as np
import pytest
import torch

import test_torch_core_ops as core
from paddle_tpu.framework import registry as jreg
from paddle_tpu_torch.framework import registry as treg
from test_torch_core_ops import (_case, _check, _family, _jax_family,
                                 _slots, _torch_run)
from torch_port_common import one_torch_thread  # noqa: F401

_R = np.random.RandomState(21)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


def _u(lo, hi, *shape):
    return _R.uniform(lo, hi, shape).astype(np.float32)


def _boxes(n, lo, hi, size_lo, size_hi):
    """[n, 4] boxes (x1, y1, x2, y2) with corners in [lo, hi)."""
    xy = _u(lo, hi, n, 2)
    wh = _u(size_lo, size_hi, n, 2)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ---------------------------------------------------------------------------
# priors, anchors, coders and the geometry rules
# ---------------------------------------------------------------------------

_FEAT = np.zeros((1, 8, 4, 4), np.float32)
_IMG = np.zeros((1, 3, 32, 32), np.float32)
_PRIOR = _boxes(6, 0.0, 0.6, 0.1, 0.4)
_PVAR = np.tile(np.array([[0.1, 0.1, 0.2, 0.2]], np.float32), (6, 1))
_DUP = _boxes(5, 0.0, 0.6, 0.1, 0.4)
_DUP[3] = _DUP[1]                                   # equal IoUs
_BDA_SCORE = _u(0, 1, 5, 3)
_BDA_SCORE[1] = [0.9, 0.2, 0.2]                     # tie, background best
_BDA_SCORE[2] = [0.1, 0.5, 0.5]                     # tie between classes

_GEOM_CASES = [
    _case("prior_box", "prior_box", {"Input": _FEAT, "Image": _IMG},
          {"min_sizes": [4.0, 8.0], "max_sizes": [8.0, 12.0],
           "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True,
           "variances": [0.1, 0.1, 0.2, 0.2], "step_w": 0.0, "step_h": 0.0,
           "offset": 0.5}),
    _case("prior_box_steps", "prior_box",
          {"Input": np.zeros((1, 8, 3, 5), np.float32), "Image": _IMG},
          {"min_sizes": [10.0], "aspect_ratios": [2.0], "flip": False,
           "clip": False, "step_w": 7.0, "step_h": 9.0, "offset": 0.25}),
    _case("density_prior_box", "density_prior_box",
          {"Input": _FEAT, "Image": _IMG},
          {"fixed_sizes": [8.0, 16.0], "fixed_ratios": [1.0, 2.0],
           "densities": [2, 1], "clip": True, "step_w": 0.0,
           "step_h": 0.0, "offset": 0.5}),
    _case("anchor_generator", "anchor_generator",
          {"Input": np.zeros((1, 8, 3, 4), np.float32)},
          {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0],
           "stride": [8.0, 8.0], "offset": 0.5,
           "variances": [0.1, 0.1, 0.2, 0.2]}),
    _case("box_coder_encode", "box_coder",
          {"PriorBox": _PRIOR, "PriorBoxVar": _PVAR,
           "TargetBox": _boxes(3, 0.0, 0.6, 0.1, 0.4)},
          {"code_type": "encode_center_size"}),
    _case("box_coder_decode", "box_coder",
          {"PriorBox": _PRIOR, "PriorBoxVar": _PVAR,
           "TargetBox": _f(2, 6, 4)}, {"code_type": "decode_center_size"}),
    _case("box_coder_decode_pixels", "box_coder",
          {"PriorBox": _PRIOR * 50, "TargetBox": _f(2, 6, 4) * 0.5},
          {"code_type": "decode_center_size", "box_normalized": False}),
    _case("box_clip", "box_clip",
          {"Input": _u(-10, 60, 2, 5, 4),
           "ImInfo": np.array([[40, 50, 1], [30, 20, 1]], np.float32)}),
    _case("iou_similarity", "iou_similarity",
          {"X": _DUP, "Y": np.concatenate([_DUP[:3], _PRIOR[:2]])}),
    _case("polygon_box_transform", "polygon_box_transform",
          {"Input": _f(2, 8, 3, 4)}),
    _case("box_decoder_and_assign", "box_decoder_and_assign",
          {"PriorBox": _boxes(5, 0, 40, 5, 20),
           "PriorBoxVar": np.array([[0.1, 0.1, 0.2, 0.2]], np.float32),
           "TargetBox": _f(5, 12) * 0.5, "BoxScore": _BDA_SCORE},
          {"box_clip": 1.5}),
    _case("yolo_box", "yolo_box",
          {"X": _f(2, 3 * 9, 5, 5),
           "ImgSize": np.array([[160, 200], [96, 80]], np.int64)},
          {"anchors": [10, 13, 16, 30, 33, 23], "class_num": 4,
           "conf_thresh": 0.4, "downsample_ratio": 32}),
    _case("yolo_box_noclip", "yolo_box",
          {"X": _f(1, 2 * 7, 3, 4),
           "ImgSize": np.array([[64, 96]], np.int64)},
          {"anchors": [10, 13, 30, 61], "class_num": 2, "conf_thresh": 0.0,
           "downsample_ratio": 16, "clip_bbox": False}),
]


@_family(_GEOM_CASES)
def test_geometry_ops_match_jax(k):
    _check(_GEOM_CASES, k)


# ---------------------------------------------------------------------------
# SSD matching, mining and assignment
# ---------------------------------------------------------------------------

_DIST = _u(0, 1, 2, 3, 7)
_DIST[0, 1, 2] = _DIST[0, 0, 2] = 0.95               # tie across rows
_DIST[0, 2] = 0.0                                   # an all-zero row
_DIST[1, :, 4] = 0.7                                # tie down a column
_MATCH = np.array([[0, -1, 2, -1, 1, -1, -1, 0],
                   [-1, -1, -1, 1, -1, 2, -1, -1]], np.int64)
_NEG = np.array([[1, 3, 5, -1], [0, 6, -1, -1]], np.int64)
# bulk-equal losses: masked or clamped losses tie in blocks
_CLS_LOSS = np.round(_u(0, 1, 2, 12) * 3) / 3
_MH_MATCH = np.array([[-1, 0, -1, -1, 1, -1, -1, -1, -1, 2, -1, -1],
                      [-1, -1, 0, -1, -1, -1, -1, -1, 1, -1, -1, -1]],
                     np.int64)
_MH_DIST = _u(0, 1, 2, 12)
_MH_DIST[0, :4] = 0.2

_MATCH_CASES = [
    _case("bipartite_match", "bipartite_match", {"DistMat": _DIST}),
    _case("bipartite_match_per_prediction", "bipartite_match",
          {"DistMat": _DIST},
          {"match_type": "per_prediction", "dist_threshold": 0.5}),
    _case("bipartite_match_2d", "bipartite_match", {"DistMat": _DIST[1]}),
    _case("target_assign", "target_assign",
          {"X": _f(2, 3, 4), "MatchIndices": _MATCH}),
    _case("target_assign_neg", "target_assign",
          {"X": _f(2, 3, 4), "MatchIndices": _MATCH, "NegIndices": _NEG},
          {"mismatch_value": -2}),
    _case("target_assign_per_prior", "target_assign",
          {"X": _f(2, 3, 8, 4), "MatchIndices": _MATCH}),
    _case("target_assign_labels", "target_assign",
          {"X": _R.randint(1, 5, (2, 3, 1)).astype(np.int64),
           "MatchIndices": _MATCH, "NegIndices": _NEG},
          {"mismatch_value": 0}),
    _case("mine_hard_examples", "mine_hard_examples",
          {"ClsLoss": _CLS_LOSS, "MatchIndices": _MH_MATCH,
           "MatchDist": _MH_DIST}, {"neg_pos_ratio": 2.0}),
    _case("mine_hard_examples_hard", "mine_hard_examples",
          {"ClsLoss": _CLS_LOSS, "MatchIndices": _MH_MATCH,
           "MatchDist": _MH_DIST, "LocLoss": np.round(_u(0, 1, 2, 12))},
          {"mining_type": "hard_example", "sample_size": 5}),
]


@_family(_MATCH_CASES)
def test_matching_ops_match_jax(k):
    _check(_MATCH_CASES, k)


# ---------------------------------------------------------------------------
# NMS and the two-stage and one-stage heads
# ---------------------------------------------------------------------------

_NMS_BOXES = np.stack([_boxes(12, 0.0, 0.7, 0.1, 0.3) for _ in range(2)])
_NMS_BOXES[0, 5] = _NMS_BOXES[0, 4] + 0.01          # heavy overlaps
_NMS_BOXES[1, 7] = _NMS_BOXES[1, 2]
_NMS_SCORES = np.round(_u(0, 1, 2, 3, 12) * 8) / 8  # ties within a class
_NMS_SCORES[0, 1, :3] = 0.0

_ANCH = _boxes(24, 0, 50, 6, 24)
_GT = np.stack([_boxes(3, 0, 40, 8, 20), _boxes(3, 0, 40, 8, 20)])
_GT[1, 2] = 0.0                                     # a padding gt row
_GT[0, 1] = _ANCH[5] + 0.5                          # a near-exact match
_IM = np.array([[64, 64, 1.0], [60, 56, 1.0]], np.float32)
_GP_SCORES = np.round(_u(0, 1, 2, 24, 1) * 6) / 6   # ties
_FPN_ROIS = np.concatenate([_boxes(6, 0, 300, 4, 40),
                            _boxes(6, 0, 300, 60, 400)])
_LVL_SC = [np.round(_u(0.1, 1, 6, 1) * 4) / 4 for _ in range(3)]
_LVL_SC[1][4:] = 0.0                                # padding rows
_RT_LABELS = np.array([[1, 3, 2], [2, 1, 4]], np.int64)

_HEAD_CASES = [
    _case("multiclass_nms", "multiclass_nms",
          {"BBoxes": _NMS_BOXES, "Scores": _NMS_SCORES},
          {"score_threshold": 0.1, "nms_threshold": 0.3, "nms_top_k": 8,
           "keep_top_k": 10, "background_label": 0}),
    _case("multiclass_nms_pad", "multiclass_nms",
          {"BBoxes": _NMS_BOXES * 30, "Scores": _NMS_SCORES},
          {"score_threshold": 0.3, "nms_threshold": 0.5, "nms_top_k": 4,
           "keep_top_k": 20, "normalized": False}),
    _case("rpn_target_assign", "rpn_target_assign",
          {"Anchor": _ANCH, "GtBoxes": _GT, "ImInfo": _IM},
          {"rpn_batch_size_per_im": 8, "rpn_positive_overlap": 0.5,
           "rpn_negative_overlap": 0.3, "use_random": False}),
    _case("rpn_target_assign_crowd", "rpn_target_assign",
          {"Anchor": _ANCH, "GtBoxes": _GT, "ImInfo": _IM,
           "IsCrowd": np.array([[0, 1, 0], [0, 0, 0]], np.int64)},
          {"rpn_batch_size_per_im": 6, "rpn_straddle_thresh": -1.0,
           "rpn_positive_overlap": 0.4, "use_random": False}),
    _case("generate_proposals", "generate_proposals",
          {"Scores": _GP_SCORES, "BboxDeltas": _f(2, 24, 4) * 0.3,
           "ImInfo": _IM, "Anchors": _ANCH,
           "Variances": np.tile(_PVAR[:1], (24, 1))},
          {"pre_nms_topN": 12, "post_nms_topN": 8, "nms_thresh": 0.5,
           "min_size": 2.0}),
    _case("generate_proposals_pad", "generate_proposals",
          {"Scores": _GP_SCORES, "BboxDeltas": _f(2, 24, 4) * 4.0,
           "ImInfo": _IM, "Anchors": _ANCH,
           "Variances": np.ones((24, 4), np.float32)},
          {"pre_nms_topN": 30, "post_nms_topN": 28, "nms_thresh": 0.7,
           "min_size": 10.0}),
    _case("distribute_fpn_proposals", "distribute_fpn_proposals",
          {"FpnRois": _FPN_ROIS},
          {"min_level": 2, "max_level": 5, "refer_level": 4,
           "refer_scale": 224}),
    _case("distribute_fpn_proposals_num", "distribute_fpn_proposals",
          {"FpnRois": _FPN_ROIS, "RoisNum": np.array([4, 5], np.int64)},
          {"min_level": 2, "max_level": 5, "refer_level": 4,
           "refer_scale": 224}),
    _case("collect_fpn_proposals", "collect_fpn_proposals",
          {"MultiLevelRois": [_boxes(6, 0, 99, 5, 30) for _ in range(3)],
           "MultiLevelScores": _LVL_SC}, {"post_nms_topN": 8}),
    _case("collect_fpn_proposals_pad", "collect_fpn_proposals",
          {"MultiLevelRois": [_boxes(6, 0, 99, 5, 30) for _ in range(3)],
           "MultiLevelScores": _LVL_SC}, {"post_nms_topN": 25}),
    _case("retinanet_target_assign", "retinanet_target_assign",
          {"BBoxPred": _f(2, 24, 4), "ClsLogits": _f(2, 24, 4),
           "Anchor": _ANCH, "GtBoxes": _GT, "GtLabels": _RT_LABELS,
           "IsCrowd": np.array([[0, 0, 1], [0, 0, 0]], np.int64),
           "ImInfo": _IM},
          {"positive_overlap": 0.5, "negative_overlap": 0.3}),
    _case("retinanet_detection_output", "retinanet_detection_output",
          {"BBoxes": [_f(2, 24, 4) * 0.2, _f(2, 8, 4) * 0.2],
           "Scores": [np.round(_u(0, 1, 2, 24, 3) * 5) / 5,
                      np.round(_u(0, 1, 2, 8, 3) * 5) / 5],
           "Anchors": [_ANCH, _boxes(8, 0, 40, 20, 40)], "ImInfo": _IM},
          {"score_threshold": 0.3, "nms_top_k": 10, "keep_top_k": 24,
           "nms_threshold": 0.4}),
]


@_family(_HEAD_CASES)
def test_head_ops_match_jax(k):
    _check(_HEAD_CASES, k)


# ---------------------------------------------------------------------------
# the differentiable rules: RoI pooling, the losses, the warps, var_conv
# ---------------------------------------------------------------------------

_ROIS = np.concatenate([_boxes(4, 0, 20, 3, 12),
                        np.array([[-4, -3, 30, 40]], np.float32)])
_TIED = np.round(_f(2, 3, 8, 8))                    # bulk-tied maxima
_FOCAL_LABEL = np.array([[-1], [0], [1], [3], [4], [2]], np.int64)
_YOLO_ANCH = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
_YOLO_GT = np.array([[[0.3, 0.4, 0.2, 0.3], [0.7, 0.2, 0.05, 0.1],
                      [0.5, 0.5, 0.9, 0.8]],
                     [[0.1, 0.8, 0.3, 0.15], [0.0, 0.0, 0.0, 0.0],
                      [0.6, 0.6, 0.1, 0.1]]], np.float32)
_QUADS = np.array([[[1, 1, 9, 2, 10, 8, 2, 7], [3, 0, 11, 1, 10, 6, 4, 5]],
                   [[0, 2, 6, 1, 7, 9, 1, 8],
                    [-2, -1, 14, 0, 13, 12, -1, 11]]],
                  np.float32)

_DIFF_CASES = [
    _case("roi_align", "roi_align",
          {"X": _f(2, 3, 8, 8), "ROIs": _ROIS,
           "RoisNum": np.array([2, 3], np.int64)},
          {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5,
           "sampling_ratio": 2}),
    _case("roi_align_short_num", "roi_align",
          {"X": _f(2, 3, 8, 8), "ROIs": _ROIS,
           "RoisNum": np.array([0, 3], np.int64)},
          {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 0.4}),
    _case("roi_pool", "roi_pool",
          {"X": _f(2, 3, 8, 8), "ROIs": _ROIS,
           "RoisNum": np.array([2, 3], np.int64)},
          {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.3}),
    _case("roi_pool_ties", "roi_pool", {"X": _TIED, "ROIs": _ROIS},
          {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 0.5}),
    _case("sigmoid_focal_loss", "sigmoid_focal_loss",
          {"X": _f(6, 4) * 2, "Label": _FOCAL_LABEL,
           "FgNum": np.array([0], np.int64)}, {"gamma": 1.5, "alpha": 0.4}),
    _case("yolov3_loss", "yolov3_loss",
          {"X": _f(2, 3 * 9, 4, 4), "GTBox": _YOLO_GT,
           "GTLabel": np.array([[1, 3, 0], [2, 0, 1]], np.int64),
           "GTScore": _u(0.3, 1, 2, 3)},
          {"anchors": _YOLO_ANCH, "anchor_mask": [3, 4, 5], "class_num": 4,
           "ignore_thresh": 0.5, "downsample_ratio": 8}),
    _case("roi_perspective_transform", "roi_perspective_transform",
          {"X": _f(2, 3, 10, 12), "ROIs": _QUADS},
          {"transformed_height": 4, "transformed_width": 5,
           "spatial_scale": 0.8}),
    _case("deformable_psroi_pooling", "deformable_psroi_pooling",
          {"Input": _f(2, 8, 8, 8), "ROIs": np.stack(
              [_boxes(3, 0, 20, 4, 12) for _ in range(2)]),
           "Trans": _f(6, 2, 2, 2)},
          {"no_trans": False, "spatial_scale": 0.5, "output_dim": 2,
           "group_size": [2, 2], "pooled_height": 2, "pooled_width": 2,
           "part_size": [2, 2], "sample_per_part": 2, "trans_std": 0.1}),
    _case("var_conv_2d", "var_conv_2d",
          {"X": _f(2, 2, 7, 6), "W": _f(3, 2 * 15),
           "ROW": np.array([5, 7], np.int64),
           "COLUMN": np.array([6, 3], np.int64)},
          {"InputChannel": 2, "OutputChannel": 3, "KernelH": 3,
           "KernelW": 5, "StrideH": 2, "StrideW": 2}),
]


@_family(_DIFF_CASES)
def test_differentiable_ops_match_jax(k):
    _check(_DIFF_CASES, k)


# ---------------------------------------------------------------------------
# R-CNN labels and detection_map
# ---------------------------------------------------------------------------

_RPN_ROIS = np.stack([np.concatenate([_GT[i, :2] + _u(-2, 2, 2, 4),
                                      _boxes(6, 0, 40, 6, 20)])
                      for i in range(2)])
_RPN_ROIS[1, 7] = 0.0                                # a padding roi
_SEGMS = (_u(0, 1, 2, 3, 16, 16) > 0.5).astype(np.float32)
_MASK_LABELS = np.array([[2, 0, -1, 1, 3, 1], [1, 1, 0, -1, 2, 0]], np.int32)
_DET = np.array([
    [[1, 0.9, 0.1, 0.1, 0.4, 0.4], [1, 0.8, 0.12, 0.1, 0.42, 0.4],
     [2, 0.8, 0.5, 0.5, 0.9, 0.9], [3, 0.3, 0.0, 0.6, 0.3, 0.9],
     [-1, -1, -1, -1, -1, -1]],
    [[2, 0.7, 0.2, 0.2, 0.6, 0.7], [1, 0.6, 0.6, 0.1, 0.9, 0.3],
     [0, 0.95, 0.0, 0.0, 0.2, 0.2], [2, 0.7, 0.21, 0.2, 0.6, 0.7],
     [3, 0.5, 0.5, 0.5, 0.8, 0.8]]], np.float32)
_LAB6 = np.array([
    [[1, 0.1, 0.1, 0.4, 0.4, 0], [2, 0.5, 0.5, 0.9, 0.92, 1],
     [3, 0.0, 0.0, 0.0, 0.0, 0]],
    [[2, 0.2, 0.2, 0.6, 0.7, 0], [1, 0.6, 0.1, 0.9, 0.3, 1],
     [3, 0.5, 0.5, 0.8, 0.8, 0]]], np.float32)

_LABEL_CASES = [
    _case("generate_proposal_labels", "generate_proposal_labels",
          {"RpnRois": _RPN_ROIS,
           "GtClasses": np.array([[1, 3, 2], [2, 1, 0]], np.int64),
           "GtBoxes": _GT, "ImInfo": _IM},
          {"batch_size_per_im": 6, "fg_fraction": 0.5, "fg_thresh": 0.5,
           "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0, "class_nums": 4,
           "use_random": False}),
    _case("generate_proposal_labels_agnostic", "generate_proposal_labels",
          {"RpnRois": _RPN_ROIS,
           "GtClasses": np.array([[1, 3, 2], [2, 1, 0]], np.int64),
           "GtBoxes": _GT, "ImInfo": _IM,
           "IsCrowd": np.array([[0, 1, 0], [0, 0, 0]], np.int64)},
          {"batch_size_per_im": 5, "fg_fraction": 0.25, "fg_thresh": 0.4,
           "bg_thresh_hi": 0.4, "bg_thresh_lo": 0.05, "class_nums": 4,
           "use_random": False, "is_cls_agnostic": True,
           "is_cascade_rcnn": True,
           "bbox_reg_weights": [1.0, 1.0, 2.0, 2.0]}),
    _case("generate_mask_labels", "generate_mask_labels",
          {"ImInfo": _IM, "GtClasses": np.array([[1, 3, 2], [2, 1, 0]],
                                                np.int64),
           "GtSegms": _SEGMS, "Rois": _RPN_ROIS[:, :6],
           "LabelsInt32": _MASK_LABELS,
           "MatchedGtInt32": np.array([[0, 1, 2, 2, 1, 0],
                                       [1, 0, 0, 2, 1, 1]], np.int32)},
          {"num_classes": 4, "resolution": 5}),
    _case("generate_mask_labels_unmatched", "generate_mask_labels",
          {"ImInfo": _IM, "GtClasses": np.array([[1, 3, 2], [2, 1, 0]],
                                                np.int64),
           "GtSegms": _SEGMS, "Rois": _RPN_ROIS[:, :6],
           "LabelsInt32": _MASK_LABELS},
          {"num_classes": 4, "resolution": 4}),
    # the accumulating form (state inputs, HasState 1 and 0) runs
    # against JAX in test_torch_detection_models.py's DetectionMAP test
    _case("detection_map", "detection_map",
          {"DetectRes": _DET, "Label": _LAB6[:, :, :5]},
          {"class_num": 4, "background_label": -1}),
    _case("detection_map_11point", "detection_map",
          {"DetectRes": _DET, "Label": _LAB6},
          {"class_num": 4, "ap_type": "11point",
           "evaluate_difficult": False, "overlap_threshold": 0.6}),
]


@_family(_LABEL_CASES)
def test_label_and_map_ops_match_jax(k):
    _check(_LABEL_CASES, k)


def test_every_detection_op_type_has_a_case():
    import paddle_tpu.ops.detection_extra_ops as jx
    import paddle_tpu.ops.detection_ops as jd
    ported = {op for op, d in treg._REGISTRY.items()
              if d.lower is not None and d.lower.__module__.endswith(
                  ("ops.detection_ops", "ops.detection_extra_ops"))}
    jax_types = {op for op, d in jreg._REGISTRY.items()
                 if d.lower is not None
                 and d.lower.__module__ in (jd.__name__, jx.__name__)}
    assert ported == jax_types and len(ported) == 29
    covered = {c.values[0] for cases in (
        _GEOM_CASES, _MATCH_CASES, _HEAD_CASES, _DIFF_CASES, _LABEL_CASES)
        for c in cases}
    assert covered == jax_types


# ---------------------------------------------------------------------------
# the two sampling rules with use_random=True: invariants
# ---------------------------------------------------------------------------

def _sampled(op, ins, attrs, seed):
    return {k: [t.numpy() for t in v] for k, v in
            _torch_run(op, ins, attrs, seed=seed).items()}


def test_rpn_target_assign_random_sampling():
    """Equal draws for equal seeds; at most batch * fg_fraction fg rows,
    all from the fg candidates, and the bg rows fill the batch from the
    bg candidates, as many as the rule without randomness takes."""
    ins = {"Anchor": _ANCH, "GtBoxes": _GT, "ImInfo": _IM}
    attrs = {"rpn_batch_size_per_im": 6, "rpn_positive_overlap": 0.3,
             "rpn_negative_overlap": 0.3, "rpn_fg_fraction": 0.5}
    plain = _sampled("rpn_target_assign", ins,
                     {**attrs, "use_random": False}, 0)["TargetLabel"][0]
    runs = [_sampled("rpn_target_assign", ins,
                     {**attrs, "use_random": True}, s)
            for s in (1, 1, 2, 3, 4)]
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k][0], runs[1][k][0])
    # candidates: a plain run with a batch large enough to keep them all
    cand = _sampled("rpn_target_assign", ins,
                    {**attrs, "rpn_batch_size_per_im": 1000,
                     "rpn_fg_fraction": 1.0, "use_random": False}, 0)
    fg_c = cand["TargetLabel"][0] == 1
    big = _sampled("rpn_target_assign", ins,
                   {**attrs, "rpn_batch_size_per_im": 1000,
                    "rpn_fg_fraction": 0.0, "use_random": False}, 0)
    bg_c = big["TargetLabel"][0] == 0
    picks = set()
    for r in runs:
        lab = r["TargetLabel"][0]
        for i in range(lab.shape[0]):
            fg, bg = lab[i] == 1, lab[i] == 0
            assert fg.sum() == (plain[i] == 1).sum() <= 3
            assert bg.sum() == (plain[i] == 0).sum()
            assert not (fg & ~fg_c[i]).any() and not (bg & ~bg_c[i]).any()
            np.testing.assert_array_equal(
                r["BBoxInsideWeight"][0][i].any(-1), fg)
        picks.add(lab.tobytes())
    assert len(picks) > 1                   # other seeds, other samples


def test_generate_proposal_labels_random_sampling():
    ins = {"RpnRois": _RPN_ROIS,
           "GtClasses": np.array([[1, 3, 2], [2, 1, 0]], np.int64),
           "GtBoxes": _GT, "ImInfo": _IM}
    attrs = {"batch_size_per_im": 6, "fg_fraction": 0.5, "fg_thresh": 0.5,
             "bg_thresh_hi": 0.5, "class_nums": 4}
    plain = _sampled("generate_proposal_labels", ins,
                     {**attrs, "use_random": False}, 0)
    runs = [_sampled("generate_proposal_labels", ins,
                     {**attrs, "use_random": True}, s) for s in (5, 5, 6, 7)]
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k][0], runs[1][k][0])
    cand = np.concatenate([_RPN_ROIS, _GT], 1)
    for r in runs:
        lab, fgm, rois = r["LabelsInt32"][0], r["FgMask"][0], r["Rois"][0]
        for i in range(lab.shape[0]):
            assert fgm[i].sum() == plain["FgMask"][0][i].sum() <= 3
            assert (lab[i] == 0).sum() == (plain["LabelsInt32"][0][i] == 0
                                           ).sum()
            assert (lab[i] > 0).sum() == fgm[i].sum()
            # fg rows first, then bg, then padding
            kinds = np.where(fgm[i], 0, np.where(lab[i] == 0, 1, 2))
            assert (np.diff(kinds) >= 0).all()
            for row, kind in zip(rois[i], kinds):
                if kind < 2:             # every sampled roi is a candidate
                    assert (np.abs(cand[i] - row).max(1) == 0).any()


@pytest.mark.parametrize("k", [i for i, c in enumerate(_DIFF_CASES)
                               if c.values[0] == "roi_pool"],
                         ids=["roi_pool", "roi_pool_ties"])
def test_roi_pool_grad_op_matches_jax(k):
    """roi_pool's explicit grad (the `roi_pool_grad` op as backward
    writes it, run by registry.lower_op) against JAX's vjp, tied maxima
    included: each tie takes an even share, as JAX's max gradient
    gives it."""
    from paddle_tpu_torch.framework.core import Operator
    op, ins, attrs = _DIFF_CASES[k].values
    (wrt, outs), _, jgrads = _jax_family(_DIFF_CASES)[k]
    assert [s for s, _ in wrt] == ["X"] and [s for s, *_ in outs] == ["Out"]
    env = {f"in.{s}": torch.from_numpy(np.array(v))
           for s, v in _slots(ins).items() for v in v}
    fwd = _torch_run(op, ins, attrs)
    env["out.Out"] = fwd["Out"][0]
    env["g.Out"] = torch.from_numpy(core._cotangents(outs)[0])
    gins = {s: [f"in.{s}"] for s in _slots(ins)}
    gins.update({"__out__Out": ["out.Out"], "Out@GRAD": ["g.Out"]})
    gop = Operator(None, "roi_pool_grad", gins, {"X@GRAD": ["dx"]},
                   dict(attrs))
    treg.lower_op(treg.LowerContext(), gop, env)
    assert core._op_test_rel(env["dx"].numpy(), np.asarray(jgrads[0])) \
        <= core.GRAD_TOL
