"""The op library's long tail (`ops/nn_extra_ops.py`, the rest of
`ops/misc_ops.py` and `ops/extra_ops.py`) of the PyTorch port against the
JAX package's rules, on the CPU.

Each case calls the two packages' lowering rules directly on the same
seeded numpy inputs (`test_torch_core_ops.py`'s harness): JAX's cases of a
family in one jitted function with `jax.vjp`, the port's rule on CPU
tensors, on meta tensors (build-time shape inference) and under
`torch.func.vjp`. Floats within op_test's 1e-5, ints exactly, every input
gradient of a differentiable rule within op_test's 5e-3 (max relative
error). JAX without x64 gives int32 where the port declares int64
(ROADMAP §C).

The inputs are fed on purpose where the port could part from JAX:
  * ties: equal maxima in max_pool2d_with_index's windows (the first is
    the Mask, the gradient splits evenly), in spp, similarity_focus and
    dist's inf-norm, equal scores in positive_negative_pair, the kinks of
    the hinge and margin losses hit exactly;
  * repeated indices: unpool's Indices, center_loss's labels,
    multiplex's Ids, sample_logits' samples (its explicit grad), the
    SelectedRows rows, mean_iou's classes;
  * grid_sampler's samples on and off the grid lines and corners on the
    far edge, RoIs of two images and RoIs past RoisNum's sum in
    psroi_pool (deformable_conv: test_torch_nn_extra_models.py, whose
    DCN units and layer program hold it with non-zero offsets);
  * hash ids that wrap (negative, 2^32 and above) for several num_hash;
    unique's padding; quantize's .5 inputs; edit_distance's empty,
    clamped and missing lengths; tree_conv's padding edges.
The random rules (random_crop, sampling_id, the *_batch_size_like ops,
sample_logits' own sampler) draw on a torch.Generator: they are held on
shapes, ranges, bounds, support and equal draws for equal seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework import registry as jreg
from paddle_tpu.framework.selected_rows import SelectedRows as JSR
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.framework.selected_rows import SelectedRows as TSR
from test_torch_core_ops import OUT_TOL, _case, _check, _family, _torch_run
from torch_port_common import one_torch_thread  # noqa: F401

_R = np.random.RandomState(22)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


def _u(lo, hi, *shape):
    return _R.uniform(lo, hi, shape).astype(np.float32)


def _i(hi, *shape):
    return _R.randint(0, hi, shape).astype(np.int64)


def _ties(*shape):
    """Small integer-valued floats: many equal maxima in a window."""
    return _R.randint(0, 3, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# nn_extra: transforms, samplers, pools
# ---------------------------------------------------------------------------

_GRID = _u(-1.2, 1.2, 2, 4, 5, 2)
_GRID[0, 0, :, 0] = 1.0                 # the far edge, in range
_GRID[0, 1, :, 1] = -1.0
_GRID[1, 0, 0] = [0.0, 0.0]             # on the grid lines
_PSX = _f(2, 2 * 3 * 3, 8, 10)
_PSROIS = np.array([[0, 0, 9, 7], [2, 1, 6, 5], [1.4, 2.6, 3.5, 3.5],
                    [3, 0, 19, 15], [0, 0, 0, 0], [5, 3, 8, 14]],
                   np.float32)
_UNPOOL_IDX = np.array(_R.randint(0, 6 * 8, (2, 3, 3, 4)), np.int32)
_UNPOOL_IDX[0, 0, 0, :2] = 5            # repeated positions add

_SAMPLER_CASES = [
    _case("affine_channel", "affine_channel",
          {"X": _f(2, 3, 4, 5), "Scale": _f(3), "Bias": _f(3)}),
    _case("affine_channel_nhwc", "affine_channel",
          {"X": _f(2, 4, 5, 3), "Scale": _f(3), "Bias": _f(3)},
          {"data_layout": "NHWC"}),
    _case("affine_grid", "affine_grid", {"Theta": _f(2, 2, 3)},
          {"output_shape": [2, 3, 5, 7]}),
    _case("grid_sampler", "grid_sampler",
          {"X": _f(2, 3, 6, 7), "Grid": _GRID}),
    _case("max_pool2d_with_index", "max_pool2d_with_index",
          {"X": _ties(2, 3, 6, 8)}, {"ksize": [2, 2], "strides": [2, 2]}),
    _case("max_pool2d_with_index_pad", "max_pool2d_with_index",
          {"X": _ties(2, 2, 7, 5)},
          {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}),
    _case("unpool", "unpool", {"X": _f(2, 3, 3, 4), "Indices": _UNPOOL_IDX},
          {"unpooled_size": [6, 8]}),
    _case("unpool_default", "unpool",
          {"X": _f(1, 2, 2, 3),
           "Indices": np.array(_R.randint(0, 24, (1, 2, 2, 3)), np.int32)}),
    _case("spp_max", "spp", {"X": _ties(2, 3, 7, 9)},
          {"pyramid_height": 3, "pooling_type": "max"}),
    _case("spp_avg", "spp", {"X": _f(2, 3, 6, 5)},
          {"pyramid_height": 2, "pooling_type": "avg"}),
    _case("psroi_pool", "psroi_pool",
          {"X": _PSX, "ROIs": _PSROIS, "RoisNum": np.array([3, 2],
                                                           np.int32)},
          {"pooled_height": 3, "pooled_width": 3, "output_channels": 2,
           "spatial_scale": 0.5}),
    _case("psroi_pool_one_image", "psroi_pool",
          {"X": _PSX[:1], "ROIs": _PSROIS[:4]},
          {"pooled_height": 3, "pooled_width": 3, "output_channels": 2,
           "spatial_scale": 1.0}),
]


@_family(_SAMPLER_CASES)
def test_sampler_and_pool_ops_match_jax(k):
    _check(_SAMPLER_CASES, k)


# ---------------------------------------------------------------------------
# nn_extra: CTR / ranking, the recurrences, fc, sync_batch_norm, tree_conv
# ---------------------------------------------------------------------------

_SCORE = np.array([[0.3], [0.7], [0.3], [0.1], [0.9], [0.9], [0.5], [0.2]],
                  np.float32)
_EDGES = np.array([[[1, 2], [1, 3], [2, 4], [2, 5], [0, 0], [0, 0]],
                   [[1, 2], [2, 3], [3, 4], [1, 5], [5, 6], [0, 0]]],
                  np.int64)

_NN_EXTRA_CASES = [
    _case("cvm", "cvm", {"X": np.abs(_f(4, 5)), "CVM": _f(4, 2)}),
    _case("cvm_off", "cvm", {"X": _f(4, 5), "CVM": _f(4, 2)},
          {"use_cvm": False}),
    _case("data_norm", "data_norm",
          {"X": _f(4, 5), "BatchSize": _u(1, 3, 5), "BatchSum": _f(5),
           "BatchSquareSum": _u(1, 3, 5)}),
    _case("fsp", "fsp", {"X": _f(2, 3, 4, 5), "Y": _f(2, 4, 4, 5)}),
    _case("similarity_focus", "similarity_focus",
          {"X": _ties(2, 3, 4, 5)}, {"axis": 1, "indexes": [0, 2]}),
    _case("similarity_focus_axis3", "similarity_focus",
          {"X": _f(2, 3, 4, 5)}, {"axis": 3, "indexes": [1]}),
    _case("positive_negative_pair", "positive_negative_pair",
          {"Score": _SCORE,
           "Label": np.array([[1], [2], [0], [1], [2], [1], [0], [1]],
                             np.float32),
           "QueryID": np.array([[0], [0], [0], [1], [1], [1], [1], [2]],
                               np.int64)}),
    _case("filter_by_instag", "filter_by_instag",
          {"Ins": _f(5, 3),
           "Ins_tag": np.array([[1, 2], [3, 4], [2, 2], [5, 6], [0, 4]],
                               np.int64),
           "Filter_tag": np.array([2, 4, 9], np.int64)}),
    _case("match_matrix_tensor", "match_matrix_tensor",
          {"X": _f(2, 3, 4), "Y": _f(2, 5, 4), "W": _f(4, 2, 4)}),
    _case("center_loss", "center_loss",
          {"X": _f(6, 4), "Label": np.array([[0], [2], [0], [1], [0], [2]],
                                            np.int64),
           "Centers": _f(3, 4), "CenterUpdateRate": np.array([0.1],
                                                             np.float32)}),
    _case("center_loss_no_update", "center_loss",
          {"X": _f(4, 4), "Label": np.array([[1], [1], [0], [1]], np.int64),
           "Centers": _f(3, 4), "CenterUpdateRate": np.array([0.5],
                                                             np.float32)},
          {"need_update": False}),
    _case("lstm_unit", "lstm_unit", {"X": _f(3, 8), "C_prev": _f(3, 2)},
          {"forget_bias": 0.5}),
    _case("lstmp", "lstmp",
          {"Input": _f(2, 4, 8), "Weight": _f(3, 8) * 0.5,
           "ProjWeight": _f(2, 3) * 0.5, "Bias": _f(1, 8)}),
    _case("lstmp_state", "lstmp",
          {"Input": _f(2, 3, 8), "Weight": _f(3, 8) * 0.5,
           "ProjWeight": _f(2, 3) * 0.5, "C0": _f(2, 2), "H0": _f(2, 3)},
          {"gate_activation": "sigmoid", "cell_activation": "relu",
           "candidate_activation": "identity", "proj_activation": "relu"}),
    _case("lstm", "lstm",
          {"Input": _f(2, 3, 8), "Weight": _f(2, 8) * 0.5,
           "Bias": _f(1, 8)}),
    _case("gru", "gru",
          {"Input": _f(2, 3, 6), "Weight": _f(2, 6) * 0.5,
           "Bias": _f(1, 6)}),
    _case("row_conv", "row_conv", {"X": _f(2, 5, 3), "Filter": _f(3, 3)}),
    _case("fc", "fc", {"Input": _f(2, 3, 4), "W": _f(4, 5), "Bias": _f(5)},
          {"in_num_col_dims": 2}),
    _case("fc_flat", "fc", {"Input": _f(2, 3, 4), "W": _f(12, 5)}),
    _case("sync_batch_norm", "sync_batch_norm",
          {"X": _f(4, 3, 2, 2), "Scale": _f(3), "Bias": _f(3),
           "Mean": _f(3), "Variance": _u(0.5, 2, 3)},
          {"epsilon": 1e-5, "momentum": 0.9}),
    _case("sync_batch_norm_nhwc", "sync_batch_norm",
          {"X": _f(4, 2, 2, 3), "Scale": _f(3), "Bias": _f(3),
           "Mean": _f(3), "Variance": _u(0.5, 2, 3)},
          {"data_layout": "NHWC"}),
    _case("sync_batch_norm_test", "sync_batch_norm",
          {"X": _f(4, 3, 2, 2), "Scale": _f(3), "Bias": _f(3),
           "Mean": _f(3), "Variance": _u(0.5, 2, 3)}, {"is_test": True}),
    _case("tree_conv", "tree_conv",
          {"EdgeSet": _EDGES, "NodesVector": _f(2, 6, 3),
           "Filter": _f(3, 3, 2, 2)}, {"max_depth": 2}),
    _case("tree_conv_deep", "tree_conv",
          {"EdgeSet": _EDGES, "NodesVector": _f(2, 6, 3),
           "Filter": _f(3, 3, 2, 2)}, {"max_depth": 3}),
    _case("attention_lstm", "attention_lstm",
          {"X": _f(2, 4, 3), "SeqLen": np.array([4, 2], np.int64),
           "C0": _f(2, 2), "H0": _f(2, 2), "AttentionWeight": _f(5, 1),
           "AttentionBias": _f(1, 1), "AttentionScalar": _f(1, 1),
           "AttentionScalarBias": _f(1, 1), "LSTMWeight": _f(5, 8) * 0.5,
           "LSTMBias": _f(1, 8)}),
    _case("attention_lstm_plain", "attention_lstm",
          {"X": _f(2, 3, 3), "C0": _f(2, 2), "AttentionWeight": _f(5, 1),
           "LSTMWeight": _f(5, 8) * 0.5, "LSTMBias": _f(1, 8)}),
    _case("sample_logits_custom", "sample_logits",
          {"Logits": _f(3, 20), "Labels": np.array([[3], [0], [7]],
                                                   np.int64),
           "CustomizedSamples": np.array(
               [[3, 5, 3, 9, 5, 1], [0, 0, 2, 19, 4, 4],
                [7, 1, 2, 7, 7, 8]], np.int64),
           "CustomizedProbabilities": _u(0.01, 0.5, 3, 6)},
          {"num_samples": 5, "use_customized_samples": True,
           "remove_accidental_hits": True}),
]


@_family(_NN_EXTRA_CASES)
def test_nn_extra_ops_match_jax(k):
    _check(_NN_EXTRA_CASES, k)


# ---------------------------------------------------------------------------
# misc: rearrangements, linalg helpers, ranking losses
# ---------------------------------------------------------------------------

_MARGIN_X = _f(6, 1)
_HINGE = _f(6, 1)
_HINGE[0, 0], _HINGE[1, 0] = 1.0, -1.0      # on the kink

_MISC_CASES = [
    _case("pixel_shuffle", "pixel_shuffle", {"X": _f(2, 8, 3, 3)},
          {"upscale_factor": 2}),
    _case("shuffle_channel", "shuffle_channel", {"X": _f(2, 6, 2, 2)},
          {"group": 3}),
    _case("space_to_depth", "space_to_depth", {"X": _f(2, 2, 4, 6)},
          {"blocksize": 2}),
    _case("temporal_shift", "temporal_shift", {"X": _f(6, 8, 2, 2)},
          {"seg_num": 3, "shift_ratio": 0.25}),
    _case("unfold", "unfold", {"X": _f(2, 3, 5, 6)},
          {"kernel_sizes": [2, 3], "strides": [1, 2],
           "paddings": [1, 0, 1, 1], "dilations": [2, 1]}),
    _case("unfold_sym", "unfold", {"X": _f(1, 2, 4, 4)},
          {"kernel_sizes": [3, 3], "strides": [1, 1], "paddings": [1, 1],
           "dilations": [1, 1]}),
    _case("im2sequence", "im2sequence", {"X": _f(2, 2, 5, 4)},
          {"kernels": [2, 2], "strides": [1, 2],
           "paddings": [0, 1, 1, 0]}),
    _case("norm", "norm", {"X": _f(3, 4, 5)}, {"axis": 1}),
    _case("dist_2", "dist", {"X": _f(3, 4), "Y": _f(3, 4)}),
    _case("dist_3", "dist", {"X": _f(3, 4), "Y": _f(1, 4)}, {"p": 3.0}),
    _case("dist_0", "dist", {"X": _ties(3, 4), "Y": _ties(3, 4)},
          {"p": 0}),
    _case("dist_inf", "dist",
          {"X": np.array([[1, -3, 2], [3, 0, 1]], np.float32),
           "Y": np.zeros((2, 3), np.float32)}, {"p": float("inf")}),
    _case("cross", "cross", {"X": _f(4, 3), "Y": _f(4, 3)}),
    _case("cross_dim0", "cross", {"X": _f(3, 4), "Y": _f(3, 4)},
          {"dim": 0}),
    _case("kron", "kron", {"X": _f(2, 3), "Y": _f(3, 2)}),
    _case("trace", "trace", {"Input": _f(3, 4, 5)},
          {"offset": 1, "axis1": 0, "axis2": 2}),
    _case("meshgrid", "meshgrid", {"X": [_f(3), _f(4), _f(2)]}),
    _case("bilinear_tensor_product", "bilinear_tensor_product",
          {"X": _f(4, 3), "Y": _f(4, 5), "Weight": _f(2, 3, 5),
           "Bias": _f(1, 2)}),
    _case("rank_loss", "rank_loss",
          {"Label": np.array([[1], [0], [1], [0], [1]], np.float32),
           "Left": _f(5, 1) * 3, "Right": _f(5, 1)}),
    _case("margin_rank_loss", "margin_rank_loss",
          {"Label": np.array([[1], [-1], [1], [-1], [1], [1]], np.float32),
           "X1": _MARGIN_X, "X2": np.concatenate([_MARGIN_X[:2],
                                                  _f(4, 1)])},
          {"margin": 0.0}),
    _case("bpr_loss", "bpr_loss",
          {"X": _f(4, 5), "Label": np.array([[1], [0], [4], [1]],
                                            np.int64)}),
    _case("hinge_loss", "hinge_loss",
          {"Logits": _HINGE,
           "Labels": np.array([[1], [0], [1], [0], [0], [1]], np.float32)}),
    _case("modified_huber_loss", "modified_huber_loss",
          {"X": np.array([[2.0], [0.5], [-0.3], [-2.0], [1.5], [0.2]],
                         np.float32),
           "Y": np.array([[1], [1], [0], [1], [0], [0]], np.float32)}),
    _case("teacher_student_sigmoid_loss", "teacher_student_sigmoid_loss",
          {"X": np.array([[20.0], [3.0], [-0.5], [-18.0], [0.7], [14.9]],
                         np.float32),
           "Label": np.array([[0.0], [1.0], [0.3], [0.9], [0.5], [0.0]],
                             np.float32)}),
]


@_family(_MISC_CASES)
def test_misc_ops_match_jax(k):
    _check(_MISC_CASES, k)


# ---------------------------------------------------------------------------
# extra: tensor helpers, metrics, hashing, unique, edit distance, the
# accumulators and the int8 trio
# ---------------------------------------------------------------------------

_HASH_IDS = np.array([[3, 7], [-1, 0], [1 << 32, 5], [3, 7],
                      [(1 << 32) + 3, 7], [-(1 << 33) + 11, 123456789]],
                     np.int64)
_HALF = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.49, 200.0, -200.0, 0.0,
                  -1.5], np.float32)
_ACC = {"param": _f(3, 2), "in_sum_1": _f(3, 2), "in_sum_2": _f(3, 2),
        "in_sum_3": _f(3, 2)}

_EXTRA_CASES = [
    _case("fill", "fill", {}, {"value": [1.5, 2, 3, 4, 5, 6],
                               "shape": [2, 3], "dtype": "float32"}),
    _case("fill_int", "fill", {}, {"value": [1, 2, 3, 4], "shape": [4],
                                   "dtype": "int32"}),
    _case("minus", "minus", {"X": _f(3, 4), "Y": _f(3, 4)}),
    _case("l1_norm", "l1_norm",
          {"X": np.array([[1, -2, 0], [0.5, 0, -3]], np.float32)}),
    _case("squared_l2_distance", "squared_l2_distance",
          {"X": _f(3, 4), "Y": _f(3, 4)}),
    _case("squared_l2_distance_row", "squared_l2_distance",
          {"X": _f(3, 2, 2), "Y": _f(1, 2, 2)}),
    _case("crop", "crop", {"X": _f(4, 5, 6)},
          {"shape": [2, 3, 4], "offsets": [1, 2, 0]}),
    _case("crop_like", "crop", {"X": _f(4, 5), "Y": _f(2, 3)},
          {"offsets": [2, 1]}),
    _case("crop_offsets", "crop",
          {"X": _f(4, 5, 6), "Offsets": np.array([1, 4, -2], np.int32)},
          {"shape": [2, 3, 4]}),
    _case("flatten", "flatten", {"X": _f(2, 3, 4, 5)}, {"axis": 2}),
    _case("flatten_0", "flatten", {"X": _f(2, 3, 4)}, {"axis": 0}),
    _case("squeeze", "squeeze", {"X": _f(2, 1, 3, 1)},
          {"axes": [1, -1, 0]}),
    _case("squeeze_all", "squeeze", {"X": _f(1, 3, 1, 2)}),
    _case("unsqueeze", "unsqueeze", {"X": _f(3, 4)}, {"axes": [2, 0]}),
    _case("unsqueeze_neg", "unsqueeze", {"X": _f(3, 4)}, {"axes": [-1]}),
    _case("pad_constant_like", "pad_constant_like",
          {"X": _f(4, 5), "Y": _f(2, 3)}, {"pad_value": 1.5}),
    _case("multiplex", "multiplex",
          {"X": [_f(4, 3), _f(4, 3), _f(4, 3)],
           "Ids": np.array([[2], [0], [2], [2]], np.int32)}),
    _case("mean_iou", "mean_iou",
          {"Predictions": np.array([0, 1, 1, 2, 2, 0, 1, 4, 4, 2],
                                   np.int32),
           "Labels": np.array([0, 1, 2, 2, 2, 1, 1, 4, 3, 0], np.int32)},
          {"num_classes": 6}),
    _case("conv_shift", "conv_shift", {"X": _f(2, 7), "Y": _f(2, 3)}),
    _case("hash", "hash", {"X": _HASH_IDS}, {"num_hash": 3, "mod_by": 1000}),
    _case("hash_default", "hash", {"X": _HASH_IDS[:, :1]}),
    _case("hash_wide", "hash", {"X": _HASH_IDS[:, 1:]},
          {"num_hash": 5, "mod_by": 1 << 20}),
    _case("unique", "unique",
          {"X": np.array([5, 2, 5, 1, 2, 5, 9], np.int64)}),
    _case("unique_float", "unique",
          {"X": np.array([0.5, -1.0, 0.5, 3.0], np.float32)}),
    _case("unique_one_value", "unique",
          {"X": np.array([4, 4, 4], np.int32)}),
    _case("unique_with_counts", "unique_with_counts",
          {"X": np.array([7, 2, 5, 1, 2, 5, 5, 3], np.int32)}),
    _case("edit_distance", "edit_distance",
          {"Hyps": _i(4, 5, 5), "Refs": _i(4, 5, 6),
           "HypsLength": np.array([5, 0, 7, 3, 2], np.int64),
           "RefsLength": np.array([6, 4, 3, 0, 9], np.int64)},
          {"normalized": False}),
    _case("edit_distance_normalized", "edit_distance",
          {"Hyps": _i(3, 4, 6), "Refs": _i(3, 4, 5)}, {"normalized": True}),
    _case("coalesce_tensor", "coalesce_tensor",
          {"Input": [_f(2, 3), _f(4)]}),
    _case("delete_var", "delete_var", {"X": _f(2)}),
    _case("average_accumulates", "average_accumulates",
          dict(_ACC, in_num_accumulates=np.array([3], np.int64),
               in_old_num_accumulates=np.array([2], np.int64),
               in_num_updates=np.array([9], np.int64)),
          {"average_window": 0.5, "max_average_window": 6,
           "min_average_window": 2}),
    _case("average_accumulates_keep", "average_accumulates",
          dict(_ACC, in_num_accumulates=np.array([1], np.int64),
               in_old_num_accumulates=np.array([0], np.int64),
               in_num_updates=np.array([1], np.int64)),
          {"average_window": 0.5, "max_average_window": 100,
           "min_average_window": 10}),
    _case("dgc_clip_by_norm", "dgc_clip_by_norm",
          {"X": _f(4, 3), "current_step": np.array([7.0], np.float32)},
          {"rampup_begin_step": 5.0, "max_norm": 1.0}),
    _case("dgc_clip_by_norm_early", "dgc_clip_by_norm",
          {"X": _f(4, 3), "current_step": np.array([3.0], np.float32)},
          {"rampup_begin_step": 5.0, "max_norm": 1.0}),
    _case("quantize", "quantize", {"Input": _HALF}),
    _case("quantize_scaled", "quantize", {"Input": _HALF / 4},
          {"Scale": 4.0, "Shift": 0.5, "qmax": 7}),
    _case("dequantize", "dequantize",
          {"Input": np.array([-128, -3, 0, 5, 127], np.int8)},
          {"Scale": 3.0, "Shift": 1.0}),
    _case("requantize", "requantize",
          {"Input": np.array([1, 3, 5, -1, -3, 7, 127, -128], np.int8)},
          {"Scale_in": 2.0, "Scale_out": 1.0}),
    _case("requantize_up", "requantize",
          {"Input": np.array([100, -100, 3, -5], np.int8)},
          {"Scale_in": 1.0, "Scale_out": 2.5}),
]


@_family(_EXTRA_CASES)
def test_extra_ops_match_jax(k):
    _check(_EXTRA_CASES, k)


# ---------------------------------------------------------------------------
# the explicit grad, the SelectedRows helpers, the random rules, the marks
# ---------------------------------------------------------------------------

def test_sample_logits_grad_lower_matches_jax():
    """JAX's explicit grad: the cotangent scatter-added back through the
    samples, repeats summed."""
    logits = _f(3, 12)
    samples = np.array([[3, 3, 5, 0, 3], [1, 2, 1, 1, 11], [0, 4, 4, 9, 0]],
                       np.int64)
    g = _f(3, 5)
    jg = jreg._REGISTRY["sample_logits"].grad_lower(
        jreg.LowerContext(), {"Logits": [jnp.asarray(logits)],
                              "__out__Samples": [jnp.asarray(samples)],
                              "SampledLogits@GRAD": [jnp.asarray(g)]}, {})
    tg = treg._REGISTRY["sample_logits"].grad_lower(
        treg.LowerContext(), {"Logits": [torch.from_numpy(logits)],
                              "__out__Samples": [torch.from_numpy(samples)],
                              "SampledLogits@GRAD": [torch.from_numpy(g)]},
        {})
    np.testing.assert_allclose(tg["Logits@GRAD"][0].numpy(),
                               np.asarray(jg["Logits@GRAD"][0]),
                               rtol=OUT_TOL, atol=OUT_TOL)


def _tsr(rows, vals, h):
    return TSR(torch.from_numpy(rows), torch.from_numpy(vals), h)


def _jsr(rows, vals, h):
    return JSR(jnp.asarray(rows), jnp.asarray(vals), h)


def test_selected_rows_helpers_match_jax():
    """merge_selected_rows (repeats summed, sorted rows padded with -1),
    get_tensor_from_selected_rows and split_selected_rows on a
    SelectedRows and on a dense tensor."""
    rows = np.array([7, 2, 7, 0, 2, 7], np.int64)
    vals = _f(6, 3)
    dense = _f(10, 3)
    for op, attrs in (("merge_selected_rows", {}),
                      ("get_tensor_from_selected_rows", {}),
                      ("split_selected_rows",
                       {"height_sections": [3, 5, 2]})):
        for src in ("sparse", "dense"):
            jx = _jsr(rows, vals, 10) if src == "sparse" else \
                jnp.asarray(dense)
            tx = _tsr(rows, vals, 10) if src == "sparse" else \
                torch.from_numpy(dense)
            j = jreg._REGISTRY[op].lower(jreg.LowerContext(), {"X": [jx]},
                                         attrs)["Out"]
            t = treg._REGISTRY[op].lower(treg.LowerContext(), {"X": [tx]},
                                         attrs)["Out"]
            assert len(t) == len(j), (op, src)
            for a, b in zip(t, j):
                if isinstance(b, JSR):
                    assert isinstance(a, TSR) and a.height == b.height
                    np.testing.assert_array_equal(a.rows.numpy(),
                                                  np.asarray(b.rows))
                    a, b = a.values, b.values
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=OUT_TOL, atol=OUT_TOL,
                                           err_msg=f"{op} {src}")


def test_random_crop_and_sampling_id():
    """random_crop: the crop is a window of X inside its bounds, equal
    seeds draw equal offsets; sampling_id: ids in range, never a
    zero-probability column, equal draws for equal seeds, frequencies near
    the probabilities."""
    x = np.arange(4 * 9 * 7, dtype=np.float32).reshape(4, 9, 7)
    crops = [_torch_run("random_crop", {"X": x}, {"shape": [5, 3]},
                        seed=s)["Out"][0].numpy() for s in (0, 0, 1, 2, 3)]
    np.testing.assert_array_equal(crops[0], crops[1])
    starts = set()
    for c in crops:
        assert c.shape == (4, 5, 3)
        r0, c0 = divmod(int(c[0, 0, 0]), 7)
        assert 0 <= r0 <= 4 and 0 <= c0 <= 4
        np.testing.assert_array_equal(c, x[:, r0:r0 + 5, c0:c0 + 3])
        starts.add((r0, c0))
    assert len(starts) > 1
    assert _torch_run("random_crop", {"X": x}, {"shape": [5, 3]},
                      device="meta")["Out"][0].shape == (4, 5, 3)
    p = np.tile(np.array([[0.1, 0.0, 0.6, 0.3]], np.float32), (20000, 1))
    ids = _torch_run("sampling_id", {"X": p}, {})["Out"][0]
    assert ids.dtype == torch.int64 and ids.shape == (20000,)
    assert torch.equal(ids, _torch_run("sampling_id", {"X": p}, {})["Out"][0])
    freq = np.bincount(ids.numpy(), minlength=4) / 20000
    assert freq[1] == 0 and np.abs(freq - p[0]).max() < 0.02


def test_batch_size_like_random_ops():
    """Shape from the input's batch, range and moments, equal seeds."""
    x = _f(5000, 3)
    u = _torch_run("uniform_random_batch_size_like", {"Input": x},
                   {"shape": [-1, 40], "min": -2.0, "max": 3.0})["Out"][0]
    assert u.shape == (5000, 40) and u.dtype == torch.float32
    assert float(u.min()) >= -2.0 and float(u.max()) < 3.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    g = _torch_run("gaussian_random_batch_size_like", {"Input": x},
                   {"shape": [7, -1], "output_dim_idx": 1, "mean": 1.0,
                    "std": 2.0})["Out"][0]
    assert g.shape == (7, 5000)
    assert abs(float(g.mean()) - 1.0) < 0.05 and \
        abs(float(g.std()) - 2.0) < 0.05
    assert torch.equal(g, _torch_run(
        "gaussian_random_batch_size_like", {"Input": x},
        {"shape": [7, -1], "output_dim_idx": 1, "mean": 1.0,
         "std": 2.0})["Out"][0])


def test_sample_logits_sampler_support():
    """The log-uniform sampler: true labels first, negatives in [0, K),
    Probabilities the sampler's q, hits pushed to -1e20, equal draws for
    equal seeds."""
    k, n, s = 50, 64, 8
    logits = _f(n, k)
    labels = _i(k, n, 1)
    attrs = {"num_samples": s}
    a = _torch_run("sample_logits", {"Logits": logits, "Labels": labels},
                   attrs)
    b = _torch_run("sample_logits", {"Logits": logits, "Labels": labels},
                   attrs)
    assert all(torch.equal(x, y) for slot in a for x, y in zip(a[slot],
                                                               b[slot]))
    for out in (a,):
        samples = out["Samples"][0].numpy().astype(np.int64)
        assert samples.shape == (n, 1 + s)
        np.testing.assert_array_equal(samples[:, :1], labels)
        assert samples.min() >= 0 and samples.max() < k
        q = np.log((samples + 2.0) / (samples + 1.0)) / np.log(k + 1.0)
        np.testing.assert_allclose(out["Probabilities"][0].numpy(), q,
                                   rtol=1e-5)
        sl = out["SampledLogits"][0].numpy()
        hit = samples[:, 1:] == labels
        assert (sl[:, 1:][hit] < -1e19).all()
        assert (sl[:, 1:][~hit] > -1e19).all()
        np.testing.assert_array_equal(out["SampledLabels"][0].numpy(), 0)


def test_marks_match_jax():
    """Every op type of the three files carries JAX's marks; the lstm and
    gru aliases JAX's (the originals' marks, the generic grad)."""
    import paddle_tpu.ops.extra_ops as je
    import paddle_tpu.ops.misc_ops as jm
    import paddle_tpu.ops.nn_extra_ops as jn
    ops = [op for op, d in jreg._REGISTRY.items()
           if d.lower is not None and d.lower.__module__ in
           (je.__name__, jm.__name__, jn.__name__)] + ["lstm", "gru"]
    assert len(ops) >= 75
    for op in ops:
        jd, td = jreg._REGISTRY[op], treg._REGISTRY[op]
        for mark in ("no_grad_inputs", "non_diff_outputs", "stateful",
                     "is_optimizer_op", "not_differentiable", "grad_free"):
            assert getattr(td, mark) == getattr(jd, mark), (op, mark)
        assert (td.grad_lower is None) == (jd.grad_lower is None), op
    assert treg._REGISTRY["lstm"].lower is treg._REGISTRY["dynamic_lstm"].lower
    assert treg._REGISTRY["gru"].lower is treg._REGISTRY["dynamic_gru"].lower


def test_sync_batch_norm_data_axis_raises():
    """On one rank sync_batch_norm is batch_norm; a data axis to reduce
    over is ROADMAP A.8a."""
    ctx = treg.LowerContext()
    ctx.spmd_axes = ("dp",)
    ins = {"X": [torch.zeros(2, 3, 2, 2)], "Scale": [torch.ones(3)],
           "Bias": [torch.zeros(3)], "Mean": [torch.zeros(3)],
           "Variance": [torch.ones(3)]}
    with pytest.raises(NotImplementedError, match="A.8a"):
        treg._REGISTRY["sync_batch_norm"].lower(ctx, ins, {})


def test_deformable_conv_zero_offset_is_half_conv():
    """DCNv2's start: zero offsets and sigmoid(0) = 0.5 masks give half a
    plain convolution (torch's conv2d), at a stride and a dilation."""
    x, w = torch.from_numpy(_f(2, 4, 9, 9)), torch.from_numpy(_f(5, 4, 3, 3))
    for s, p, d in ((1, 1, 1), (2, 1, 1), (1, 2, 2)):
        oh = (9 + 2 * p - d * 2 - 1) // s + 1
        out = treg._REGISTRY["deformable_conv"].lower(
            treg.LowerContext(),
            {"Input": [x], "Offset": [torch.zeros(2, 18, oh, oh)],
             "Mask": [torch.full((2, 9, oh, oh), 0.5)], "Filter": [w]},
            {"strides": [s, s], "paddings": [p, p],
             "dilations": [d, d]})["Output"][0]
        ref = 0.5 * torch.nn.functional.conv2d(x, w, stride=s, padding=p,
                                               dilation=d)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_hash_matches_numpy_uint32():
    """hash's 16-bit split products against numpy's wrapping uint32
    arithmetic, for ids that wrap and the largest uint32 words."""
    ids = np.array([[0], [1], [-1], [(1 << 32) - 1], [1 << 40], [12345]],
                   np.int64)

    def mix(v, salt):
        v = (v ^ (v >> np.uint32(16))) * np.uint32(0x7feb352d)
        v = (v ^ (v >> np.uint32(15))) * np.uint32(0x846ca68b + salt)
        return v ^ (v >> np.uint32(16))

    with np.errstate(over="ignore"):
        want = np.stack([mix(np.uint32(2166136261 + i) ^ ids[:, 0]
                             .astype(np.uint32), i) % np.uint32(1 << 31)
                         for i in range(3)], 1)
    got = _torch_run("hash", {"X": ids}, {"num_hash": 3})["Out"][0]
    np.testing.assert_array_equal(got[:, :, 0].numpy(),
                                  want.astype(np.int64))
