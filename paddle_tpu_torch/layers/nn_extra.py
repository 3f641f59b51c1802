"""Layer wrappers for the long-tail ops (reference:
python/paddle/fluid/layers/nn.py — the ~60 functions beyond the core
set in nn.py/math.py/tensor.py).

A copy of `paddle_tpu/layers/nn_extra.py`: the same ops, slots and attrs,
so programs built by either package serialize alike. `layers` star-exports
it last, as JAX's does, so `layers.resize_bilinear`, `resize_nearest`,
`image_resize`, `relu6`, `selu` and the other names here are these
functions (`layers.nn.*` keep layers/nn.py's). As in JAX, `soft_relu` and
`adaptive_pool3d` append op types that no rule registers (they raise
NotImplementedError at build time), and `npair_loss` reaches for
`layers.nn.matmul`, which neither package has (AttributeError).
"""

from __future__ import annotations

from ..framework.layer_helper import LayerHelper

__all__ = [
    "sampling_id", "gru_unit", "tree_conv", "var_conv_2d",
    "resize_trilinear", "beam_search",
    "affine_channel", "affine_grid", "grid_sampler", "row_conv",
    "multiplex", "crop", "pad_constant_like", "selu", "mean_iou",
    "relu6", "brelu", "hard_swish", "soft_relu", "stanh", "maxout",
    "pixel_shuffle", "space_to_depth", "shuffle_channel", "unfold",
    "im2sequence", "temporal_shift",
    "bilinear_tensor_product", "adaptive_pool2d", "adaptive_pool3d",
    "rank_loss", "margin_rank_loss", "bpr_loss", "dice_loss",
    "npair_loss", "teacher_student_sigmoid_loss", "center_loss",
    "sampled_softmax_with_cross_entropy", "hash", "unique",
    "unique_with_counts", "edit_distance", "chunk_eval", "data_norm",
    "continuous_value_model", "fsp_matrix", "similarity_focus",
    "filter_by_instag", "match_matrix_tensor", "random_crop",
    "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
    "get_tensor_from_selected_rows", "merge_selected_rows",
    "lod_reset", "lod_append", "lstm_unit", "dynamic_lstmp",
    "deformable_conv", "psroi_pool", "image_resize",
    "image_resize_short", "resize_bilinear", "resize_nearest",
    "ctc_greedy_decoder", "autoincreased_step_counter", "rank",
]


def _simple(op_type, ins, attrs=None, outs=("Out",), dtype="float32",
            name=None):
    helper = LayerHelper(name or op_type)
    out_map, rets = {}, []
    for slot in outs:
        v = helper.create_variable_for_type_inference(dtype)
        out_map[slot] = [v.name]
        rets.append(v)
    helper.append_op(op_type, ins, out_map, attrs or {})
    return rets[0] if len(rets) == 1 else rets


def _names(*vars_):
    return {k: [v.name] for k, v in vars_ if v is not None}


# -- activations / elementwise ------------------------------------------------

def relu6(x, threshold=6.0, name=None):
    return _simple("relu6", {"X": [x.name]}, {"threshold": threshold})


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _simple("brelu", {"X": [x.name]},
                   {"t_min": t_min, "t_max": t_max})


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    return _simple("hard_swish", {"X": [x.name]},
                   {"threshold": threshold, "scale": scale,
                    "offset": offset})


def soft_relu(x, threshold=40.0, name=None):
    return _simple("soft_relu", {"X": [x.name]},
                   {"threshold": threshold})


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _simple("stanh", {"X": [x.name]},
                   {"scale_a": scale_a, "scale_b": scale_b})


def selu(x, scale=None, alpha=None, name=None):
    attrs = {}
    if scale is not None:
        attrs["scale"] = scale
    if alpha is not None:
        attrs["alpha"] = alpha
    return _simple("selu", {"X": [x.name]}, attrs)


# -- shape / channel shuffles -------------------------------------------------

def multiplex(inputs, index, name=None):
    return _simple("multiplex", {"X": [v.name for v in inputs],
                                 "Ids": [index.name]})


def crop(x, shape=None, offsets=None, name=None):
    ins = {"X": [x.name]}
    attrs = {}
    if isinstance(shape, (list, tuple)):
        attrs["shape"] = list(shape)
    elif shape is not None:
        ins["Y"] = [shape.name]
    if offsets is not None:
        attrs["offsets"] = list(offsets)
    return _simple("crop", ins, attrs)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _simple("pad_constant_like", {"X": [x.name], "Y": [y.name]},
                   {"pad_value": pad_value})


def pixel_shuffle(x, upscale_factor, name=None):
    return _simple("pixel_shuffle", {"X": [x.name]},
                   {"upscale_factor": upscale_factor})


def space_to_depth(x, blocksize, name=None):
    return _simple("space_to_depth", {"X": [x.name]},
                   {"blocksize": blocksize})


def shuffle_channel(x, group, name=None):
    return _simple("shuffle_channel", {"X": [x.name]}, {"group": group})


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]
    return _simple("unfold", {"X": [x.name]},
                   {"kernel_sizes": _pair(kernel_sizes),
                    "strides": _pair(strides),
                    "paddings": _pair(paddings),
                    "dilations": _pair(dilations)}, outs=("Y",))


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]
    return _simple("im2sequence", {"X": [input.name]},
                   {"kernels": _pair(filter_size),
                    "strides": _pair(stride),
                    "paddings": _pair(padding) + _pair(padding)})


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _simple("temporal_shift", {"X": [x.name]},
                   {"seg_num": seg_num, "shift_ratio": shift_ratio})


def maxout(x, groups, name=None):
    return _simple("maxout", {"X": [x.name]}, {"groups": groups})


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper(name or "bilinear_tensor_product")
    w = helper.create_parameter(param_attr, [size, x.shape[-1],
                                             y.shape[-1]])
    ins = {"X": [x.name], "Y": [y.name], "Weight": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [1, size], is_bias=True)
        ins["Bias"] = [b.name]
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("bilinear_tensor_product", ins,
                     {"Out": [out.name]}, {})
    return helper.append_activation(out, act)


def adaptive_pool2d(input, pool_size, pool_type="max",
                    require_index=False, name=None):
    return _simple("adaptive_pool2d", {"X": [input.name]},
                   {"pooled_height": pool_size[0]
                    if isinstance(pool_size, (list, tuple)) else pool_size,
                    "pooled_width": pool_size[1]
                    if isinstance(pool_size, (list, tuple)) else pool_size,
                    "pooling_type": pool_type})


def adaptive_pool3d(input, pool_size, pool_type="max",
                    require_index=False, name=None):
    return _simple("adaptive_pool3d", {"X": [input.name]},
                   {"pooled_sizes": list(pool_size)
                    if isinstance(pool_size, (list, tuple))
                    else [pool_size] * 3,
                    "pooling_type": pool_type})


# -- spatial transformers / conv variants ------------------------------------

def affine_channel(x, scale=None, bias=None, data_layout="NCHW",
                   name=None, act=None):
    from ..initializer import Constant
    helper = LayerHelper(name or "affine_channel")
    c = x.shape[1] if data_layout == "NCHW" else x.shape[-1]
    if scale is None:
        scale = helper.create_parameter(
            None, [c], default_initializer=Constant(1.0))
    if bias is None:
        bias = helper.create_parameter(
            None, [c], is_bias=True, default_initializer=Constant(0.0))
    out = _simple("affine_channel",
                  {"X": [x.name], "Scale": [scale.name],
                   "Bias": [bias.name]},
                  {"data_layout": data_layout})
    return helper.append_activation(out, act)


def affine_grid(theta, out_shape, name=None):
    shape = list(out_shape) if isinstance(out_shape, (list, tuple)) \
        else out_shape
    return _simple("affine_grid", {"Theta": [theta.name]},
                   {"output_shape": shape}, outs=("Output",))


def grid_sampler(x, grid, name=None):
    return _simple("grid_sampler", {"X": [x.name], "Grid": [grid.name]},
                   outs=("Output",))


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    helper = LayerHelper(name or "row_conv")
    filt = helper.create_parameter(
        param_attr, [future_context_size, input.shape[-1]])
    out = _simple("row_conv", {"X": [input.name], "Filter": [filt.name]})
    return helper.append_activation(out, act)


def deformable_conv(input, offset, mask, num_filters, filter_size,
                    stride=1, padding=0, dilation=1, groups=1,
                    deformable_groups=1, im2col_step=1, param_attr=None,
                    bias_attr=None, modulated=True, name=None):
    helper = LayerHelper(name or "deformable_conv")
    ks = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size, filter_size]
    w = helper.create_parameter(
        param_attr, [num_filters, input.shape[1], ks[0], ks[1]])
    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]
    ins = {"Input": [input.name], "Offset": [offset.name],
           "Filter": [w.name]}
    if modulated and mask is not None:
        ins["Mask"] = [mask.name]
    return _simple("deformable_conv", ins,
                   {"strides": _pair(stride), "paddings": _pair(padding),
                    "dilations": _pair(dilation),
                    "deformable_groups": deformable_groups},
                   outs=("Output",))


def psroi_pool(input, rois, output_channels, spatial_scale,
               pooled_height, pooled_width, name=None):
    return _simple("psroi_pool",
                   {"X": [input.name], "ROIs": [rois.name]},
                   {"output_channels": output_channels,
                    "spatial_scale": spatial_scale,
                    "pooled_height": pooled_height,
                    "pooled_width": pooled_width})


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None, align_corners=True,
                 align_mode=1, data_format="NCHW"):
    if out_shape is None and scale is not None:
        out_shape = [int(input.shape[2] * scale),
                     int(input.shape[3] * scale)]
    op = {"BILINEAR": "bilinear_interp",
          "NEAREST": "nearest_interp"}[resample.upper()]
    return _simple(op, {"X": [input.name]},
                   {"out_h": int(out_shape[0]), "out_w": int(out_shape[1]),
                    "align_corners": align_corners,
                    "align_mode": align_mode})


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    align_corners=True, align_mode=1):
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        align_corners=align_corners, align_mode=align_mode)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   align_corners=True):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        align_corners=align_corners)


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    h, w = input.shape[2], input.shape[3]
    short = min(h, w)
    out_shape = [int(h * out_short_len / short),
                 int(w * out_short_len / short)]
    return image_resize(input, out_shape, resample=resample)


# -- losses -------------------------------------------------------------------

def rank_loss(label, left, right, name=None):
    return _simple("rank_loss", {"Label": [label.name],
                                 "Left": [left.name],
                                 "Right": [right.name]})


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    return _simple("margin_rank_loss",
                   {"Label": [label.name], "X1": [left.name],
                    "X2": [right.name]}, {"margin": margin})


def bpr_loss(input, label, name=None):
    return _simple("bpr_loss", {"X": [input.name], "Label": [label.name]})


def dice_loss(input, label, epsilon=1e-5):
    """Composed as in the reference layer (one-hot label overlap)."""
    from . import math as m
    from . import nn as nn_
    from . import tensor as t
    label_oh = nn_.one_hot(label, input.shape[-1])
    inter = m.reduce_sum(m.elementwise_mul(input, label_oh), dim=[-1])
    union = m.elementwise_add(m.reduce_sum(input, dim=[-1]),
                              m.reduce_sum(label_oh, dim=[-1]))
    num = m.scale(inter, scale=2.0)
    den = m.scale(union, scale=1.0, bias=epsilon)
    return m.elementwise_sub(
        t.fill_constant_batch_size_like(num, [-1], "float32", 1.0),
        m.elementwise_div(num, den))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """reference layer composition: cross-entropy over anchor·positiveᵀ
    similarity + l2 regularization on the embeddings."""
    from . import math as m
    from . import nn as nn_
    from . import tensor as t
    sim = nn_.matmul(anchor, positive, transpose_y=True)
    b = labels.shape[0] if labels.shape[0] > 0 else -1
    lab = t.reshape(labels, [-1, 1])
    xent = nn_.softmax_with_cross_entropy(sim, t.cast(lab, "int64"))
    l2 = m.scale(m.elementwise_add(
        m.reduce_sum(m.elementwise_mul(anchor, anchor)),
        m.reduce_sum(m.elementwise_mul(positive, positive))),
        scale=l2_reg * 0.25)
    return m.elementwise_add(nn_.mean(xent), l2)


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _simple("teacher_student_sigmoid_loss",
                   {"X": [input.name], "Label": [label.name]},
                   {"soft_max_up_bound": soft_max_up_bound,
                    "soft_max_lower_bound": soft_max_lower_bound},
                   outs=("Y",))


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True, name=None):
    from . import tensor as t
    helper = LayerHelper(name or "center_loss")
    centers = helper.create_parameter(
        param_attr, [num_classes, input.shape[-1]])
    rate = t.fill_constant([1], "float32", float(alpha))
    loss = helper.create_variable_for_type_inference("float32")
    diff = helper.create_variable_for_type_inference("float32")
    cout = helper.create_variable_for_type_inference("float32")
    helper.append_op("center_loss",
                     {"X": [input.name], "Label": [label.name],
                      "Centers": [centers.name],
                      "CenterUpdateRate": [rate.name]},
                     {"Loss": [loss.name],
                      "SampleCenterDiff": [diff.name],
                      "CentersOut": [cout.name]},
                     {"need_update": update_center})
    return loss


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1, remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """reference layer: sample_logits -> softmax_with_cross_entropy over
    the sampled class subset."""
    from . import nn as nn_
    from . import tensor as t
    helper = LayerHelper("sampled_softmax_with_cross_entropy")
    samples = helper.create_variable_for_type_inference("int64")
    probs = helper.create_variable_for_type_inference("float32")
    sampled_logits = helper.create_variable_for_type_inference("float32")
    sampled_label = helper.create_variable_for_type_inference("int64")
    ins = {"Logits": [logits.name], "Labels": [label.name]}
    if use_customized_samples:
        ins["CustomizedSamples"] = [customized_samples.name]
        ins["CustomizedProbabilities"] = [customized_probabilities.name]
    helper.append_op("sample_logits", ins,
                     {"Samples": [samples.name],
                      "Probabilities": [probs.name],
                      "SampledLogits": [sampled_logits.name],
                      "SampledLabels": [sampled_label.name]},
                     {"num_samples": num_samples,
                      "use_customized_samples": use_customized_samples,
                      "remove_accidental_hits": remove_accidental_hits})
    return nn_.softmax_with_cross_entropy(sampled_logits, sampled_label)


# -- CTR / misc ---------------------------------------------------------------

def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False):
    from . import tensor as t
    helper = LayerHelper(name or "data_norm")
    d = input.shape[-1]
    # batch stat accumulators start at (counts=1e4, sum=0, sq=1e4) as in
    # the reference's summary-style init
    from ..initializer import Constant
    from ..framework.layer_helper import ParamAttr
    bsize = helper.create_parameter(
        ParamAttr(name=f"{helper.name}.batch_size",
                  initializer=Constant(1e4)), [d])
    bsum = helper.create_parameter(
        ParamAttr(name=f"{helper.name}.batch_sum",
                  initializer=Constant(0.0)), [d])
    bsq = helper.create_parameter(
        ParamAttr(name=f"{helper.name}.batch_square_sum",
                  initializer=Constant(1e4)), [d])
    y = helper.create_variable_for_type_inference("float32")
    means = helper.create_variable_for_type_inference("float32")
    scales = helper.create_variable_for_type_inference("float32")
    helper.append_op("data_norm",
                     {"X": [input.name], "BatchSize": [bsize.name],
                      "BatchSum": [bsum.name],
                      "BatchSquareSum": [bsq.name]},
                     {"Y": [y.name], "Means": [means.name],
                      "Scales": [scales.name]}, {"epsilon": epsilon})
    return helper.append_activation(y, act)


def continuous_value_model(input, cvm, use_cvm=True):
    return _simple("cvm", {"X": [input.name], "CVM": [cvm.name]},
                   {"use_cvm": use_cvm}, outs=("Y",))


def fsp_matrix(x, y):
    return _simple("fsp", {"X": [x.name], "Y": [y.name]})


def similarity_focus(input, axis, indexes, name=None):
    return _simple("similarity_focus", {"X": [input.name]},
                   {"axis": axis, "indexes": list(indexes)})


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True,
                     out_val_if_empty=0):
    helper = LayerHelper("filter_by_instag")
    out = helper.create_variable_for_type_inference("float32")
    lw = helper.create_variable_for_type_inference("float32")
    im = helper.create_variable_for_type_inference("int64")
    helper.append_op("filter_by_instag",
                     {"Ins": [ins.name], "Ins_tag": [ins_tag.name],
                      "Filter_tag": [filter_tag.name]},
                     {"Out": [out.name], "LossWeight": [lw.name],
                      "IndexMap": [im.name]}, {})
    return out, lw


def match_matrix_tensor(x, y, channel_num, act=None, param_attr=None,
                        dtype="float32", name=None):
    helper = LayerHelper(name or "match_matrix_tensor")
    d = x.shape[-1]
    w = helper.create_parameter(param_attr, [d, channel_num,
                                             y.shape[-1]], dtype)
    out = helper.create_variable_for_type_inference(dtype)
    tmp = helper.create_variable_for_type_inference(dtype)
    helper.append_op("match_matrix_tensor",
                     {"X": [x.name], "Y": [y.name], "W": [w.name]},
                     {"Out": [out.name], "Tmp": [tmp.name]}, {})
    return helper.append_activation(out, act), tmp


def random_crop(x, shape, seed=None):
    return _simple("random_crop", {"X": [x.name]},
                   {"shape": list(shape)})


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    return _simple("uniform_random_batch_size_like",
                   {"Input": [input.name]},
                   {"shape": list(shape), "input_dim_idx": input_dim_idx,
                    "output_dim_idx": output_dim_idx, "min": min,
                    "max": max}, dtype=dtype)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    return _simple("gaussian_random_batch_size_like",
                   {"Input": [input.name]},
                   {"shape": list(shape), "input_dim_idx": input_dim_idx,
                    "output_dim_idx": output_dim_idx, "mean": mean,
                    "std": std}, dtype=dtype)


def get_tensor_from_selected_rows(x, name=None):
    return _simple("get_tensor_from_selected_rows", {"X": [x.name]})


def merge_selected_rows(x, name=None):
    return _simple("merge_selected_rows", {"X": [x.name]})


def hash(input, hash_size, num_hash=1, name=None):
    return _simple("hash", {"X": [input.name]},
                   {"mod_by": hash_size, "num_hash": num_hash},
                   dtype="int64")


def unique(x, dtype="int32"):
    helper = LayerHelper("unique")
    out = helper.create_variable_for_type_inference(x.dtype)
    index = helper.create_variable_for_type_inference(dtype)
    cnt = helper.create_variable_for_type_inference("int32")
    helper.append_op("unique", {"X": [x.name]},
                     {"Out": [out.name], "Index": [index.name],
                      "Count": [cnt.name]}, {})
    return out, index


def unique_with_counts(x, dtype="int32"):
    helper = LayerHelper("unique_with_counts")
    out = helper.create_variable_for_type_inference(x.dtype)
    index = helper.create_variable_for_type_inference(dtype)
    cnt = helper.create_variable_for_type_inference(dtype)
    helper.append_op("unique_with_counts", {"X": [x.name]},
                     {"Out": [out.name], "Index": [index.name],
                      "Count": [cnt.name]}, {})
    return out, index, cnt


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    helper = LayerHelper("edit_distance")
    ins = {"Hyps": [input.name], "Refs": [label.name]}
    if input_length is not None:
        ins["HypsLength"] = [input_length.name]
    if label_length is not None:
        ins["RefsLength"] = [label_length.name]
    out = helper.create_variable_for_type_inference("float32")
    seq = helper.create_variable_for_type_inference("int64")
    helper.append_op("edit_distance", ins,
                     {"Out": [out.name], "SequenceNum": [seq.name]},
                     {"normalized": normalized})
    return out, seq


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    helper = LayerHelper("chunk_eval")
    ins = {"Inference": [input.name], "Label": [label.name]}
    if seq_length is not None:
        ins["SeqLength"] = [seq_length.name]
    outs = {}
    rets = []
    for slot, dt in (("Precision", "float32"), ("Recall", "float32"),
                     ("F1-Score", "float32"), ("NumInferChunks", "int64"),
                     ("NumLabelChunks", "int64"),
                     ("NumCorrectChunks", "int64")):
        v = helper.create_variable_for_type_inference(dt)
        outs[slot] = [v.name]
        rets.append(v)
    helper.append_op("chunk_eval", ins, outs,
                     {"chunk_scheme": chunk_scheme,
                      "num_chunk_types": num_chunk_types})
    return tuple(rets)


def mean_iou(input, label, num_classes):
    helper = LayerHelper("mean_iou")
    miou = helper.create_variable_for_type_inference("float32")
    wrong = helper.create_variable_for_type_inference("int32")
    correct = helper.create_variable_for_type_inference("int32")
    helper.append_op("mean_iou",
                     {"Predictions": [input.name], "Labels": [label.name]},
                     {"OutMeanIou": [miou.name], "OutWrong": [wrong.name],
                      "OutCorrect": [correct.name]},
                     {"num_classes": num_classes})
    return miou, wrong, correct


def lod_reset(x, y=None, target_lod=None):
    ins = {"X": [x.name]}
    attrs = {}
    if y is not None:
        ins["Y"] = [y.name]
    if target_lod is not None:
        attrs["target_lod"] = list(target_lod)
    return _simple("lod_reset", ins, attrs)


def lod_append(x, level):
    return lod_reset(x)


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """reference layer: fc([x, h]) -> lstm_unit op."""
    from . import nn as nn_
    from . import tensor as t
    d = cell_t_prev.shape[-1]
    concat = t.concat([x_t, hidden_t_prev], axis=1)
    gates = nn_.fc(concat, size=4 * d, param_attr=param_attr,
                   bias_attr=bias_attr)
    helper = LayerHelper(name or "lstm_unit")
    h = helper.create_variable_for_type_inference("float32")
    c = helper.create_variable_for_type_inference("float32")
    helper.append_op("lstm_unit",
                     {"X": [gates.name], "C_prev": [cell_t_prev.name]},
                     {"H": [h.name], "C": [c.name]},
                     {"forget_bias": forget_bias})
    return h, c


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=False, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    helper = LayerHelper(name or "dynamic_lstmp")
    d = size // 4
    w = helper.create_parameter(param_attr, [proj_size, size], dtype)
    pw = helper.create_parameter(None, [d, proj_size], dtype)
    ins = {"Input": [input.name], "Weight": [w.name],
           "ProjWeight": [pw.name]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [1, size], is_bias=True)
        ins["Bias"] = [b.name]
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    helper.append_op("lstmp", ins,
                     {"Projection": [proj.name], "Cell": [cell.name]},
                     {"gate_activation": gate_activation,
                      "cell_activation": cell_activation,
                      "candidate_activation": candidate_activation,
                      "proj_activation": proj_activation})
    return proj, cell


def ctc_greedy_decoder(input, blank, input_length=None, name=None):
    """argmax over classes then ctc_align (reference layer composition)."""
    from . import tensor as t
    helper = LayerHelper(name or "ctc_greedy_decoder")
    am = t.argmax(input, axis=-1)
    ins = {"Input": [am.name]}
    if input_length is not None:
        ins["InputLength"] = [input_length.name]
    out = helper.create_variable_for_type_inference("int64")
    ln = helper.create_variable_for_type_inference("int32")
    helper.append_op("ctc_align", ins,
                     {"Output": [out.name], "OutputLength": [ln.name]},
                     {"blank": blank, "merge_repeated": True})
    return out, ln


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """reference layers/nn.py autoincreased_step_counter: a persistable
    counter incremented IN PLACE each run; first read returns `begin`."""
    from ..framework.layer_helper import ParamAttr
    from ..initializer import Constant
    helper = LayerHelper(counter_name or "step_counter")
    counter = helper.create_parameter(
        ParamAttr(name=f"{helper.name}.counter",
                  initializer=Constant(float(begin - step)),
                  trainable=False), [1], dtype="int64")
    counter.stop_gradient = True
    helper.append_op("increment", {"X": [counter.name]},
                     {"Out": [counter.name]}, {"step": float(step)})
    return counter


def rank(input):
    from . import tensor as t
    return t.fill_constant([1], "int32", len(input.shape))


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    """reference: layers/nn.py sampling_id — sample a column index per row
    of a probability matrix (int64 out; dtype kw kept for signature
    parity)."""
    return _simple("sampling_id", {"X": [x.name]}, {"seed": int(seed)},
                   dtype="int64")


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """reference: layers/nn.py gru_unit — one GRU step.  `size` is
    3 * hidden_dim (fluid convention); returns (hidden, reset_hidden_prev,
    gate)."""
    helper = LayerHelper("gru_unit")
    d = size // 3
    w = helper.create_parameter(param_attr, [d, d * 3], input.dtype)
    ins = {"Input": [input.name], "HiddenPrev": [hidden.name],
           "Weight": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [1, d * 3], input.dtype,
                                    is_bias=True)
        ins["Bias"] = [b.name]
    outs = {}
    rets = []
    for slot in ("Hidden", "ResetHiddenPrev", "Gate"):
        v = helper.create_variable_for_type_inference(input.dtype)
        outs[slot] = [v.name]
        rets.append(v)
    helper.append_op("gru_unit", ins, outs,
                     {"activation": activation,
                      "gate_activation": gate_activation,
                      "origin_mode": bool(origin_mode)})
    return tuple(rets)


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    """reference: layers/nn.py tree_conv (tree_conv_op.h TBCNN)."""
    helper = LayerHelper(name or "tree_conv")
    f = int(nodes_vector.shape[-1])
    w = helper.create_parameter(param_attr,
                                [f, 3, output_size, num_filters],
                                nodes_vector.dtype)
    out = helper.create_variable_for_type_inference(nodes_vector.dtype)
    helper.append_op("tree_conv",
                     {"NodesVector": [nodes_vector.name],
                      "EdgeSet": [edge_set.name], "Filter": [w.name]},
                     {"Out": [out.name]}, {"max_depth": int(max_depth)})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters],
                                    nodes_vector.dtype, is_bias=True)
        out = helper.append_bias_op(out, b, dim_start=3)
    return helper.append_activation(out, act)


def var_conv_2d(input, row, col, input_channel, output_channel, filter_size,
                stride=1, param_attr=None, act=None, name=None):
    """reference: layers/nn.py var_conv_2d (var_conv_2d_op.cc); per-sample
    valid heights/widths ride in row/col instead of LoD."""
    helper = LayerHelper(name or "var_conv_2d")
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    w = helper.create_parameter(
        param_attr,
        [output_channel, input_channel * filter_size[0] * filter_size[1]],
        input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    col_out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("var_conv_2d",
                     {"X": [input.name], "W": [w.name],
                      "ROW": [row.name], "COLUMN": [col.name]},
                     {"Out": [out.name], "Col": [col_out.name]},
                     {"InputChannel": int(input_channel),
                      "OutputChannel": int(output_channel),
                      "KernelH": int(filter_size[0]),
                      "KernelW": int(filter_size[1]),
                      "StrideH": int(stride), "StrideW": int(stride)})
    return helper.append_activation(out, act)


def resize_trilinear(input, out_shape=None, scale=None, name=None,
                     actual_shape=None, align_corners=True, align_mode=1,
                     data_format="NCDHW"):
    """reference: layers/nn.py resize_trilinear (interpolate_op.cc)."""
    if out_shape is None:
        if scale is None:
            raise ValueError("resize_trilinear needs out_shape or scale")
        out_shape = [int(input.shape[2] * scale),
                     int(input.shape[3] * scale),
                     int(input.shape[4] * scale)]
    return _simple("trilinear_interp", {"X": [input.name]},
                   {"out_d": int(out_shape[0]), "out_h": int(out_shape[1]),
                    "out_w": int(out_shape[2]),
                    "align_corners": align_corners,
                    "align_mode": align_mode}, dtype=input.dtype)


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """reference: layers/nn.py beam_search (beam_search_op.cc). Dense
    form: pre_ids/pre_scores [b, beam], scores [b, beam, V] (log-probs,
    already accumulated when is_accumulated); `ids` accepted for signature
    parity (the dense op selects straight from `scores`)."""
    helper = LayerHelper(name or "beam_search")
    sel_ids = helper.create_variable_for_type_inference("int64")
    sel_scores = helper.create_variable_for_type_inference("float32")
    parent = helper.create_variable_for_type_inference("int64")
    helper.append_op("beam_search",
                     {"pre_ids": [pre_ids.name],
                      "pre_scores": [pre_scores.name],
                      "scores": [scores.name]},
                     {"selected_ids": [sel_ids.name],
                      "selected_scores": [sel_scores.name],
                      "parent_idx": [parent.name]},
                     {"beam_size": int(beam_size), "end_id": int(end_id),
                      "level": int(level),
                      "is_accumulated": bool(is_accumulated)})
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores
