"""NN layers: fc (one input or a list), embedding, the convolutions
(conv2d, conv2d_transpose, conv3d, conv3d_transpose), pool2d, pool3d, the
norms (batch, layer, group, instance, lrn, spectral), dropout, the
activation wrappers, prelu, the losses (softmax_with_cross_entropy,
cross_entropy, sigmoid_cross_entropy_with_logits, square_error_cost,
mse_loss, huber_loss, smooth_l1, kldiv_loss, log_loss), label_smooth,
cos_sim, resize_bilinear and resize_nearest, topk, accuracy, one_hot,
fused_attention, add_position_encoding, and the metric and loss layers
auc, precision_recall, warpctc, linear_chain_crf, crf_decoding, nce,
hsigmoid.

Copied from `paddle_tpu/layers/nn.py`: the same op types, slots, attrs and
parameter initializers, and the same order of var creation, so programs
built by either DSL serialize alike and carry parameters across by name.
`resize_bilinear`/`resize_nearest` are this file's; the JAX package's
`layers` namespace exports `layers/nn_extra.py`'s in their place.
"""

import numpy as np

from ..framework.core import unique_name
from ..framework.layer_helper import LayerHelper
from ..initializer import Constant, Normal, Xavier

__all__ = ["conv3d_transpose",
           "fc", "embedding", "conv2d", "conv2d_transpose", "pool2d",
           "batch_norm", "layer_norm", "group_norm", "instance_norm",
           "dropout", "softmax", "log_softmax", "relu", "sigmoid", "tanh",
           "gelu", "leaky_relu", "elu", "softplus", "swish", "hard_sigmoid",
           "exp", "log", "sqrt", "square", "abs", "pow", "cross_entropy",
           "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
           "square_error_cost", "huber_loss", "kldiv_loss", "smooth_l1",
           "accuracy", "auc", "precision_recall", "topk", "one_hot", "lrn",
           "prelu", "mse_loss",
           "label_smooth", "fused_attention", "warpctc",
           "linear_chain_crf", "crf_decoding", "nce", "hsigmoid",
           "log_loss", "cos_sim", "resize_bilinear", "resize_nearest",
           "add_position_encoding", "conv3d", "pool3d", "spectral_norm"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected (reference: layers/nn.py:224). input may be a list:
    one weight and one mul an input, the products summed."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_outs = []
    for inp in inputs:
        in_features = 1
        for d in inp.shape[num_flatten_dims:]:
            in_features *= int(d)
        w = helper.create_parameter(param_attr, [in_features, size],
                                    inp.dtype)
        out = helper.create_variable_for_type_inference(inp.dtype)
        helper.append_op("mul", {"X": [inp.name], "Y": [w.name]},
                         {"Out": [out.name]},
                         {"x_num_col_dims": num_flatten_dims,
                          "y_num_col_dims": 1})
        mul_outs.append(out)
    if len(mul_outs) == 1:
        pre_bias = mul_outs[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            mul_outs[0].dtype)
        helper.append_op("sum", {"X": [o.name for o in mul_outs]},
                         {"Out": [pre_bias.name]})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], pre_bias.dtype,
                                    is_bias=True)
        pre_bias = helper.append_bias_op(pre_bias, b,
                                         dim_start=num_flatten_dims)
    return helper.append_activation(pre_bias, act)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", name=None):
    """reference: layers/nn.py:448 (lookup_table)."""
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, list(size), dtype,
                                default_initializer=Xavier())
    out = helper.create_variable_for_type_inference(dtype)
    if padding_idx is None:
        pad = -1  # kNoPadding sentinel, as in the reference
    elif padding_idx < 0:
        pad = int(size[0]) + padding_idx
    else:
        pad = padding_idx
    helper.append_op("lookup_table", {"W": [w.name], "Ids": [input.name]},
                     {"Out": [out.name]},
                     {"padding_idx": pad, "is_sparse": bool(is_sparse)})
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None,
           data_format="NCHW"):
    """reference: layers/nn.py:2103 (+ data_format NHWC; filter params stay
    OIHW either way)."""
    helper = LayerHelper("conv2d", name=name)
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    c_axis = 3 if data_format == "NHWC" else 1
    c_in = int(input.shape[c_axis])
    w_shape = [num_filters, c_in // groups] + list(filter_size)
    fan_in = (c_in // groups) * filter_size[0] * filter_size[1]
    std = (2.0 / fan_in) ** 0.5
    w = helper.create_parameter(param_attr, w_shape, input.dtype,
                                default_initializer=Normal(0.0, std))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv2d",
                     {"Input": [input.name], "Filter": [w.name]},
                     {"Output": [out.name]},
                     {"strides": stride, "paddings": padding,
                      "dilations": dilation, "groups": groups,
                      "data_format": data_format})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        out = helper.append_bias_op(out, b, dim_start=c_axis)
    return helper.append_activation(out, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, name=None, data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    if isinstance(pool_size, int):
        pool_size = [pool_size, pool_size]
    if isinstance(pool_stride, int):
        pool_stride = [pool_stride, pool_stride]
    if isinstance(pool_padding, int):
        pool_padding = [pool_padding, pool_padding]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pool2d", {"X": [input.name]}, {"Out": [out.name]},
                     {"pooling_type": pool_type, "ksize": pool_size,
                      "strides": pool_stride, "paddings": pool_padding,
                      "global_pooling": global_pooling,
                      "ceil_mode": ceil_mode, "exclusive": exclusive,
                      "data_format": data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               moving_mean_name=None, moving_variance_name=None, name=None):
    """reference: layers/nn.py:3156. Running stats are non-trainable params
    updated by the op (MeanOut/VarianceOut alias them)."""
    helper = LayerHelper("batch_norm", name=name)
    c = int(input.shape[1] if data_layout == "NCHW" else input.shape[-1])
    scale = helper.create_parameter(param_attr, [c], input.dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr, [c], input.dtype, is_bias=True)

    def _stat_param(name_hint, fill):
        nm = name_hint or unique_name(f"{helper.name}.{fill}")
        p = helper.block.create_parameter(name=nm, shape=[c],
                                          dtype=input.dtype, trainable=False)
        sb = helper.startup_program.global_block
        sb.create_var(name=nm, shape=[c], dtype=input.dtype, persistable=True,
                      stop_gradient=True)
        Constant(1.0 if fill == "variance" else 0.0)(p, sb)
        return p

    mean = _stat_param(moving_mean_name, "mean")
    var = _stat_param(moving_variance_name, "variance")

    y = helper.create_variable_for_type_inference(input.dtype)
    saved_mean = helper.create_variable_for_type_inference(input.dtype, True)
    saved_var = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(
        "batch_norm",
        {"X": [input.name], "Scale": [scale.name], "Bias": [bias.name],
         "Mean": [mean.name], "Variance": [var.name]},
        {"Y": [y.name], "MeanOut": [mean.name], "VarianceOut": [var.name],
         "SavedMean": [saved_mean.name], "SavedVariance": [saved_var.name]},
        {"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
         "data_layout": data_layout})
    return helper.append_activation(y, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """reference: layers/nn.py:3483."""
    helper = LayerHelper("layer_norm", name=name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    ins = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(param_attr, norm_shape, input.dtype,
                                    default_initializer=Constant(1.0))
        ins["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(bias_attr, norm_shape, input.dtype,
                                    is_bias=True)
        ins["Bias"] = [b.name]
    y = helper.create_variable_for_type_inference(input.dtype)
    m = helper.create_variable_for_type_inference(input.dtype, True)
    v = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("layer_norm", ins,
                     {"Y": [y.name], "Mean": [m.name], "Variance": [v.name]},
                     {"begin_norm_axis": begin_norm_axis,
                      "epsilon": epsilon})
    return helper.append_activation(y, act)


def fused_attention(q, k, v, bias_k=None, causal=False, sm_scale=0.0,
                    cp_axis="", seq_parallel="ring", impl="",
                    batch_axis="dp", name=None):
    """Fused multi-head attention over (b, s, n, d) q/k/v; lowers to the
    Hopper flash kernels on CUDA (ops/flash_attention.py)."""
    helper = LayerHelper("fused_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    lse = helper.create_variable_for_type_inference("float32", True)
    ins = {"Q": [q.name], "K": [k.name], "V": [v.name]}
    if bias_k is not None:
        ins["BiasK"] = [bias_k.name]
    helper.append_op("fused_attention", ins,
                     {"Out": [out.name], "Lse": [lse.name]},
                     {"causal": causal, "sm_scale": float(sm_scale),
                      "cp_axis": cp_axis, "seq_parallel": seq_parallel,
                      "impl": impl, "batch_axis": batch_axis})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None,
            dropout_implementation="downgrade_in_infer", name=None):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8", True)
    helper.append_op("dropout", {"X": [x.name]},
                     {"Out": [out.name], "Mask": [mask.name]},
                     {"dropout_prob": dropout_prob, "is_test": is_test,
                      "seed": seed or 0,
                      "dropout_implementation": dropout_implementation})
    return out


def _unary(op_type, x, attrs=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, {"X": [x.name]}, {"Out": [out.name]},
                     attrs or {})
    return out


def relu(x, name=None):
    return _unary("relu", x, name=name)


def sigmoid(x, name=None):
    return _unary("sigmoid", x, name=name)


def tanh(x, name=None):
    return _unary("tanh", x, name=name)


def sqrt(x, name=None):
    return _unary("sqrt", x, name=name)


def square(x, name=None):
    return _unary("square", x, name=name)


def gelu(x, approximate=False, name=None):
    return _unary("gelu", x, {"approximate": approximate}, name)


def softmax(x, axis=-1, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("softmax", {"X": [x.name]}, {"Out": [out.name]},
                     {"axis": axis})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("top_k", {"X": [input.name]},
                     {"Out": [values.name], "Indices": [indices.name]},
                     {"k": k})
    return values, indices


def accuracy(input, label, k=1, name=None):
    """reference: layers/metric_op.py — topk + accuracy op."""
    helper = LayerHelper("accuracy", name=name)
    values, indices = topk(input, k)
    acc = helper.create_variable_for_type_inference("float32", True)
    correct = helper.create_variable_for_type_inference("int32", True)
    total = helper.create_variable_for_type_inference("int32", True)
    helper.append_op("accuracy",
                     {"Out": [values.name], "Indices": [indices.name],
                      "Label": [label.name]},
                     {"Accuracy": [acc.name], "Correct": [correct.name],
                      "Total": [total.name]})
    return acc


def one_hot(input, depth, name=None):
    helper = LayerHelper("one_hot", name=name)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot", {"X": [input.name]}, {"Out": [out.name]},
                     {"depth": depth})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False, name=None):
    helper = LayerHelper("softmax_with_cross_entropy", name=name)
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     {"Logits": [logits.name], "Label": [label.name]},
                     {"Softmax": [softmax_out.name], "Loss": [loss.name]},
                     {"soft_label": soft_label, "ignore_index": ignore_index,
                      "axis": axis})
    if return_softmax:
        return loss, softmax_out
    return loss


def square_error_cost(input, label, name=None):
    helper = LayerHelper("square_error_cost", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square_error_cost",
                     {"X": [input.name], "Label": [label.name]},
                     {"Out": [out.name]})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    """reference: layers/nn.py log_loss — binary cross-entropy on
    probabilities."""
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("log_loss",
                     {"Predicted": [input.name], "Labels": [label.name]},
                     {"Loss": [out.name]}, {"epsilon": epsilon})
    return out


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    """reference: layers/nn.py add_position_encoding (sinusoidal PE)."""
    helper = LayerHelper("add_position_encoding", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("add_position_encoding", {"X": [input.name]},
                     {"Out": [out.name]}, {"alpha": alpha, "beta": beta})
    return out


def auc(input, label, curve="ROC", num_thresholds=2 ** 12 - 1, topk=1,
        slide_steps=1, name=None):
    """Streaming in-graph AUC (reference: layers/metric_op.py auc,
    metrics/auc_op.h). Creates persistable StatPos/StatNeg accumulators
    updated in place every step. Returns (auc_out, [stat_pos, stat_neg])."""
    helper = LayerHelper("auc", name=name)
    buckets = num_thresholds + 1
    rows = slide_steps if slide_steps > 0 else 1
    stat_pos = helper.create_global_state_var(
        "auc_stat_pos", [rows, buckets], "int64")
    stat_neg = helper.create_global_state_var(
        "auc_stat_neg", [rows, buckets], "int64")
    auc_out = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(
        "auc",
        {"Predict": [input.name], "Label": [label.name],
         "StatPos": [stat_pos.name], "StatNeg": [stat_neg.name]},
        {"AUC": [auc_out.name], "StatPosOut": [stat_pos.name],
         "StatNegOut": [stat_neg.name]},
        {"curve": curve, "num_thresholds": num_thresholds,
         "slide_steps": slide_steps}, infer_shape=False)
    return auc_out, [stat_pos, stat_neg]


def precision_recall(max_probs, indices, labels, class_number, weights=None,
                     name=None):
    """Streaming per-class precision/recall/F1 (reference:
    metrics/precision_recall_op.h). Returns (batch_metrics [6],
    accum_metrics [6], accum_states [C, 4])."""
    helper = LayerHelper("precision_recall", name=name)
    states = helper.create_global_state_var(
        "pr_states", [class_number, 4], "float32")
    batch_m = helper.create_variable_for_type_inference("float32", True)
    accum_m = helper.create_variable_for_type_inference("float32", True)
    inputs = {"MaxProbs": [max_probs.name], "Indices": [indices.name],
              "Labels": [labels.name], "StatesInfo": [states.name]}
    if weights is not None:
        inputs["Weights"] = [weights.name]
    helper.append_op(
        "precision_recall", inputs,
        {"BatchMetrics": [batch_m.name], "AccumMetrics": [accum_m.name],
         "AccumStatesInfo": [states.name]},
        {"class_number": class_number}, infer_shape=False)
    return batch_m, accum_m, states


def warpctc(input, label, input_length, label_length, blank=0,
            norm_by_times=False, name=None):
    """CTC loss (reference: layers/nn.py warpctc; dense-tensor form with
    explicit lengths instead of LoD)."""
    helper = LayerHelper("warpctc", name=name)
    loss = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        "warpctc",
        {"Logits": [input.name], "Label": [label.name],
         "LogitsLength": [input_length.name],
         "LabelLength": [label_length.name]},
        {"Loss": [loss.name]}, {"blank": blank,
                                "norm_by_times": norm_by_times})
    return loss


def linear_chain_crf(input, label, length, param_attr=None, name=None):
    """CRF negative log-likelihood (reference: layers/nn.py
    linear_chain_crf). Creates the [(C+2), C] transition parameter; returns
    the per-sequence NLL [b, 1]."""
    helper = LayerHelper("linear_chain_crf", name=name)
    c = input.shape[-1]
    trans = helper.create_parameter(param_attr, [c + 2, c], "float32")
    ll = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        "linear_chain_crf",
        {"Emission": [input.name], "Transition": [trans.name],
         "Label": [label.name], "Length": [length.name]},
        {"LogLikelihood": [ll.name]})
    from .math import scale as _scale
    return _scale(ll, scale=-1.0), trans


def crf_decoding(input, transition, length, name=None):
    """Viterbi decode with a trained transition param (reference:
    layers/nn.py crf_decoding)."""
    helper = LayerHelper("crf_decoding", name=name)
    path = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        "crf_decoding",
        {"Emission": [input.name], "Transition": [transition.name],
         "Length": [length.name]},
        {"ViterbiPath": [path.name]})
    return path


def nce(input, label, num_total_classes, num_neg_samples=10,
        param_attr=None, bias_attr=None, name=None, seed=0,
        sampler="uniform"):
    """reference: layers/nn.py nce."""
    helper = LayerHelper("nce", name=name)
    d = input.shape[-1]
    w = helper.create_parameter(param_attr, [num_total_classes, d],
                                input.dtype)
    ins = {"Input": [input.name], "Weight": [w.name],
           "Label": [label.name]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_total_classes],
                                    input.dtype, is_bias=True)
        ins["Bias"] = [b.name]
    cost = helper.create_variable_for_type_inference("float32")
    negs = helper.create_variable_for_type_inference("int32")
    helper.append_op("nce", ins,
                     {"Cost": [cost.name], "Negatives": [negs.name]},
                     {"num_neg_samples": num_neg_samples, "seed": seed,
                      "sampler": sampler})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """reference: layers/nn.py hsigmoid (default complete binary tree)."""
    helper = LayerHelper("hsigmoid", name=name)
    d = input.shape[-1]
    w = helper.create_parameter(param_attr, [num_classes - 1, d],
                                input.dtype)
    ins = {"X": [input.name], "W": [w.name], "Label": [label.name]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_classes - 1],
                                    input.dtype, is_bias=True)
        ins["Bias"] = [b.name]
    cost = helper.create_variable_for_type_inference("float32")
    helper.append_op("hierarchical_sigmoid", ins, {"Cost": [cost.name]},
                     {"num_classes": num_classes})
    return cost


def conv2d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     dilation=1, groups=1, param_attr=None, bias_attr=None,
                     act=None, name=None):
    helper = LayerHelper("conv2d_transpose", name=name)
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    c_in = int(input.shape[1])
    w_shape = [c_in, num_filters // groups] + list(filter_size)
    w = helper.create_parameter(param_attr, w_shape, input.dtype,
                                default_initializer=Xavier())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv2d_transpose",
                     {"Input": [input.name], "Filter": [w.name]},
                     {"Output": [out.name]},
                     {"strides": stride, "paddings": padding,
                      "dilations": dilation, "groups": groups})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        out = helper.append_bias_op(out, b, dim_start=1)
    return helper.append_activation(out, act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, name=None):
    helper = LayerHelper("group_norm", name=name)
    c = int(input.shape[1])
    ins = {"X": [input.name]}
    if param_attr is not False:
        s = helper.create_parameter(param_attr, [c], input.dtype,
                                    default_initializer=Constant(1.0))
        ins["Scale"] = [s.name]
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [c], input.dtype, is_bias=True)
        ins["Bias"] = [b.name]
    y = helper.create_variable_for_type_inference(input.dtype)
    m = helper.create_variable_for_type_inference(input.dtype, True)
    v = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("group_norm", ins,
                     {"Y": [y.name], "Mean": [m.name], "Variance": [v.name]},
                     {"groups": groups, "epsilon": epsilon})
    return helper.append_activation(y, act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm", name=name)
    c = int(input.shape[1])
    ins = {"X": [input.name]}
    if param_attr is not False:
        s = helper.create_parameter(param_attr, [c], input.dtype,
                                    default_initializer=Constant(1.0))
        ins["Scale"] = [s.name]
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [c], input.dtype, is_bias=True)
        ins["Bias"] = [b.name]
    y = helper.create_variable_for_type_inference(input.dtype)
    m = helper.create_variable_for_type_inference(input.dtype, True)
    v = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("instance_norm", ins,
                     {"Y": [y.name], "SavedMean": [m.name],
                      "SavedVariance": [v.name]}, {"epsilon": epsilon})
    return y


def leaky_relu(x, alpha=0.02, name=None):
    return _unary("leaky_relu", x, {"alpha": alpha}, name)


def elu(x, alpha=1.0, name=None):
    return _unary("elu", x, {"alpha": alpha}, name)


def softplus(x, name=None):
    return _unary("softplus", x, name=name)


def swish(x, beta=1.0, name=None):
    return _unary("swish", x, {"beta": beta}, name)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _unary("hard_sigmoid", x, {"slope": slope, "offset": offset}, name)


def exp(x, name=None):
    return _unary("exp", x, name=name)


def log(x, name=None):
    return _unary("log", x, name=name)


def abs(x, name=None):
    return _unary("abs", x, name=name)


def pow(x, factor=1.0, name=None):
    return _unary("pow", x, {"factor": factor}, name)


def log_softmax(x, axis=-1, name=None):
    return _unary("log_softmax", x, {"axis": axis}, name)


def lrn(x, n=5, k=2.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mid = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("lrn", {"X": [x.name]},
                     {"Out": [out.name], "MidOut": [mid.name]},
                     {"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    helper = LayerHelper("prelu", name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [int(x.shape[1])]
    else:
        alpha_shape = [int(d) for d in x.shape[1:]]
    alpha = helper.create_parameter(param_attr, alpha_shape, x.dtype,
                                    default_initializer=Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("prelu", {"X": [x.name], "Alpha": [alpha.name]},
                     {"Out": [out.name]}, {"mode": mode})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  name=None):
    helper = LayerHelper("cross_entropy", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy",
                     {"X": [input.name], "Label": [label.name]},
                     {"Y": [out.name]},
                     {"soft_label": soft_label, "ignore_index": ignore_index})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     {"X": [x.name], "Label": [label.name]},
                     {"Out": [out.name]},
                     {"ignore_index": ignore_index, "normalize": normalize})
    return out


def mse_loss(input, label, name=None):
    from .math import reduce_mean
    return reduce_mean(square_error_cost(input, label, name))


def huber_loss(input, label, delta=1.0, name=None):
    helper = LayerHelper("huber_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    res = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("huber_loss",
                     {"X": [input.name], "Y": [label.name]},
                     {"Out": [out.name], "Residual": [res.name]},
                     {"delta": delta})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=1.0,
              name=None):
    helper = LayerHelper("smooth_l1_loss", name=name)
    ins = {"X": [x.name], "Y": [y.name]}
    if inside_weight is not None:
        ins["InsideWeight"] = [inside_weight.name]
    if outside_weight is not None:
        ins["OutsideWeight"] = [outside_weight.name]
    out = helper.create_variable_for_type_inference(x.dtype)
    diff = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("smooth_l1_loss", ins,
                     {"Out": [out.name], "Diff": [diff.name]},
                     {"sigma": sigma})
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("kldiv_loss",
                     {"X": [x.name], "Target": [target.name]},
                     {"Loss": [out.name]}, {"reduction": reduction})
    return out


def label_smooth(label, epsilon=0.1, name=None):
    from .math import scale
    k = int(label.shape[-1])
    return scale(label, scale=1.0 - epsilon, bias=epsilon / k,
                 bias_after_scale=True)


def cos_sim(X, Y, name=None):
    """reference: layers/nn.py cos_sim."""
    helper = LayerHelper("cos_sim", name=name)
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op("cos_sim", {"X": [X.name], "Y": [Y.name]},
                     {"Out": [out.name], "XNorm": [xn.name],
                      "YNorm": [yn.name]})
    return out


def resize_bilinear(input, out_shape=None, scale=None, align_corners=True,
                    name=None):
    """reference: layers/nn.py resize_bilinear."""
    helper = LayerHelper("resize_bilinear", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs = {"align_corners": align_corners}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op("bilinear_interp", {"X": [input.name]},
                     {"Out": [out.name]}, attrs)
    return out


def resize_nearest(input, out_shape=None, scale=None, align_corners=True,
                   name=None):
    helper = LayerHelper("resize_nearest", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs = {"align_corners": align_corners}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op("nearest_interp", {"X": [input.name]},
                     {"Out": [out.name]}, attrs)
    return out


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None):
    """reference: layers/nn.py conv3d (NCDHW)."""
    helper = LayerHelper("conv3d", name=name)
    def _3(v):
        return [v, v, v] if isinstance(v, int) else list(v)
    filter_size = _3(filter_size)
    c_in = int(input.shape[1])
    w_shape = [num_filters, c_in // groups] + filter_size
    fan_in = (c_in // groups) * int(np.prod(filter_size))
    w = helper.create_parameter(param_attr, w_shape, input.dtype,
                                default_initializer=Normal(
                                    0.0, (2.0 / fan_in) ** 0.5))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv3d", {"Input": [input.name], "Filter": [w.name]},
                     {"Output": [out.name]},
                     {"strides": _3(stride), "paddings": _3(padding),
                      "dilations": _3(dilation), "groups": groups})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        out = helper.append_bias_op(out, b, dim_start=1)
    return helper.append_activation(out, act)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, name=None):
    helper = LayerHelper("pool3d", name=name)
    def _3(v):
        return [v, v, v] if isinstance(v, int) else list(v)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pool3d", {"X": [input.name]}, {"Out": [out.name]},
                     {"pooling_type": pool_type, "ksize": _3(pool_size),
                      "strides": _3(pool_stride),
                      "paddings": _3(pool_padding),
                      "global_pooling": global_pooling,
                      "ceil_mode": ceil_mode, "exclusive": exclusive})
    return out


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """reference: layers/nn.py spectral_norm — creates the persistent U/V
    power-iteration state and returns the normalized weight."""
    helper = LayerHelper("spectral_norm", name=name)
    h = int(weight.shape[dim])
    ww = 1
    for i, d in enumerate(weight.shape):
        if i != dim:
            ww *= int(d)
    def _state(suffix, size):
        # the batch_norm running-stat pattern: non-trainable persistent
        # state created directly on the block + initialized in startup
        nm = unique_name(f"{weight.name}.{suffix}")
        p = helper.block.create_parameter(name=nm, shape=[size],
                                          dtype=weight.dtype,
                                          trainable=False)
        sb = helper.startup_program.global_block
        sb.create_var(name=nm, shape=[size], dtype=weight.dtype,
                      persistable=True, stop_gradient=True)
        Normal(0.0, 1.0)(p, sb)
        return p

    u = _state("sn_u", h)
    v = _state("sn_v", ww)
    out = helper.create_variable_for_type_inference(weight.dtype)
    helper.append_op(
        "spectral_norm",
        {"Weight": [weight.name], "U": [u.name], "V": [v.name]},
        {"Out": [out.name], "UOut": [u.name], "VOut": [v.name]},
        {"dim": dim, "power_iters": power_iters, "eps": eps})
    return out


def conv3d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     dilation=1, groups=1, param_attr=None, bias_attr=None,
                     act=None, name=None):
    """reference: layers/nn.py conv3d_transpose (conv3d_transpose op)."""
    helper = LayerHelper("conv3d_transpose", name=name)
    if isinstance(filter_size, int):
        filter_size = [filter_size] * 3
    if isinstance(stride, int):
        stride = [stride] * 3
    if isinstance(padding, int):
        padding = [padding] * 3
    if isinstance(dilation, int):
        dilation = [dilation] * 3
    c_in = int(input.shape[1])
    w_shape = [c_in, num_filters // groups] + list(filter_size)
    w = helper.create_parameter(param_attr, w_shape, input.dtype,
                                default_initializer=Xavier())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv3d_transpose",
                     {"Input": [input.name], "Filter": [w.name]},
                     {"Output": [out.name]},
                     {"strides": stride, "paddings": padding,
                      "dilations": dilation, "groups": groups})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        out = helper.append_bias_op(out, b, dim_start=1)
    return helper.append_activation(out, act)
