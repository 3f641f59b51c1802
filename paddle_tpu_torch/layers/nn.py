"""NN layers of the GPT, BERT, ResNet, NMT Transformer and book slices: fc
(one input or a list), embedding, conv2d, pool2d, batch_norm, layer_norm,
dropout, relu, sigmoid, tanh, gelu, sqrt, softmax,
softmax_with_cross_entropy, square_error_cost, topk, accuracy, one_hot,
fused_attention, add_position_encoding.

Copied from `paddle_tpu/layers/nn.py`: the same op types, slots, attrs and
parameter initializers, and the same order of var creation, so programs
built by either DSL serialize alike and carry parameters across by name.
"""

import numpy as np

from ..framework.core import unique_name
from ..framework.layer_helper import LayerHelper
from ..initializer import Constant, Normal, Xavier

__all__ = ["fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
           "dropout", "relu", "sigmoid", "tanh", "gelu", "sqrt", "square",
           "softmax",
           "softmax_with_cross_entropy", "square_error_cost", "topk",
           "accuracy", "one_hot", "fused_attention",
           "add_position_encoding"]


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


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    """reference: layers/nn.py add_position_encoding (sinusoidal PE)."""
    helper = LayerHelper("add_position_encoding", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("add_position_encoding", {"X": [input.name]},
                     {"Out": [out.name]}, {"alpha": alpha, "beta": beta})
    return out
