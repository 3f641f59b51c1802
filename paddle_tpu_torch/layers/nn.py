"""NN layers of the GPT and BERT slices: fc, embedding, layer_norm, dropout,
gelu, softmax, softmax_with_cross_entropy, fused_attention.

Copied from `paddle_tpu/layers/nn.py`: the same op types, slots, attrs and
parameter initializers, so programs built by either DSL serialize alike.
"""

import numpy as np

from ..framework.layer_helper import LayerHelper
from ..initializer import Constant, Xavier

__all__ = ["fc", "embedding", "layer_norm", "dropout", "gelu", "softmax",
           "softmax_with_cross_entropy", "fused_attention"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected (reference: layers/nn.py:224), one input."""
    helper = LayerHelper("fc", name=name)
    if isinstance(input, (list, tuple)):
        raise NotImplementedError("fc over a list of inputs (the sum op) is "
                                  "not ported to paddle_tpu_torch yet")
    in_features = 1
    for d in input.shape[num_flatten_dims:]:
        in_features *= int(d)
    w = helper.create_parameter(param_attr, [in_features, size], input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("mul", {"X": [input.name], "Y": [w.name]},
                     {"Out": [out.name]},
                     {"x_num_col_dims": num_flatten_dims,
                      "y_num_col_dims": 1})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], out.dtype,
                                    is_bias=True)
        out = helper.append_bias_op(out, b, dim_start=num_flatten_dims)
    return helper.append_activation(out, act)


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


def gelu(x, approximate=False, name=None):
    helper = LayerHelper("gelu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("gelu", {"X": [x.name]}, {"Out": [out.name]},
                     {"approximate": approximate})
    return out


def softmax(x, axis=-1, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("softmax", {"X": [x.name]}, {"Out": [out.name]},
                     {"axis": axis})
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
