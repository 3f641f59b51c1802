"""Math layers of the GPT and BERT slices: elementwise_add (and `+` on
Variables), matmul, einsum, scale, mean.

Copied from `paddle_tpu/layers/math.py`: the same op types, slots and
attrs.
"""

from ..framework.core import Variable
from ..framework.layer_helper import LayerHelper

__all__ = ["elementwise_add", "matmul", "einsum", "scale", "mean"]


def _to_variable(x, ref: Variable):
    """Wrap python scalars as fill_constant vars."""
    if isinstance(x, Variable):
        return x
    helper = LayerHelper("const")
    v = helper.create_variable_for_type_inference(ref.dtype,
                                                  stop_gradient=True)
    helper.append_op("fill_constant", {}, {"Out": [v.name]},
                     {"shape": [1], "dtype": ref.dtype, "value": float(x)})
    return v


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name)
    y = _to_variable(y, x)
    x = _to_variable(x, y)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name]}, {"axis": axis})
    return helper.append_activation(out, act)


def _elementwise_from_operator(x, other, op_type, reverse=False):
    if reverse:
        other = _to_variable(other, x)
        return _elementwise(op_type, other, x)
    return _elementwise(op_type, x, other)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul", {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name]},
                     {"transpose_X": transpose_x, "transpose_Y": transpose_y,
                      "alpha": float(alpha)})
    return out


def einsum(equation, *operands, name=None):
    helper = LayerHelper("einsum", name=name)
    out = helper.create_variable_for_type_inference(operands[0].dtype)
    helper.append_op("einsum", {"Operands": [v.name for v in operands]},
                     {"Out": [out.name]}, {"equation": equation})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", {"X": [x.name]}, {"Out": [out.name]},
                     {"scale": float(scale), "bias": float(bias),
                      "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", {"X": [x.name]}, {"Out": [out.name]})
    return out
