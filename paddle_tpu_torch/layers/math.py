"""Math layers: elementwise_add, elementwise_sub, elementwise_mul and
elementwise_mod (and `+`, `-`, `*`, `/` on Variables), matmul, einsum,
scale, mean, reduce_sum, reduce_mean, reduce_max, clip, cumsum, the
compares equal, less_than, less_equal and greater_than, logical_or,
logical_not, tril.

Copied from `paddle_tpu/layers/math.py`: the same op types, slots and
attrs.
"""

from ..framework.core import Variable
from ..framework.layer_helper import LayerHelper

__all__ = ["elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_mod", "matmul", "einsum", "scale",
           "mean", "reduce_sum", "reduce_mean", "reduce_max", "clip",
           "cumsum", "equal", "less_than", "less_equal", "greater_than",
           "logical_or", "logical_not", "tril"]


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


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mod", x, y, axis, act, name)


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


def _reduce(op_type, x, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if dim is None:
        attrs = {"reduce_all": True, "keep_dim": keep_dim}
    else:
        dim = dim if isinstance(dim, (list, tuple)) else [dim]
        attrs = {"dim": list(dim), "keep_dim": keep_dim}
    helper.append_op(op_type, {"X": [x.name]}, {"Out": [out.name]}, attrs)
    return out


def reduce_sum(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", x, dim, keep_dim, name)


def reduce_mean(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", x, dim, keep_dim, name)


def reduce_max(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", x, dim, keep_dim, name)


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip", {"X": [x.name]}, {"Out": [out.name]},
                     {"min": float(min), "max": float(max)})
    return out


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    helper = LayerHelper("cumsum", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("cumsum", {"X": [x.name]}, {"Out": [out.name]},
                     {"axis": axis, "exclusive": exclusive,
                      "reverse": reverse})
    return out


def _compare(op_type, x, y, name=None):
    helper = LayerHelper(op_type, name=name)
    y = _to_variable(y, x)
    out = helper.create_variable_for_type_inference("bool",
                                                    stop_gradient=True)
    helper.append_op(op_type, {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name]})
    return out


def equal(x, y, name=None):
    return _compare("equal", x, y, name)


def less_than(x, y, name=None):
    return _compare("less_than", x, y, name)


def less_equal(x, y, name=None):
    return _compare("less_equal", x, y, name)


def greater_than(x, y, name=None):
    return _compare("greater_than", x, y, name)


def logical_or(x, y, name=None):
    return _compare("logical_or", x, y, name)


def logical_not(x, name=None):
    helper = LayerHelper("logical_not", name=name)
    out = helper.create_variable_for_type_inference("bool",
                                                    stop_gradient=True)
    helper.append_op("logical_not", {"X": [x.name]}, {"Out": [out.name]})
    return out


def tril(x, diagonal=0, name=None):
    helper = LayerHelper("tril", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("tril_triu", {"X": [x.name]}, {"Out": [out.name]},
                     {"diagonal": diagonal, "lower": True})
    return out
