"""Math layers: the elementwise family (and `+`, `-`, `*`, `/` on
Variables), matmul, mul, einsum, scale, sum/sums, mean, the reduce
family, clip, clip_by_norm, l2_normalize, cumsum, the compare and logical
family, isfinite, tril and triu.

Copied from `paddle_tpu/layers/math.py`: the same op types, slots and
attrs.
"""

from ..framework.core import Variable
from ..framework.layer_helper import LayerHelper

__all__ = ["einsum", "elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_min", "elementwise_max",
           "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
           "matmul", "mul", "scale", "sum", "sums", "reduce_sum",
           "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
           "reduce_all", "reduce_any", "clip", "clip_by_norm", "mean",
           "l2_normalize", "equal", "not_equal", "less_than", "less_equal",
           "greater_than", "greater_equal", "logical_and", "logical_or",
           "logical_not", "logical_xor", "isfinite", "cumsum", "tril", "triu"]


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


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_floordiv", x, y, axis, act, name)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mul", {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name]},
                     {"x_num_col_dims": x_num_col_dims,
                      "y_num_col_dims": y_num_col_dims})
    return out


def sum(x):
    xs = x if isinstance(x, (list, tuple)) else [x]
    helper = LayerHelper("sum")
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op("sum", {"X": [v.name for v in xs]}, {"Out": [out.name]})
    return out


def reduce_min(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", x, dim, keep_dim, name)


def reduce_prod(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", x, dim, keep_dim, name)


def reduce_all(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_all", x, dim, keep_dim, name)


def reduce_any(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_any", x, dim, keep_dim, name)


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip_by_norm", {"X": [x.name]}, {"Out": [out.name]},
                     {"max_norm": float(max_norm)})
    return out


def l2_normalize(x, axis=-1, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("l2_normalize", {"X": [x.name]},
                     {"Out": [out.name], "Norm": [norm.name]},
                     {"axis": axis, "epsilon": epsilon})
    return out


def not_equal(x, y, name=None):
    return _compare("not_equal", x, y, name)


def greater_equal(x, y, name=None):
    return _compare("greater_equal", x, y, name)


def logical_and(x, y, name=None):
    return _compare("logical_and", x, y, name)


def logical_xor(x, y, name=None):
    return _compare("logical_xor", x, y, name)


def isfinite(x, name=None):
    helper = LayerHelper("isfinite", name=name)
    out = helper.create_variable_for_type_inference("bool",
                                                    stop_gradient=True)
    helper.append_op("isfinite", {"X": [x.name]}, {"Out": [out.name]})
    return out


def triu(x, diagonal=0, name=None):
    from ..framework.layer_helper import LayerHelper
    helper = LayerHelper("triu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("tril_triu", {"X": [x.name]}, {"Out": [out.name]},
                     {"diagonal": diagonal, "lower": False})
    return out


sums = sum
