"""Math ops of the GPT and BERT slices: elementwise_add, matmul, mul, einsum,
mean, sum, scale; the ops the gradient clips and the training telemetry
tap append: elementwise_mul/div/max, clip, clip_by_norm, squared_l2_norm,
isfinite; the ops of the NMT Transformer and the book models:
elementwise_sub, the reduce family, tril_triu; and those the Switch MoE
FFN, the LR schedules and ModelAverage append: elementwise_min/pow and the
compare and logical family; elementwise_mod, which GradientMergeOptimizer's
step boundary appends; and the rest of the file: elementwise_floordiv, bmm,
dot, p_norm, l2_normalize and log_sum_exp.

Port of the matching rules in `paddle_tpu/ops/math_ops.py` (_broadcast_y:21,
the elementwise family :33-55, matmul:64, mul:79, bmm:99, einsum:104,
dot:112, the reduce family :122-145, mean:148, sum:153, scale:178,
clip:205, clip_by_norm:217, squared_l2_norm:236, p_norm:247,
l2_normalize:257, log_sum_exp:267, the compare and logical family
:279-297, isfinite:301, tril_triu:308). elementwise_floordiv's gradient
is zero, as jnp.floor_divide's vjp gives.
Large products go to `torch.matmul` /
`torch.einsum`, as the JAX package leaves them to XLA. Every grad here
takes the generic vjp path, as in JAX (isfinite and the compare family
have none); in eager mode that replays the forward product once more per
grad op (PERF.md §5 measures it).

SelectedRows inputs (sparse embedding grads) take the JAX rules' sparse
branches: a scalar elementwise_mul and a bias-free scale stay sparse, a
`sum` of sparse inputs only concatenates them, and clip, clip_by_norm and
squared_l2_norm act on the merged rows; anything else densifies.
"""

import math

import torch

from ..framework.registry import register_op
from ..framework.selected_rows import SelectedRows, merge_rows, row_mask


def _broadcast_y(x, y, axis):
    """Fluid's `axis` broadcasting (reference: operators/elementwise/
    elementwise_op_function.h): y's dims align with x's starting at
    `axis` (-1 = trailing)."""
    if x.ndim == y.ndim:
        return y
    if y.ndim > x.ndim:
        return y  # torch broadcasting handles leading-dim expansion of x
    if axis == -1:
        axis = x.ndim - y.ndim
    new_shape = (1,) * axis + tuple(y.shape) + (1,) * (x.ndim - axis - y.ndim)
    return torch.reshape(y, new_shape)


def _register_elementwise(name, fn):
    @register_op(name)
    def _lower(ctx, ins, attrs, _fn=fn, _name=name):
        x, y = ins["X"][0], ins["Y"][0]
        if isinstance(x, SelectedRows):
            # a scalar multiply is linear in the rows, so it stays sparse
            # (grad scaling, the clips); anything else densifies
            if _name == "elementwise_mul" and y.numel() == 1:
                return {"Out": [SelectedRows(
                    x.rows, x.values * y.reshape(()).to(x.values.dtype),
                    x.height)]}
            x = x.to_dense()
        return {"Out": [_fn(x, _broadcast_y(x, y, attrs.get("axis", -1)))]}


_register_elementwise("elementwise_add", torch.add)
_register_elementwise("elementwise_sub", torch.sub)
_register_elementwise("elementwise_mul", torch.mul)
_register_elementwise("elementwise_div", torch.div)
_register_elementwise("elementwise_min", torch.minimum)
_register_elementwise("elementwise_max", torch.maximum)
_register_elementwise("elementwise_pow", torch.pow)
# floored modulo: jnp.mod's sign rule
_register_elementwise("elementwise_mod", torch.remainder)
# floored division; torch has no derivative for it, jnp's vjp is zero
_register_elementwise("elementwise_floordiv",
                      lambda x, y: torch.floor_divide(x.detach(),
                                                      y.detach()))


@register_op("matmul")
def _matmul(ctx, ins, attrs):
    """reference: operators/matmul_op.cc — batched matmul w/ transpose flags."""
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False) and x.ndim > 1:
        x = torch.transpose(x, -1, -2)
    if attrs.get("transpose_Y", False) and y.ndim > 1:
        y = torch.transpose(y, -1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register_op("mul")
def _mul(ctx, ins, attrs):
    """reference: operators/mul_op.cc — flatten-to-2D matmul used by fc."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    x2 = x.reshape((math.prod(x.shape[:xn]), math.prod(x.shape[xn:])))
    y2 = y.reshape((math.prod(y.shape[:yn]), math.prod(y.shape[yn:])))
    out = x2 @ y2
    return {"Out": [out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))]}


@register_op("bmm")
def _bmm(ctx, ins, attrs):
    return {"Out": [torch.matmul(ins["X"][0], ins["Y"][0])]}


@register_op("dot")
def _dot(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [torch.sum(x * y, dim=-1, keepdim=True)]}


@register_op("einsum")
def _einsum(ctx, ins, attrs):
    """General contraction over the `Operands` list slot (BERT's b,s,n,d
    attention einsums)."""
    return {"Out": [torch.einsum(attrs["equation"], *ins["Operands"])]}


def _register_reduce(name, fn, not_diff=False):
    """reference: operators/reduce_ops/. `dim` (an int or a list, negative
    counts from the end) unless `reduce_all`; a 0-d result becomes (1,)."""
    @register_op(name, not_differentiable=not_diff, grad_free=not_diff)
    def _lower(ctx, ins, attrs, _fn=fn):
        x = ins["X"][0]
        if attrs.get("reduce_all", False):
            dim = tuple(range(x.ndim))
        else:
            dim = attrs.get("dim", [0])
            dim = tuple(d % max(x.ndim, 1) for d in
                        (dim if isinstance(dim, (list, tuple)) else [dim]))
        # no dim reduces nothing in jnp; torch's sum would reduce all
        out = _fn(x, dim, attrs.get("keep_dim", False)) if dim else x
        if out.ndim == 0:
            out = out.reshape((1,))
        return {"Out": [out]}


def _reduce_over(op):
    """torch's reductions that take one dim at a time (amax and amin take
    a tuple; prod, all and any one int): reduce the dims from the last."""
    def fn(x, dims, keep):
        for d in sorted(dims, reverse=True):
            x = op(x, d, keepdim=keep)
        return x
    return fn


_register_reduce("reduce_sum", lambda x, d, k: torch.sum(x, d, keepdim=k))
_register_reduce("reduce_mean", lambda x, d, k: torch.mean(x, d, keepdim=k))
_register_reduce("reduce_max", lambda x, d, k: torch.amax(x, d, keepdim=k))
_register_reduce("reduce_min", lambda x, d, k: torch.amin(x, d, keepdim=k))
_register_reduce("reduce_prod", _reduce_over(torch.prod))
_register_reduce("reduce_all", _reduce_over(torch.all), not_diff=True)
_register_reduce("reduce_any", _reduce_over(torch.any), not_diff=True)


@register_op("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [torch.mean(ins["X"][0]).reshape((1,))]}


@register_op("sum")
def _sum(ctx, ins, attrs):
    """add_n: sum a list of tensors (grad accumulation, e.g. the tied
    gpt/wte; reference: operators/sum_op.cc). As the reference's
    SumKernel SelectedRows branch: all-sparse inputs concatenate into one
    sparse result; a dense/sparse mix densifies."""
    xs = ins["X"]
    if any(isinstance(x, SelectedRows) for x in xs):
        if all(isinstance(x, SelectedRows) for x in xs):
            return {"Out": [SelectedRows(
                torch.cat([x.rows for x in xs]),
                torch.cat([x.values for x in xs]), xs[0].height)]}
        xs = [x.to_dense() if isinstance(x, SelectedRows) else x
              for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


def _weak_scalar(v, x):
    """A python scalar as jnp's weak typing applies it to x: rounded to x's
    dtype first when that is a 16-bit float. It matters under AMP, where
    BERT's mask scale(1e4, bias=-1e4) runs in bf16: 1e4 rounds to 9984, so
    a kept key gets 1 * 9984 - 9984 = 0 as in JAX, whatever precision the
    backend's kernel keeps the scalar in (unrounded, 9984 - 1e4 = -16)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(v, dtype=x.dtype))
    return v


@register_op("scale")
def _scale(ctx, ins, attrs):
    x = ins["X"][0]
    if isinstance(x, SelectedRows):
        if attrs.get("bias", 0.0) != 0.0:
            x = x.to_dense()   # a bias is affine, not additive-safe
        else:
            return {"Out": [SelectedRows(
                x.rows, x.values * _weak_scalar(attrs.get("scale", 1.0),
                                                x.values), x.height)]}
    s = _weak_scalar(attrs.get("scale", 1.0), x)
    b = _weak_scalar(attrs.get("bias", 0.0), x)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}


def _sparse_merged_and_mask(sr):
    """(rows, merged values, one-occurrence mask). A NONLINEAR rewrite of a
    SelectedRows grad applies to the MERGED per-row value, and the mask
    then zeroes all but one occurrence: f never sees the mask's zero slots
    (clip(0) is not 0 when min > 0)."""
    merged = merge_rows(sr)
    mask = row_mask(sr)[:, None].to(merged.values.dtype)
    return merged.rows, merged.values, mask


@register_op("clip")
def _clip(ctx, ins, attrs):
    x = ins["X"][0]
    if isinstance(x, SelectedRows):
        rows, merged, mask = _sparse_merged_and_mask(x)
        return {"Out": [SelectedRows(
            rows, mask * torch.clamp(merged, attrs["min"], attrs["max"]),
            x.height)]}
    return {"Out": [torch.clamp(x, attrs["min"], attrs["max"])]}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    if isinstance(x, SelectedRows):
        rows, merged, mask = _sparse_merged_and_mask(x)
        vals = merged * mask
        norm = torch.sqrt(torch.sum(vals.float() ** 2))
        scale = torch.where(norm > max_norm,
                            max_norm / torch.clamp_min(norm, 1e-12),
                            torch.ones_like(norm))
        return {"Out": [SelectedRows(rows, vals * scale.to(vals.dtype),
                                     x.height)]}
    norm = torch.sqrt(torch.sum(x * x))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp_min(norm, 1e-12),
                        torch.ones_like(norm))
    return {"Out": [x * scale.to(x.dtype)]}


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    x = ins["X"][0]
    if isinstance(x, SelectedRows):
        _, merged, mask = _sparse_merged_and_mask(x)
        x = merged * mask
    return {"Out": [torch.sum(x.float() ** 2).reshape((1,))]}


@register_op("p_norm")
def _p_norm(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs.get("porder", 2.0)
    out = torch.sum(torch.abs(x) ** p, dim=attrs.get("axis", -1),
                    keepdim=attrs.get("keepdim", False)) ** (1.0 / p)
    return {"Out": [out]}


@register_op("l2_normalize")
def _l2_normalize(ctx, ins, attrs):
    x = ins["X"][0]
    norm = torch.sqrt(torch.sum(x * x, dim=attrs.get("axis", -1),
                                keepdim=True))
    return {"Out": [x / torch.clamp_min(norm, attrs.get("epsilon", 1e-12))],
            "Norm": [norm]}


@register_op("log_sum_exp")
def _log_sum_exp(ctx, ins, attrs):
    x = ins["X"][0]
    dim = tuple(d % max(x.ndim, 1) for d in attrs.get("dim", [-1]))
    return {"Out": [torch.logsumexp(x, dim, attrs.get("keep_dim", False))]}


def _register_cmp(name, fn):
    @register_op(name, not_differentiable=True, grad_free=True)
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0], ins["Y"][0])]}


_register_cmp("equal", torch.eq)
_register_cmp("not_equal", torch.ne)
_register_cmp("less_than", torch.lt)
_register_cmp("less_equal", torch.le)
_register_cmp("greater_than", torch.gt)
_register_cmp("greater_equal", torch.ge)
_register_cmp("logical_and", torch.logical_and)
_register_cmp("logical_or", torch.logical_or)
_register_cmp("logical_xor", torch.logical_xor)


@register_op("logical_not", not_differentiable=True, grad_free=True)
def _logical_not(ctx, ins, attrs):
    return {"Out": [torch.logical_not(ins["X"][0])]}


@register_op("isfinite", not_differentiable=True, grad_free=True)
def _isfinite(ctx, ins, attrs):
    """reference: operators/isfinite_op.cc: one flag, all values finite."""
    return {"Out": [torch.isfinite(ins["X"][0]).all().reshape((1,))]}


@register_op("tril_triu")
def _tril_triu(ctx, ins, attrs):
    """reference: operators/tril_triu_op.cc."""
    x = ins["X"][0]
    k = attrs.get("diagonal", 0)
    if attrs.get("lower", True):
        return {"Out": [torch.tril(x, k)]}
    return {"Out": [torch.triu(x, k)]}
