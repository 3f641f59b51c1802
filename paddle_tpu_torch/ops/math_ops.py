"""Math ops of the GPT and BERT slices: elementwise_add, matmul, mul, einsum,
mean, sum, scale.

Port of the matching rules in `paddle_tpu/ops/math_ops.py` (_broadcast_y:21,
matmul:64, mul:79, einsum:104, mean:148, sum:153, scale:178). Large
products go to `torch.matmul` / `torch.einsum`, as the JAX package leaves
them to XLA. The grads of elementwise_add, matmul, mul, einsum and mean take
the generic vjp path, as in JAX;
in eager mode that replays the forward product once more per grad op
(PERF.md §5 measures it).
"""

import math

import torch

from ..framework.registry import register_op


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


@register_op("elementwise_add")
def _elementwise_add(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [x + _broadcast_y(x, y, attrs.get("axis", -1))]}


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


@register_op("einsum")
def _einsum(ctx, ins, attrs):
    """General contraction over the `Operands` list slot (BERT's b,s,n,d
    attention einsums)."""
    return {"Out": [torch.einsum(attrs["equation"], *ins["Operands"])]}


@register_op("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [torch.mean(ins["X"][0]).reshape((1,))]}


@register_op("sum")
def _sum(ctx, ins, attrs):
    """add_n: sum a list of tensors (grad accumulation, e.g. the tied
    gpt/wte; reference: operators/sum_op.cc). Dense only: SelectedRows
    inputs come with the sparse lookup_table grad."""
    xs = ins["X"]
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
    s = _weak_scalar(attrs.get("scale", 1.0), x)
    b = _weak_scalar(attrs.get("bias", 0.0), x)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}
