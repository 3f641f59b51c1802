"""Tensor ops of the GPT, BERT and ResNet slices: reshape2, slice,
lookup_table (with its dense and its SelectedRows grad), fill, constants,
cast, random init, top_k; where and assign, which the training
telemetry's skip/halt gates append; transpose2, squeeze2, unsqueeze2,
concat and split, which the NMT Transformer, the book models and `nets`
append; one_hot, arg_max, cumsum and increment, which the Switch MoE
FFN and the LR schedules append; and fill_constant_batch_size_like, which
the StaticRNN/DynamicRNN memories append.

Port of the matching rules in `paddle_tpu/ops/tensor_ops.py` (reshape2:42,
transpose2:55, squeeze2:67, unsqueeze2:79, concat:110, split:115,
slice:141, lookup_table:256-299, one_hot:315, where:329, fill_constant:347,
fill_constant_batch_size_like:354, fill_any_like:370, assign:377,
assign_value:382, cast:388, increment:415, uniform_random:435, gaussian_random:446, top_k:483, arg_max:490,
cumsum:517). The grads of reshape2, transpose2, squeeze2, unsqueeze2,
concat, split, slice, where, assign, cast, cumsum and increment take the
generic vjp path (cast's is a cast back to the input's dtype); one_hot
and arg_max have none. Rules create tensors on `ctx.device`; random ops
draw from the run's `torch.Generator` (or a fixed `seed` attr), so they
give other numbers than JAX's keys from the same seed.
"""

import math

import numpy as np
import torch

from ..framework.registry import register_op, torch_dtype
from ..framework.selected_rows import SelectedRows


def _resolve_shape(shape, x):
    """fluid reshape semantics: 0 -> copy input dim, -1 -> infer."""
    shape = list(shape)
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = math.prod(x.shape) // max(known, 1)
    return tuple(shape)


def _xshape(x):
    """The XShape side output of the *2 ops: zero-size, non-differentiable,
    kept for IR compatibility with the reference."""
    return torch.zeros((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


@register_op("reshape2", non_diff_outputs={"XShape"})
def _reshape2(ctx, ins, attrs):
    """XShape records the input shape for the grad op (`_xshape`)."""
    x = ins["X"][0]
    out = torch.reshape(x, _resolve_shape(attrs["shape"], x))
    return {"Out": [out], "XShape": [_xshape(x)]}


@register_op("transpose2", non_diff_outputs={"XShape"})
def _transpose2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.permute(x, tuple(attrs["axis"]))],
            "XShape": [_xshape(x)]}


@register_op("squeeze2", non_diff_outputs={"XShape"})
def _squeeze2(ctx, ins, attrs):
    """Only the listed axes of size 1 go (others are kept, as in JAX); no
    axes: every size-1 axis."""
    x = ins["X"][0]
    axes = attrs.get("axes", [])
    if axes:
        axes = tuple(a % x.ndim for a in axes if x.shape[a % x.ndim] == 1)
        out = torch.squeeze(x, axes) if axes else x
    else:
        out = torch.squeeze(x)
    return {"Out": [out], "XShape": [_xshape(x)]}


@register_op("unsqueeze2", non_diff_outputs={"XShape"})
def _unsqueeze2(ctx, ins, attrs):
    x = ins["X"][0]
    out = x
    for a in sorted(attrs["axes"]):
        out = torch.unsqueeze(out, a)
    return {"Out": [out], "XShape": [_xshape(x)]}


@register_op("concat")
def _concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("split")
def _split(ctx, ins, attrs):
    """`sections` (sizes) or `num` equal parts along `axis`."""
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        outs = torch.split(x, list(sections), dim=axis)
    else:
        num = attrs["num"]
        if x.shape[axis] % num:
            raise ValueError(
                f"split: axis {axis} of size {x.shape[axis]} does not "
                f"divide into {num} equal parts")
        outs = torch.split(x, x.shape[axis] // num, dim=axis)
    return {"Out": list(outs)}


@register_op("slice")
def _slice(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    for a in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = torch.squeeze(out, dim=a)
    return {"Out": [out]}


def _lookup_sparse_slots(op):
    return {"W"} if op.attrs.get("is_sparse", False) else set()


def _lookup_table_grad(ctx, ins, attrs):
    """Dense scatter-add of the out-grad rows into a zero table, or, with
    is_sparse=True, a SelectedRows of (ids, out-grad rows): the
    reference's sparse-embedding gradient (operators/lookup_table_op.h
    LookupTableGradKernel and its SelectedRows branch). padding_idx rows
    get no gradient."""
    w, ids, og = ins["W"][0], ins["Ids"][0], ins["Out@GRAD"][0]
    if ids.ndim > 1 and ids.shape[-1] == 1:
        ids = torch.squeeze(ids, -1)
    rows = ids.reshape(-1).long()
    vals = og.reshape(-1, og.shape[-1])
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        vals = torch.where((rows != pad)[:, None], vals,
                           torch.zeros((), dtype=vals.dtype,
                                       device=vals.device))
    if attrs.get("is_sparse", False):
        return {"W@GRAD": [SelectedRows(rows, vals, w.shape[0])]}
    return {"W@GRAD": [torch.zeros_like(w).index_add_(0, rows,
                                                      vals.to(w.dtype))]}


@register_op("lookup_table", no_grad_inputs={"Ids"},
             sparse_grad_slots=_lookup_sparse_slots,
             grad_lower=_lookup_table_grad)
def _lookup_table(ctx, ins, attrs):
    """Embedding (reference: operators/lookup_table_op.cc). Ids carry a
    trailing 1 dim in fluid."""
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.ndim > 1 and ids.shape[-1] == 1:
        ids = torch.squeeze(ids, -1)
    out = torch.nn.functional.embedding(ids.long(), w)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        out = torch.where((ids != pad)[..., None], out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return {"Out": [out]}


@register_op("one_hot", not_differentiable=True, grad_free=True)
def _one_hot(ctx, ins, attrs):
    """float32 one-hot over `depth`; an id outside [0, depth) gives a zero
    row, as jax.nn.one_hot does. A trailing 1 dim of X is dropped."""
    x = ins["X"][0]
    if x.ndim > 1 and x.shape[-1] == 1:
        x = torch.squeeze(x, -1)
    depth = torch.arange(attrs["depth"], device=x.device)
    return {"Out": [(x[..., None] == depth).to(torch.float32)]}


@register_op("fill_constant", not_differentiable=True, grad_free=True)
def _fill_constant(ctx, ins, attrs):
    return {"Out": [torch.full(tuple(attrs["shape"]), attrs["value"],
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "float32")),
                               device=ctx.device)]}


@register_op("fill_constant_batch_size_like", not_differentiable=True,
             grad_free=True)
def _fill_cbsl(ctx, ins, attrs):
    """The shape attr with Out[output_dim_idx] = Input.shape[input_dim_idx]
    (StaticRNN/DynamicRNN memories, rnn_encoder_decoder's boot)."""
    ref = ins["Input"][0]
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return {"Out": [torch.full(tuple(shape), attrs["value"],
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "float32")),
                               device=ctx.device)]}


@register_op("fill_any_like", not_differentiable=True, grad_free=True)
def _fill_any_like(ctx, ins, attrs):
    x = ins["X"][0]
    dtype = attrs.get("dtype")
    return {"Out": [torch.full_like(
        x, attrs["value"], dtype=torch_dtype(dtype) if dtype else x.dtype)]}


@register_op("where", no_grad_inputs={"Condition"})
def _where(ctx, ins, attrs):
    c, x, y = ins["Condition"][0], ins["X"][0], ins["Y"][0]
    return {"Out": [torch.where(c, x, y)]}


@register_op("assign")
def _assign(ctx, ins, attrs):
    """A copy, not the input itself: the executor may update a donated
    parameter in place later in the same run, and a snapshot taken with
    assign (the telemetry gates' @PRE_STEP) must keep the old values."""
    return {"Out": [ins["X"][0].clone()]}


@register_op("assign_value", not_differentiable=True, grad_free=True)
def _assign_value(ctx, ins, attrs):
    dtype = attrs.get("dtype", "float32")
    shape = tuple(attrs["shape"])
    if ctx.abstract:
        return {"Out": [torch.empty(shape, dtype=torch_dtype(dtype),
                                    device=ctx.device)]}
    vals = np.asarray(attrs["values"], dtype=dtype).reshape(shape)
    return {"Out": [torch.from_numpy(vals).to(ctx.device)]}


@register_op("cast")
def _cast(ctx, ins, attrs):
    """`out_dtype` is a dtype string (the AMP rewrite's "bfloat16" /
    "float32")."""
    return {"Out": [ins["X"][0].to(torch_dtype(attrs["out_dtype"]))]}


@register_op("increment")
def _increment(ctx, ins, attrs):
    """reference: increment_op.cc. The step keeps X's dtype: an int64
    counter stays int64, and a float step is rounded to X's float dtype
    before the add, as jnp.asarray(step, x.dtype) does."""
    x = ins["X"][0]
    return {"Out": [x + torch.tensor(attrs.get("step", 1.0),
                                     dtype=x.dtype)]}


def _generator(ctx, attrs):
    seed = attrs.get("seed", 0)
    return ctx.seeded(seed) if seed else ctx.rng()


@register_op("uniform_random", not_differentiable=True, grad_free=True,
             stateful=True)
def _uniform_random(ctx, ins, attrs):
    shape = tuple(attrs["shape"])
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = torch.rand(shape, generator=_generator(ctx, attrs),
                   dtype=torch.float32, device=ctx.device)
    out = lo + (hi - lo) * u
    return {"Out": [out.to(torch_dtype(attrs.get("dtype", "float32")))]}


@register_op("gaussian_random", not_differentiable=True, grad_free=True,
             stateful=True)
def _gaussian_random(ctx, ins, attrs):
    shape = tuple(attrs["shape"])
    n = torch.randn(shape, generator=_generator(ctx, attrs),
                    dtype=torch.float32, device=ctx.device)
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * n
    return {"Out": [out.to(torch_dtype(attrs.get("dtype", "float32")))]}


@register_op("top_k", non_diff_outputs={"Indices"})
def _top_k(ctx, ins, attrs):
    """The k largest along the last axis, largest first; Indices int64
    (JAX without x64 gives int32, a known non-fault)."""
    v, i = torch.topk(ins["X"][0], attrs["k"], dim=-1)
    return {"Out": [v], "Indices": [i]}


@register_op("arg_max", not_differentiable=True, grad_free=True)
def _arg_max(ctx, ins, attrs):
    """Index of the largest value along `axis`; on ties the first, as
    jnp.argmax (the Switch MoE router relies on it: a padding token's
    uniform probabilities pick one expert). Out in `dtype` (int64)."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    out = torch.argmax(x, dim=axis).to(torch_dtype(attrs.get("dtype",
                                                             "int64")))
    if attrs.get("keepdims", False):
        out = torch.unsqueeze(out, axis)
    return {"Out": [out]}


@register_op("cumsum")
def _cumsum(ctx, ins, attrs):
    """Running sum along `axis` (`flatten` first when asked); `exclusive`
    subtracts each element from its inclusive sum and `reverse` runs from
    the end, both as the JAX rule computes them. Keeps X's dtype (a bool
    X counts in int64)."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x = x.reshape(-1)
        axis = 0
    rev = attrs.get("reverse", False)
    xa = torch.flip(x, (axis,)) if rev else x
    dtype = torch.int64 if xa.dtype == torch.bool else xa.dtype
    out = torch.cumsum(xa, dim=axis, dtype=dtype)
    if attrs.get("exclusive", False):
        out = out - xa.to(dtype)
    if rev:
        out = torch.flip(out, (axis,))
    return {"Out": [out]}
