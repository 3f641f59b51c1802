"""Tensor ops of the GPT and BERT slices: reshape2, slice, lookup_table
(with its dense grad), fill, constants, cast, random init.

Port of the matching rules in `paddle_tpu/ops/tensor_ops.py` (reshape2:42,
slice:141, lookup_table:256-299, fill_constant:347, fill_any_like:370,
assign_value:382, cast:388, uniform_random:435, gaussian_random:446). The
grads of reshape2, slice and cast take the generic vjp path (cast's is a
cast back to the input's dtype). Rules create tensors on
`ctx.device`; random ops draw from the run's `torch.Generator` (or a fixed
`seed` attr), so they give other numbers than JAX's keys from the same seed.
"""

import math

import numpy as np
import torch

from ..framework.registry import register_op, torch_dtype


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


@register_op("reshape2", non_diff_outputs={"XShape"})
def _reshape2(ctx, ins, attrs):
    """XShape records the input shape for the grad op (zero-size, kept for
    IR compatibility with the reference)."""
    x = ins["X"][0]
    out = torch.reshape(x, _resolve_shape(attrs["shape"], x))
    return {"Out": [out],
            "XShape": [torch.zeros((0,) + tuple(x.shape), dtype=x.dtype,
                                   device=x.device)]}


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
    """Dense scatter-add of the out-grad rows into a zero table (reference:
    operators/lookup_table_op.h LookupTableGradKernel); padding_idx rows
    get no gradient. is_sparse=True (a SelectedRows grad) comes with a
    later slice."""
    if attrs.get("is_sparse", False):
        raise NotImplementedError(
            "lookup_table with is_sparse=True (SelectedRows gradients) is "
            "not ported to paddle_tpu_torch yet; build it with "
            "is_sparse=False")
    w, ids, og = ins["W"][0], ins["Ids"][0], ins["Out@GRAD"][0]
    if ids.ndim > 1 and ids.shape[-1] == 1:
        ids = torch.squeeze(ids, -1)
    rows = ids.reshape(-1).long()
    vals = og.reshape(-1, og.shape[-1]).to(w.dtype)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        vals = torch.where((rows != pad)[:, None], vals,
                           torch.zeros((), dtype=vals.dtype,
                                       device=vals.device))
    return {"W@GRAD": [torch.zeros_like(w).index_add_(0, rows, vals)]}


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


@register_op("fill_constant", not_differentiable=True, grad_free=True)
def _fill_constant(ctx, ins, attrs):
    return {"Out": [torch.full(tuple(attrs["shape"]), attrs["value"],
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "float32")),
                               device=ctx.device)]}


@register_op("fill_any_like", not_differentiable=True, grad_free=True)
def _fill_any_like(ctx, ins, attrs):
    x = ins["X"][0]
    dtype = attrs.get("dtype")
    return {"Out": [torch.full_like(
        x, attrs["value"], dtype=torch_dtype(dtype) if dtype else x.dtype)]}


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
