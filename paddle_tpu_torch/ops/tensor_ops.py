"""Tensor ops: shape and layout (reshape, transpose, flatten, stack,
slices, pads, expand/tile, roll, flip), indexing (gather, scatter,
index_select, where_index, the embeddings), fills, constants, casts, the
random ops, top_k/argsort/arg_max/arg_min, cumsum/cumprod, py_func and
optimization_barrier: every rule of `paddle_tpu/ops/tensor_ops.py`.

Port of that file's rules by name (reshape2:42, reshape:49, transpose2:55,
transpose:62, squeeze2:67, unsqueeze2:79, flatten2:88,
flatten_contiguous_range:96, concat:110, split:115, stack:128,
unstack:133, slice:141, strided_slice:159, pad:169, pad2d:178,
expand:193, expand_as:200, tile:207, roll:212, flip:218, gather:227,
gather_nd:233, scatter:239, scatter_nd_add:250, lookup_table and
lookup_table_v2 with their shared grad :260-310, one_hot:315,
index_select:323, where:329, where_index:335, fill_constant:347,
fill_constant_batch_size_like:354, fill_zeros_like:365,
fill_any_like:370, assign:377, assign_value:382, cast:388, shape:393,
size:399, range:404 (raises, as JAX's does), increment:415, the random
ops :435-478, top_k:483, arg_max:490, arg_min:500, argsort:507,
cumsum:517, cumprod:533, py_func:551, optimization_barrier:581). Grads
take the generic vjp path except the embeddings' (a scatter-add, or a
SelectedRows with is_sparse); ops JAX marks non-differentiable have none.
Rules create tensors on `ctx.device`; random ops draw from the run's
`torch.Generator` (or a fixed `seed` attr), so they give other numbers
than JAX's keys from the same seed.

Indexing reads with advanced indexing (`x[idx]`), whose gradient is the
sort-based `index_put_(accumulate=True)`, and every scatter-add goes
through `framework.selected_rows.scatter_add`: no atomics, so a rerun on
the card gives the same bits. Out-of-range indices raise (CPU) or assert
(CUDA), where `jnp.take` clamps or fills; scatter with overwrite and a
repeated id keeps an unspecified one of its updates, as XLA's does.
"""

import math

import numpy as np
import torch

from ..framework.registry import register_op, torch_dtype
from ..framework.selected_rows import SelectedRows, scatter_add


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


def _lookup_table_grad(ctx, ins, attrs, squeeze_trailing=True):
    """Dense scatter-add of the out-grad rows into a zero table, or, with
    is_sparse=True, a SelectedRows of (ids, out-grad rows): the
    reference's sparse-embedding gradient (operators/lookup_table_op.h
    LookupTableGradKernel and its SelectedRows branch). padding_idx rows
    get no gradient. lookup_table's Ids carry a trailing 1 dim
    (`squeeze_trailing`), lookup_table_v2's do not."""
    w, ids, og = ins["W"][0], ins["Ids"][0], ins["Out@GRAD"][0]
    if squeeze_trailing and ids.ndim > 1 and ids.shape[-1] == 1:
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
    return {"W@GRAD": [scatter_add(torch.zeros_like(w), rows,
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


@register_op("lookup_table_v2", no_grad_inputs={"Ids"},
             sparse_grad_slots=_lookup_sparse_slots,
             grad_lower=lambda ctx, ins, attrs: _lookup_table_grad(
                 ctx, ins, attrs, squeeze_trailing=False))
def _lookup_table_v2(ctx, ins, attrs):
    """lookup_table without the trailing-1 squeeze of Ids; the same grad
    (dense scatter-add or SelectedRows, padding_idx rows zero)."""
    w, ids = ins["W"][0], ins["Ids"][0]
    out = torch.nn.functional.embedding(ids.long(), w)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        out = torch.where((ids != pad)[..., None], out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# shape and layout
# ---------------------------------------------------------------------------

@register_op("reshape")
def _reshape(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.reshape(x, _resolve_shape(attrs["shape"], x))]}


@register_op("transpose")
def _transpose(ctx, ins, attrs):
    return {"Out": [torch.permute(ins["X"][0], tuple(attrs["axis"]))]}


@register_op("flatten2", non_diff_outputs={"XShape"})
def _flatten2(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", 1)
    out = x.reshape((math.prod(x.shape[:axis]), math.prod(x.shape[axis:])))
    return {"Out": [out], "XShape": [_xshape(x)]}


@register_op("flatten_contiguous_range")
def _flatten_range(ctx, ins, attrs):
    x = ins["X"][0]
    start = attrs.get("start_axis", 1) % x.ndim
    stop = attrs.get("stop_axis", -1) % x.ndim
    shape = tuple(x.shape[:start]) + (math.prod(x.shape[start:stop + 1]),) \
        + tuple(x.shape[stop + 1:])
    return {"Out": [x.reshape(shape)]}


@register_op("stack")
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("unstack")
def _unstack(ctx, ins, attrs):
    return {"Y": list(torch.unbind(ins["X"][0], dim=attrs.get("axis", 0)))}


@register_op("strided_slice")
def _strided_slice(ctx, ins, attrs):
    """Python slicing per axis, negative strides included (torch slices
    only forward: a negative stride flips the axis and slices it
    forward over the same elements)."""
    x = ins["Input"][0]
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           attrs["strides"]):
        dim = x.shape[a]
        idx = [slice(None)] * x.ndim
        if st > 0:
            idx[a] = slice(s, e, st)
        else:
            r = range(*slice(s, e, st).indices(dim))
            x = torch.flip(x, (a,))
            idx[a] = slice(dim - 1 - r[0], dim - r[-1], -st) if len(r) \
                else slice(0, 0)
        x = x[tuple(idx)]
    return {"Out": [x]}


def _torch_pads(pairs):
    """[(before, after)] per dim, first dim first -> F.pad's flat list,
    last dim first."""
    flat = []
    for before, after in reversed(pairs):
        flat += [before, after]
    return flat


@register_op("pad")
def _pad(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs["paddings"]
    pairs = [(p[2 * i], p[2 * i + 1]) for i in range(x.ndim)]
    return {"Out": [torch.nn.functional.pad(
        x, _torch_pads(pairs), value=attrs.get("pad_value", 0.0))]}


def _pad_index(n, before, after, mode, device):
    """Source index of each position of a dim of size n padded by
    (before, after): numpy's "reflect" (mirrored without the edge,
    repeated past one period) or "edge" (clamped)."""
    j = torch.arange(-before, n + after, device=device)
    if mode != "reflect":
        return torch.clamp(j, 0, n - 1)
    if n == 1:
        return torch.zeros_like(j)
    period = 2 * (n - 1)
    j = torch.remainder(j, period)
    return torch.where(j >= n, period - j, j)


@register_op("pad2d")
def _pad2d(ctx, ins, attrs):
    """constant pads with F.pad; reflect and edge gather the padded
    positions by index (their gradient is a sort-based scatter-add, where
    torch's reflection/replication pad backward uses atomics)."""
    x = ins["X"][0]
    t, b, l, r = attrs["paddings"]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": [torch.nn.functional.pad(
            x, (l, r, t, b), value=attrs.get("pad_value", 0.0))]}
    ih = _pad_index(x.shape[2], t, b, mode, x.device)
    iw = _pad_index(x.shape[3], l, r, mode, x.device)
    return {"Out": [x[:, :, ih[:, None], iw]]}


@register_op("expand")
def _expand(ctx, ins, attrs):
    return {"Out": [torch.tile(ins["X"][0], tuple(attrs["expand_times"]))]}


@register_op("expand_as")
def _expand_as(ctx, ins, attrs):
    x, tgt = ins["X"][0], ins["target_tensor"][0]
    return {"Out": [torch.tile(x, tuple(t // s for t, s in
                                        zip(tgt.shape, x.shape)))]}


@register_op("tile")
def _tile(ctx, ins, attrs):
    return {"Out": [torch.tile(ins["X"][0], tuple(attrs["repeat_times"]))]}


@register_op("roll")
def _roll(ctx, ins, attrs):
    """jnp.roll: one shift broadcasts over every listed axis."""
    axis = tuple(attrs["axis"])
    shifts = attrs["shifts"]
    shifts = list(shifts) if isinstance(shifts, (list, tuple)) else [shifts]
    if len(shifts) == 1:
        shifts = shifts * len(axis)
    return {"Out": [torch.roll(ins["X"][0], shifts, axis)]}


@register_op("flip")
def _flip(ctx, ins, attrs):
    return {"Out": [torch.flip(ins["X"][0], tuple(attrs["axis"]))]}


# ---------------------------------------------------------------------------
# gather / scatter
# ---------------------------------------------------------------------------

def _nd_index(idx):
    """The last dim of an index tensor as a tuple of index tensors."""
    idx = idx.long()
    return tuple(idx[..., i] for i in range(idx.shape[-1]))


@register_op("gather", no_grad_inputs={"Index"})
def _gather(ctx, ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0]
    return {"Out": [x[idx.reshape(-1).long()]]}


@register_op("gather_nd", no_grad_inputs={"Index"})
def _gather_nd(ctx, ins, attrs):
    return {"Out": [ins["X"][0][_nd_index(ins["Index"][0])]]}


@register_op("scatter", no_grad_inputs={"Ids"})
def _scatter(ctx, ins, attrs):
    """overwrite: X with the Updates rows written at Ids; else added into
    X's rows, a repeated id's updates summed in order."""
    x, ids, upd = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    ids = ids.reshape(-1).long()
    if attrs.get("overwrite", True):
        return {"Out": [x.index_put((ids,), upd)]}
    return {"Out": [scatter_add(x, ids, upd)]}


@register_op("scatter_nd_add", no_grad_inputs={"Index"})
def _scatter_nd_add(ctx, ins, attrs):
    x, idx, upd = ins["X"][0], ins["Index"][0], ins["Updates"][0]
    return {"Out": [x.index_put(_nd_index(idx), upd, accumulate=True)]}


@register_op("index_select", no_grad_inputs={"Index"})
def _index_select(ctx, ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0]
    dim = attrs.get("dim", 0) % x.ndim
    return {"Out": [x[(slice(None),) * dim + (idx.long(),)]]}


@register_op("where_index", not_differentiable=True, grad_free=True)
def _where_index(ctx, ins, attrs):
    """The flat positions of Condition's nonzero values in order, padded
    with -1 to Condition's size: JAX's static-shape variant
    (jnp.nonzero(size=c.size, fill_value=-1)), shape (c.size, 1). No
    count leaves the device."""
    c = ins["Condition"][0].reshape(-1)
    n = c.numel()
    pos = torch.arange(n, device=c.device)
    key = torch.where(c != 0, pos, torch.full_like(pos, n))
    idx = torch.sort(key).values
    return {"Out": [torch.where(idx < n, idx,
                                torch.full_like(idx, -1))[:, None]]}


# ---------------------------------------------------------------------------
# shape queries, fills, range
# ---------------------------------------------------------------------------

@register_op("fill_zeros_like", not_differentiable=True, grad_free=True)
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


@register_op("shape", not_differentiable=True, grad_free=True)
def _shape(ctx, ins, attrs):
    x = ins["Input"][0]
    return {"Out": [torch.tensor(tuple(x.shape), dtype=torch.int32,
                                 device=x.device)]}


@register_op("size", not_differentiable=True, grad_free=True)
def _size(ctx, ins, attrs):
    x = ins["Input"][0]
    return {"Out": [torch.full((1,), x.numel(), dtype=torch.int64,
                               device=x.device)]}


@register_op("range", not_differentiable=True, grad_free=True)
def _range(ctx, ins, attrs):
    """Raises, as the JAX rule does: its output's length is a tensor."""
    raise NotImplementedError(
        "dynamic range op is not supported under jit; use layers.arange with "
        "static bounds")


# ---------------------------------------------------------------------------
# random ops
# ---------------------------------------------------------------------------

@register_op("truncated_gaussian_random", not_differentiable=True,
             grad_free=True, stateful=True)
def _truncated_gaussian_random(ctx, ins, attrs):
    """mean + std * N(0, 1) truncated to [-2, 2], by the inverse CDF as
    jax.random.truncated_normal draws it: sqrt(2) erfinv(u), u uniform
    between erf(-sqrt 2) and erf(sqrt 2), clipped inside the bounds."""
    shape = tuple(attrs["shape"])
    lo, hi = math.erf(-math.sqrt(2.0)), math.erf(math.sqrt(2.0))
    u = torch.rand(shape, generator=_generator(ctx, attrs),
                   dtype=torch.float32, device=ctx.device)
    z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
    z = torch.clamp(z, math.nextafter(-2.0, 0.0), math.nextafter(2.0, 0.0))
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return {"Out": [out.to(torch_dtype(attrs.get("dtype", "float32")))]}


@register_op("randint", not_differentiable=True, grad_free=True,
             stateful=True)
def _randint(ctx, ins, attrs):
    """Integers in [low, high)."""
    return {"Out": [torch.randint(
        attrs.get("low", 0), attrs.get("high"), tuple(attrs["shape"]),
        generator=_generator(ctx, attrs),
        dtype=torch_dtype(attrs.get("dtype", "int64")), device=ctx.device)]}


@register_op("shuffle_batch", not_differentiable=True, grad_free=True,
             stateful=True)
def _shuffle_batch(ctx, ins, attrs):
    """X's rows in a random order; ShuffleIdx the permutation (int64)."""
    x = ins["X"][0]
    perm = torch.randperm(x.shape[0], generator=_generator(ctx, attrs),
                          device=ctx.device)
    return {"Out": [x[perm]], "ShuffleIdx": [perm]}


# ---------------------------------------------------------------------------
# ordering and scans
# ---------------------------------------------------------------------------

@register_op("arg_min", not_differentiable=True, grad_free=True)
def _arg_min(ctx, ins, attrs):
    """Index of the smallest value along `axis`, the first on ties."""
    return {"Out": [torch.argmin(ins["X"][0], dim=attrs.get("axis", -1))
                    .to(torch_dtype(attrs.get("dtype", "int64")))]}


@register_op("argsort", non_diff_outputs={"Indices"})
def _argsort(ctx, ins, attrs):
    """A stable sort of x, or of -x when descending (JAX's key): ties keep
    their index order in both directions. Indices int64."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    key = -x if attrs.get("descending", False) else x
    idx = torch.sort(key, dim=axis, stable=True).indices
    return {"Out": [torch.take_along_dim(x, idx, dim=axis)],
            "Indices": [idx]}


@register_op("cumprod")
def _cumprod(ctx, ins, attrs):
    return {"Out": [torch.cumprod(ins["X"][0], dim=attrs.get("dim", -1))]}


# ---------------------------------------------------------------------------
# py_func and optimization_barrier
# ---------------------------------------------------------------------------

# py_func's callables (reference: operators/py_func_op.cc): the layer
# registers the function here and the op carries its id, as in JAX.
_PY_FUNCS = {}


def register_py_func(fn) -> int:
    fid = len(_PY_FUNCS)
    _PY_FUNCS[fid] = fn
    return fid


@register_op("py_func", not_differentiable=True)
def _py_func(ctx, ins, attrs):
    """Host Python inside the op sequence: the inputs are copied to numpy
    (one synchronisation a call on the card), the function runs, and each
    result comes back to the executor's device in its declared dtype and
    shape."""
    shapes = [tuple(s) for s in attrs["out_shapes"]]
    dtypes = attrs["out_dtypes"]
    if ctx.abstract:
        return {"Out": [torch.empty(s, dtype=torch_dtype(d),
                                    device=ctx.device)
                        for s, d in zip(shapes, dtypes)]}
    out = _PY_FUNCS[attrs["func_id"]](
        *[x.detach().cpu().numpy() for x in ins.get("X", [])])
    if not isinstance(out, (list, tuple)):
        out = [out]
    res = []
    for o, s, d in zip(out, shapes, dtypes):
        a = np.asarray(o, dtype=d)
        if a.shape != s:
            raise ValueError(f"py_func returned shape {a.shape}, declared "
                             f"{s}")
        res.append(torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device))
    return {"Out": res}


@register_op("optimization_barrier", not_differentiable=True,
             grad_free=True)
def _optimization_barrier(ctx, ins, attrs):
    """The values pass through. XLA's barrier keeps the recompute
    transpiler's clones from being CSE'd away; eager torch has no CSE, so
    there is nothing to fence."""
    return {"Out": list(ins["X"])}
