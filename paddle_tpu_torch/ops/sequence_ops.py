"""Sequence ops on the dense [batch, seq, ...] + lengths representation.

Port of `paddle_tpu/ops/sequence_ops.py`: sequence_mask and the 14 ops
after it. Reference: operators/sequence_ops/ (5.3k LoC over LoD ragged
tensors, lod_tensor.h:104). Ragged sequences are padded dense tensors + a
lengths vector, as in the JAX package; every LoD op maps to a masked
dense op (SURVEY.md §7.3 "LoD/ragged via dense padding"). sequence_mask is
the bridge: lengths -> mask.
"""

import torch

from ..framework.registry import register_op, torch_dtype


@register_op("sequence_mask", not_differentiable=True, grad_free=True)
def _sequence_mask(ctx, ins, attrs):
    """reference: sequence_ops/sequence_mask_op.cc. maxlen must be static
    (the JAX rule's rule: the mask's shape is fixed when the program is
    built)."""
    x = ins["X"][0].reshape(-1)
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError("sequence_mask requires a static maxlen")
    steps = torch.arange(maxlen, device=x.device)
    mask = steps[None, :] < x[:, None]
    return {"Y": [mask.to(torch_dtype(attrs.get("out_dtype", "float32")))]}


def _norm_len(ins, x):
    """Normalized (lengths, masked_axis) from the optional Length input.

    Length of shape x.shape[:k] masks axis k.  1-level: Length [b] masks
    axis 1 of x [b, s, d].  Nested (2-level LoD, lod_tensor.py
    lod_to_nested_padded): inner Length [b, s1] masks axis 2 of x
    [b, s1, s2, d] — the op then works at the chosen LoD level with no
    other change (reference ops take a lod_level attr instead).  The
    fluid-style [b, 1] lengths column is squeezed to [b] (it would
    otherwise read as a nested mask over the feature axis); any other
    prefix mismatch is an error, not a silent misread."""
    if "Length" not in ins:
        return None, 1
    ln = ins["Length"][0]
    if tuple(ln.shape) != tuple(x.shape[:ln.ndim]):
        if ln.ndim == 2 and ln.shape[1] == 1 and ln.shape[0] == x.shape[0]:
            ln = ln[:, 0]
        else:
            raise ValueError(
                f"sequence op: Length shape {tuple(ln.shape)} must equal "
                f"x.shape[:{ln.ndim}] = {tuple(x.shape[:ln.ndim])} (or be "
                f"a [b, 1] column)")
    return ln, ln.ndim


def _len_mask(ins, x):
    """mask over the sequence axis from the optional Length input; shape
    x.shape[:axis+1] + (1,)*rest for broadcast."""
    ln, axis = _norm_len(ins, x)
    if ln is None:
        return None
    s = x.shape[axis]
    steps = torch.arange(s, device=x.device)
    m = steps[(None,) * axis + (slice(None),)] < ln[..., None]
    return m.reshape(tuple(m.shape) + (1,) * (x.ndim - axis - 1))


def _gather_axis(x, idx, axis):
    """take_along_axis over `axis` with an index of x.shape[:axis+1]
    broadcast over the trailing dims."""
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x.ndim - idx.ndim))
    shape = list(x.shape)
    shape[axis] = idx.shape[axis]
    return torch.gather(x, axis, idx.expand(shape).long())


@register_op("sequence_pool", no_grad_inputs={"Length"},
             non_diff_outputs={"MaxIndex"})
def _sequence_pool(ctx, ins, attrs):
    """reference: sequence_ops/sequence_pool_op.cc — types sum/average/
    sqrt/max/last/first over each sequence. MAX over an empty segment
    gives 0, not -inf."""
    x = ins["X"][0]  # [b, s, d...] or nested [b, s1, s2, d...]
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    ln, axis = _norm_len(ins, x)
    m = _len_mask(ins, x)
    ln = (ln.to(x.dtype) if ln is not None else
          torch.full(tuple(x.shape[:1]), x.shape[1], dtype=x.dtype,
                     device=x.device))
    extra = x.ndim - axis - 1
    ln_b = ln.reshape(tuple(ln.shape) + (1,) * extra)
    if ptype in ("SUM", "AVERAGE", "SQRT"):
        xm = x if m is None else x * m.to(x.dtype)
        tot = torch.sum(xm, dim=axis)
        if ptype == "SUM":
            out = tot
        elif ptype == "AVERAGE":
            out = tot / torch.clamp(ln_b, min=1)
        else:
            out = tot / torch.sqrt(torch.clamp(ln_b, min=1))
    elif ptype == "MAX":
        xm = x if m is None else torch.where(
            m, x, torch.full_like(x, -float("inf")))
        out = torch.amax(xm, dim=axis)
        if m is not None:  # all-empty segments must not emit -inf
            out = torch.where(ln_b > 0, out, torch.zeros_like(out))
    elif ptype == "LAST":
        idx = torch.clamp(ln - 1, min=0).to(torch.int64)
        out = _gather_axis(x, idx.unsqueeze(-1), axis).squeeze(axis)
    elif ptype == "FIRST":
        out = torch.select(x, axis, 0)
    else:
        raise NotImplementedError(f"sequence_pool type {ptype}")
    return {"Out": [out]}


@register_op("sequence_softmax", no_grad_inputs={"Length"})
def _sequence_softmax(ctx, ins, attrs):
    """reference: sequence_ops/sequence_softmax_op.cc — softmax over each
    sequence's valid positions."""
    x = ins["X"][0]  # [b, s] (or nested [b, s1, s2] with Length [b, s1])
    _, axis = _norm_len(ins, x[..., None])
    m = _len_mask(ins, x[..., None])
    dtype = x.dtype
    if m is not None:
        x = torch.where(m.squeeze(-1), x, torch.full_like(x, -1e30))
    out = torch.softmax(x.to(torch.float32), dim=axis).to(dtype)
    if m is not None:
        out = out * m.squeeze(-1).to(dtype)
    return {"Out": [out]}


@register_op("sequence_reverse", no_grad_inputs={"Length"})
def _sequence_reverse(ctx, ins, attrs):
    """reference: sequence_ops/sequence_reverse_op.cc — reverse each
    sequence's valid prefix, keep padding in place."""
    x = ins["X"][0]
    ln, axis = _norm_len(ins, x)
    if ln is None:
        return {"Y": [torch.flip(x, dims=[1])]}
    s = x.shape[axis]
    steps = torch.arange(s, device=x.device)[(None,) * axis + (slice(None),)]
    idx = torch.where(steps < ln[..., None], ln[..., None] - 1 - steps,
                      steps)
    return {"Y": [_gather_axis(x, idx, axis)]}


@register_op("sequence_expand", no_grad_inputs={"Y"})
def _sequence_expand(ctx, ins, attrs):
    """Dense analog of LodExpand (reference lod_tensor.h:152,
    sequence_ops/sequence_expand_op.cc with ref_lod/ref_level): broadcast
    each element of X across the matching segment of Y.  X [b, d] with Y
    [b, s, ...] -> [b, s, d]; nested X [b, s1, d] with Y [b, s1, s2, ...]
    -> [b, s1, s2, d] — the inserted axis is the one ref_level selects in
    the reference's LoD terms (here implied by X's rank, validated against
    the attr when given)."""
    x = ins["X"][0]
    y = ins["Y"][0]
    axis = x.ndim - 1  # new sequence axis sits before the feature dim
    ref_level = attrs.get("ref_level", -1)
    if ref_level not in (-1, axis - 1):
        raise ValueError(
            f"sequence_expand: X rank {x.ndim} expands at level {axis - 1}, "
            f"but ref_level={ref_level} was requested; reshape X to the "
            f"level you want to expand at (dense nested layout)")
    if y.ndim <= axis:
        raise ValueError("sequence_expand: Y must be deeper than X")
    s = y.shape[axis]
    return {"Out": [torch.unsqueeze(x, axis).expand(
        tuple(x.shape[:axis]) + (s,) + tuple(x.shape[axis:]))]}


@register_op("sequence_expand_as", no_grad_inputs={"Y"})
def _sequence_expand_as(ctx, ins, attrs):
    """reference: sequence_ops/sequence_expand_as_op.cc — repeat each
    per-sequence row of X to the length of the matching sequence in Y.
    Dense analog: X [b, d...] -> [b, s, d...] with s = Y.shape[1]; padded
    steps carry copies, which downstream masked ops ignore (identical to
    sequence_expand here because the dense rep pads to a common s)."""
    x = ins["X"][0]
    s = ins["Y"][0].shape[1]
    return {"Out": [x[:, None].expand((x.shape[0], s) + tuple(x.shape[1:]))]}


@register_op("sequence_reshape")
def _sequence_reshape(ctx, ins, attrs):
    """reference: sequence_ops/sequence_reshape_op.cc — keep the flat
    element stream, change the feature width to new_dim (each sequence's
    step count scales by in_width/new_dim). Dense analog:
    [b, s, d] -> [b, s*d/new_dim, new_dim]."""
    x = ins["X"][0]
    new_dim = int(attrs["new_dim"])
    b, s = x.shape[0], x.shape[1]
    d = 1
    for k in x.shape[2:]:
        d *= k
    if (s * d) % new_dim != 0:
        raise ValueError(
            f"sequence_reshape: seq_len*width ({s}*{d}) must be divisible "
            f"by new_dim ({new_dim})")
    return {"Out": [x.reshape(b, (s * d) // new_dim, new_dim)]}


@register_op("sequence_scatter", no_grad_inputs={"Ids"})
def _sequence_scatter(ctx, ins, attrs):
    """reference: sequence_ops/sequence_scatter_op.cc — per-sequence
    scatter-ADD: row i of X receives Updates[i] at columns Ids[i]. Dense
    analog: Ids/Updates are [b, s] (+ optional IdsLength masking padded
    slots)."""
    x = ins["X"][0]                             # [b, cols]
    ids = ins["Ids"][0].reshape(x.shape[0], -1).to(torch.int64)
    upd = ins["Updates"][0].reshape(ids.shape).to(x.dtype)
    if "IdsLength" in ins:
        ln = ins["IdsLength"][0].reshape(-1)
        valid = torch.arange(ids.shape[1], device=x.device)[None, :] \
            < ln[:, None]
        upd = torch.where(valid, upd, torch.zeros_like(upd))
    return {"Out": [x.scatter_add(1, ids, upd)]}


@register_op("sequence_concat")
def _sequence_concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=1)]}


@register_op("sequence_slice", no_grad_inputs={"Offset", "Length"})
def _sequence_slice(ctx, ins, attrs):
    x = ins["X"][0]
    off = int(attrs.get("offset", 0))
    ln = int(attrs["length"])
    return {"Out": [x[:, off:off + ln]]}


@register_op("sequence_pad", no_grad_inputs={"PadValue", "Length"},
             non_diff_outputs={"Length"})
def _sequence_pad(ctx, ins, attrs):
    # the dense rep is already padded; pass through with lengths
    x = ins["X"][0]
    ln = (ins["Length"][0] if "Length" in ins
          else torch.full((x.shape[0],), x.shape[1], dtype=torch.int64,
                          device=x.device))
    return {"Out": [x], "Length": [ln]}


@register_op("sequence_unpad", no_grad_inputs={"Length"})
def _sequence_unpad(ctx, ins, attrs):
    # the dense rep stays padded; mask invalid steps to zero
    x = ins["X"][0]
    m = _len_mask(ins, x)
    return {"Out": [x if m is None else x * m.to(x.dtype)]}


@register_op("sequence_enumerate", not_differentiable=True, grad_free=True)
def _sequence_enumerate(ctx, ins, attrs):
    x = ins["X"][0]  # [b, s] int ids
    win = attrs["win_size"]
    pad = attrs.get("pad_value", 0)
    b, s = x.shape
    cols = []
    for k in range(win):
        cols.append(torch.cat(
            [x[:, k:], torch.full((b, min(k, s)), pad, dtype=x.dtype,
                                  device=x.device)], dim=1)[:, :s])
    return {"Out": [torch.stack(cols, dim=-1)]}


@register_op("sequence_erase", not_differentiable=True, grad_free=True)
def _sequence_erase(ctx, ins, attrs):
    """Dense analog: replace erased tokens with pad (0) instead of
    compacting (static shapes)."""
    x = ins["X"][0]
    tokens = torch.tensor(list(attrs.get("tokens", [])), dtype=x.dtype,
                          device=x.device)
    hit = torch.isin(x, tokens)
    return {"Out": [torch.where(hit, torch.zeros_like(x), x)]}


@register_op("sequence_conv", no_grad_inputs={"XLength"})
def _sequence_conv(ctx, ins, attrs):
    """reference: sequence_ops/sequence_conv_op.cc — context-window conv:
    each step's feature is the concat of `context_length` neighbors
    (starting at context_start) projected by Filter
    [context_length * d, out]. Dense redesign: X [b, T, d] (+ XLength
    for zeroing padded steps)."""
    x = ins["X"][0]
    filt = ins["Filter"][0]
    clen = int(attrs.get("context_length", 3))
    cstart = int(attrs.get("context_start", -(clen // 2)))
    lengths = ins.get("XLength", [None])[0]
    b, t, d = x.shape
    if lengths is not None:
        lengths = lengths.reshape(-1).to(torch.int32)
        mask = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
        x = torch.where(mask[:, :, None], x, torch.zeros_like(x))
    cols = []
    for k in range(clen):
        off = cstart + k
        if off < 0:
            sl = torch.nn.functional.pad(x, (0, 0, -off, 0))[:, :t]
        elif off > 0:
            sl = torch.nn.functional.pad(x[:, off:], (0, 0, 0, off))
        else:
            sl = x
        cols.append(sl)
    ctx_feat = torch.cat(cols, dim=-1)              # [b, T, clen*d]
    out = torch.einsum("btc,co->bto", ctx_feat, filt)
    if lengths is not None:
        out = torch.where(mask[:, :, None], out, torch.zeros_like(out))
    return {"Out": [out]}
