"""Ops of `paddle_tpu/ops/extra_ops.py`, every rule of the file by name:
eye (:17), fill (:25), minus (:32), l1_norm (:37), squared_l2_distance
(:42), label_smooth (:52), selu (:66, the JAX registry's final selu), crop
(:74), reverse (:91), flatten (:97), squeeze (:105), unsqueeze (:116),
pad_constant_like (:124), multiplex (:133), is_empty (:141), mean_iou
(:147), conv_shift (:167), the two *_batch_size_like random ops
(:181-200), hash (:203), unique (:227), unique_with_counts (:243),
edit_distance (:255), coalesce_tensor (:303), delete_var (:313), the three
SelectedRows helpers (:323-367), average_accumulates (:370),
dgc_clip_by_norm (:410) and quantize/dequantize/requantize (:428-448).

Differentiable rules take the generic vjp path; the others have no
gradient, as in JAX. JAX's fixed sizes are kept: unique and
unique_with_counts return x's length, the sorted distinct values first
and then x[0] (jnp.unique(..., size=n, fill_value=x[0]); counts 0 in the
padding), merge_selected_rows the sorted distinct rows padded with -1.
Their groups, mean_iou's histograms and the SelectedRows sums are
sort-based index_put_ scatters (no atomics: a rerun on the card gives
the same bits). hash is JAX's uint32 mix computed in int64 with every
product split into 16-bit halves and masked to 32 bits. edit_distance
runs one step per hypothesis token, each row's left-to-right recurrence
closed by a cummin, with nothing read back to the host. The random ops
draw on the run's torch.Generator (other numbers than JAX's keys).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..framework.registry import register_op, torch_dtype
from ..framework.selected_rows import SelectedRows, scatter_add
from .detection_ops import _true_div


@register_op("eye", not_differentiable=True, grad_free=True)
def _eye(ctx, ins, attrs):
    n = int(attrs["num_rows"])
    m = int(attrs.get("num_columns", -1))
    return {"Out": [torch.eye(n, n if m < 0 else m,
                              dtype=torch_dtype(attrs.get("dtype",
                                                          "float32")),
                              device=ctx.device)]}


@register_op("label_smooth", no_grad_inputs={"PriorDist"})
def _label_smooth(ctx, ins, attrs):
    """reference: label_smooth_op.h: (1 - eps) y + eps / K, or + eps
    prior with PriorDist."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    prior = ins.get("PriorDist", [None])[0]
    if prior is None:
        return {"Out": [(1.0 - eps) * x + eps / x.shape[-1]]}
    return {"Out": [(1.0 - eps) * x + eps * prior.reshape(
        (1,) * (x.ndim - 1) + (-1,))]}


@register_op("selu")
def _selu(ctx, ins, attrs):
    scale = attrs.get("scale", 1.0507009873554804934193349852946)
    alpha = attrs.get("alpha", 1.6732632423543772848170429916717)
    x = ins["X"][0]
    return {"Out": [scale * torch.where(x > 0, x, alpha * torch.expm1(x))]}


@register_op("reverse")
def _reverse(ctx, ins, attrs):
    return {"Out": [torch.flip(ins["X"][0],
                               tuple(int(a) for a in attrs.get("axis",
                                                               [0])))]}


@register_op("is_empty", not_differentiable=True, grad_free=True)
def _is_empty(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.tensor([x.numel() == 0], device=x.device)]}


# ---------------------------------------------------------------------------
# simple tensor / math (reference: fill_op.cc, minus_op.cc, ...)
# ---------------------------------------------------------------------------

@register_op("fill", not_differentiable=True, grad_free=True)
def _fill(ctx, ins, attrs):
    """reference: fill_op.cc — fill Out with a literal value list."""
    vals = np.asarray(attrs["value"], dtype=attrs.get("dtype", "float32"))
    return {"Out": [torch.from_numpy(vals.reshape(attrs["shape"]).copy())
                    .to(ctx.device)]}


@register_op("minus")
def _minus(ctx, ins, attrs):
    return {"Out": [ins["X"][0] - ins["Y"][0]]}


@register_op("l1_norm")
def _l1_norm(ctx, ins, attrs):
    """sum |x|, written so that the slope at 0 is 1, jnp.abs's."""
    x = ins["X"][0]
    return {"Out": [torch.where(x >= 0, x, -x).sum()[None]]}


@register_op("squared_l2_distance")
def _squared_l2_distance(ctx, ins, attrs):
    """reference: squared_l2_distance_op.h — per-row ||x-y||^2; also
    emits the sub result for the grad."""
    x, y = ins["X"][0], ins["Y"][0]
    sub = x - y
    out = (sub * sub).reshape(x.shape[0], -1).sum(dim=1, keepdim=True)
    return {"Out": [out], "sub_result": [sub]}


@register_op("crop", no_grad_inputs={"Y", "Offsets"})
def _crop(ctx, ins, attrs):
    """reference: crop_op.cc — crop X to `shape` starting at `offsets`
    (attr list, or the runtime Offsets input tensor, whose starts are
    taken as lax.dynamic_slice takes them: a negative start counts from
    the end, then each start is clamped into range)."""
    x = ins["X"][0]
    shape = [int(s) for s in (attrs.get("shape")
                              or list(ins["Y"][0].shape))]
    if "Offsets" in ins:
        off = ins["Offsets"][0].reshape(-1).long()
        out = x
        for i, s in enumerate(shape):
            start = torch.where(off[i] < 0, off[i] + x.shape[i], off[i])
            start = start.clamp(0, x.shape[i] - s)
            out = out.index_select(i, start + torch.arange(
                s, device=x.device))
        return {"Out": [out]}
    offsets = attrs.get("offsets") or [0] * x.ndim
    idx = tuple(slice(int(o), int(o) + int(s))
                for o, s in zip(offsets, shape))
    return {"Out": [x[idx]]}


@register_op("flatten")
def _flatten(ctx, ins, attrs):
    x = ins["X"][0]
    ax = int(attrs.get("axis", 1))
    lead = int(np.prod(x.shape[:ax])) if ax > 0 else 1
    return {"Out": [x.reshape(lead, -1)]}


@register_op("squeeze")
def _squeeze(ctx, ins, attrs):
    x = ins["X"][0]
    axes = [int(a) for a in attrs.get("axes", [])]
    if not axes:
        return {"Out": [torch.squeeze(x)]}
    axes = [a % x.ndim for a in axes]
    keep = [d for i, d in enumerate(x.shape)
            if not (i in axes and d == 1)]
    return {"Out": [x.reshape(keep)]}


@register_op("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    x = ins["X"][0]
    for a in sorted(int(a) for a in attrs["axes"]):
        x = torch.unsqueeze(x, a)
    return {"Out": [x]}


@register_op("pad_constant_like", no_grad_inputs={"X"})
def _pad_constant_like(ctx, ins, attrs):
    """reference: pad_constant_like_op.cc — pad Y up to X's shape."""
    x, y = ins["X"][0], ins["Y"][0]
    pads = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        pads += [0, xs - ys]
    return {"Out": [F.pad(y, pads, value=attrs.get("pad_value", 0.0))]}


@register_op("multiplex", no_grad_inputs={"Ids"})
def _multiplex(ctx, ins, attrs):
    """reference: multiplex_op.cc — Out[i] = X[Ids[i]][i]."""
    ids = ins["Ids"][0].reshape(-1).long()
    xs = torch.stack(ins["X"], dim=0)             # [k, n, d]
    return {"Out": [xs[ids, torch.arange(xs.shape[1], device=xs.device)]]}


@register_op("mean_iou", not_differentiable=True, grad_free=True)
def _mean_iou(ctx, ins, attrs):
    """reference: mean_iou_op.h — segmentation mean IoU over classes.
    The three histograms are scatter-adds into k + 1 bins whose last
    takes the dropped indices (JAX's mode="drop"; a negative index wraps
    first, as .at[] normalises it)."""
    pred = ins["Predictions"][0].reshape(-1).long()
    label = ins["Labels"][0].reshape(-1).long()
    k = int(attrs["num_classes"])

    def hist(idx):
        idx = torch.where(idx < 0, idx + k, idx)
        idx = torch.where((idx >= 0) & (idx < k), idx, k)
        return scatter_add(torch.zeros(k + 1, dtype=torch.long,
                                       device=idx.device), idx,
                           torch.ones_like(idx))[:k]

    inter = hist(torch.where(pred == label, pred, k))
    pred_cnt = hist(pred)
    lab_cnt = hist(label)
    union = pred_cnt + lab_cnt - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp_min(union, 1),
                      torch.zeros((), device=pred.device))
    miou = iou.sum() / torch.clamp_min(valid.sum(), 1)
    return {"OutMeanIou": [miou.to(torch.float32)[None]],
            "OutWrong": [(pred_cnt - inter).to(torch.int32)],
            "OutCorrect": [inter.to(torch.int32)]}


@register_op("conv_shift")
def _conv_shift(ctx, ins, attrs):
    """reference: conv_shift_op.cc — circular correlation (NTM shift):
    X [b, d], Y [b, m] (m odd) -> Out[b, i] = sum_j X[b, (i+j-m/2) % d]
    * Y[b, j]."""
    x, y = ins["X"][0], ins["Y"][0]
    d, m = x.shape[1], y.shape[1]
    idx = (torch.arange(d, device=x.device)[:, None]
           + torch.arange(m, device=x.device)[None, :] - m // 2) % d
    return {"Out": [(x[:, idx] * y[:, None, :]).sum(-1)]}


def _bsl_shape(ins, attrs):
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ins["Input"][0].shape[attrs.get("input_dim_idx", 0)]
    return tuple(shape)


@register_op("uniform_random_batch_size_like", not_differentiable=True,
             grad_free=True, stateful=True)
def _uniform_random_bsl(ctx, ins, attrs):
    shape = _bsl_shape(ins, attrs)
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    if ctx.abstract:
        return {"Out": [torch.empty(shape, device=ctx.device)]}
    u = torch.rand(shape, generator=ctx.rng(), device=ctx.device)
    return {"Out": [lo + (hi - lo) * u]}


@register_op("gaussian_random_batch_size_like", not_differentiable=True,
             grad_free=True, stateful=True)
def _gaussian_random_bsl(ctx, ins, attrs):
    shape = _bsl_shape(ins, attrs)
    if ctx.abstract:
        return {"Out": [torch.empty(shape, device=ctx.device)]}
    z = torch.randn(shape, generator=ctx.rng(), device=ctx.device)
    return {"Out": [attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z]}


_M32 = 0xFFFFFFFF


def _mul32(v, c):
    """(v * c) mod 2^32 for v in [0, 2^32) and a constant c < 2^32: c
    split into 16-bit halves, so no int64 product passes 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (v * lo + (((v * hi) & 0xFFFF) << 16)) & _M32


def _mix(v, salt):
    v = _mul32(v ^ (v >> 16), 0x7feb352d)
    v = _mul32(v ^ (v >> 15), 0x846ca68b + salt)
    return v ^ (v >> 16)


@register_op("hash", not_differentiable=True, grad_free=True)
def _hash(ctx, ins, attrs):
    """reference: hash_op.cc (xxhash of int ids into num_hash buckets);
    JAX's redesign, a splitmix-style uint32 mix of each id row (ids wrap
    to uint32 first, as astype(uint32) wraps them), in int64 here."""
    x = ins["X"][0].long() & _M32
    num_hash = int(attrs.get("num_hash", 1))
    mod_by = int(attrs.get("mod_by", 1 << 31))
    rows = x.reshape(x.shape[0], -1)
    outs = []
    for i in range(num_hash):
        h = torch.full((rows.shape[0],), 2166136261 + i, dtype=torch.long,
                       device=x.device)
        for c in range(rows.shape[1]):
            h = _mix(h ^ rows[:, c], i)
        outs.append(h % mod_by)
    return {"Out": [torch.stack(outs, dim=1)[:, :, None]]}


def _unique_padded(x, fill):
    """jnp.unique(x, return_inverse=True, return_counts=True, size=n,
    fill_value=fill) of a 1-D x: the sorted distinct values then `fill`
    (a [1] tensor) to length n, each element's position among them, and
    the counts (0 in the padding)."""
    n = x.shape[0]
    s, order = torch.sort(x, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=x.device)
    first[1:] = s[1:] != s[:-1]
    gid = torch.cumsum(first.long(), 0) - 1
    uniq = fill.expand(n).clone().index_put_((gid,), s)
    inverse = torch.empty_like(gid).scatter_(0, order, gid)
    counts = scatter_add(torch.zeros(n, dtype=torch.long, device=x.device),
                         gid, torch.ones_like(gid))
    return uniq, inverse, counts


@register_op("unique", not_differentiable=True, grad_free=True)
def _unique(ctx, ins, attrs):
    """reference: unique_op.cc. JAX's fixed-size form: Out is X's size,
    the SORTED distinct values first (what jnp.unique(..., size=n,
    fill_value=x[0]) returns, not first-occurrence order) and X[0] in the
    rest; Index maps X -> position in Out; Count the number of distinct
    values."""
    x = ins["X"][0].reshape(-1)
    if not x.shape[0]:
        return {"Out": [x.clone()],
                "Index": [torch.zeros(0, dtype=torch.int32,
                                      device=x.device)],
                "Count": [torch.zeros(1, dtype=torch.int32,
                                      device=x.device)]}
    uniq, inverse, counts = _unique_padded(x, x[:1])
    return {"Out": [uniq], "Index": [inverse.to(torch.int32)],
            "Count": [(counts > 0).sum().to(torch.int32)[None]]}


@register_op("unique_with_counts", not_differentiable=True, grad_free=True)
def _unique_with_counts(ctx, ins, attrs):
    """unique's Out and Index, and Count each value's count (0 in the
    padding)."""
    x = ins["X"][0].reshape(-1)
    if not x.shape[0]:
        empty = torch.zeros(0, dtype=torch.int32, device=x.device)
        return {"Out": [x.clone()], "Index": [empty], "Count": [empty]}
    uniq, inverse, counts = _unique_padded(x, x[:1])
    return {"Out": [uniq], "Index": [inverse.to(torch.int32)],
            "Count": [counts.to(torch.int32)]}


@register_op("edit_distance", not_differentiable=True, grad_free=True)
def _edit_distance(ctx, ins, attrs):
    """reference: edit_distance_op.h (Levenshtein). Dense redesign:
    Hyps [n, Th] + HypsLength [n], Refs [n, Tr] + RefsLength [n]. One
    step per hypothesis token i (JAX: a scan over rows of a scan over
    columns): a[j] = min(up + 1, diag + cost) with a[0] = i, then the row
    D[j] = min(D[j-1] + 1, a[j]) = j + min_{k<=j}(a[k] - k), a cummin;
    rows past a hypothesis' length keep the row before, and the length
    clamps are JAX's. Float32 distances, exact for integers."""
    hyp = ins["Hyps"][0].long()
    ref = ins["Refs"][0].long()
    n, th = hyp.shape
    tr = ref.shape[1]
    dev = hyp.device
    hyp_len = ins["HypsLength"][0].reshape(-1).long() \
        if "HypsLength" in ins else torch.full((n,), th, device=dev)
    ref_len = ins["RefsLength"][0].reshape(-1).long() \
        if "RefsLength" in ins else torch.full((n,), tr, device=dev)
    seq_num = torch.full((1,), n, dtype=torch.long, device=dev)
    if ctx.abstract:
        return {"Out": [torch.empty((n, 1), device=dev)],
                "SequenceNum": [seq_num]}
    cols = torch.arange(tr + 1, dtype=torch.float32, device=dev)
    prev = cols.expand(n, tr + 1)
    for i in range(1, th + 1):
        cost = (hyp[:, i - 1:i] != ref).to(torch.float32)     # [n, tr]
        a = torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost)
        a = torch.cat([torch.full((n, 1), float(i), device=dev), a], 1)
        row = cols + torch.cummin(a - cols, dim=1).values
        prev = torch.where((i <= hyp_len)[:, None], row, prev)
    d = prev.gather(1, ref_len.clamp(0, tr)[:, None])[:, 0]
    d = torch.where(hyp_len == 0, ref_len.to(torch.float32), d)
    d = torch.where(ref_len == 0, hyp_len.to(torch.float32), d)
    if bool(attrs.get("normalized", False)):
        d = d / torch.clamp_min(ref_len, 1)
    return {"Out": [d[:, None]], "SequenceNum": [seq_num]}


@register_op("coalesce_tensor", not_differentiable=True, grad_free=True)
def _coalesce_tensor(ctx, ins, attrs):
    """reference: coalesce_tensor_op.cc — fuse a var list into one flat
    buffer; here a concatenated copy, the inputs passed through."""
    xs = ins["Input"]
    return {"Output": list(xs),
            "FusedOutput": [torch.cat([x.reshape(-1) for x in xs])]}


@register_op("delete_var", not_differentiable=True, grad_free=True)
def _delete_var(ctx, ins, attrs):
    """reference: controlflow/ — frees vars; the executor's environment
    drops them at the step's end."""
    return {}


# ---------------------------------------------------------------------------
# SelectedRows utilities (reference: merge_selected_rows_op.cc, ...)
# ---------------------------------------------------------------------------

@register_op("merge_selected_rows", not_differentiable=True, grad_free=True)
def _merge_selected_rows(ctx, ins, attrs):
    """Sum duplicate rows of a SelectedRows value, JAX's fixed size: the
    sorted distinct rows padded with -1, each one's values summed in row
    order (a sort-based index_put_), zeros in the padding."""
    x = ins["X"][0]
    if not isinstance(x, SelectedRows):
        return {"Out": [x]}
    rows = x.rows
    uniq, inverse, _ = _unique_padded(
        rows, torch.full((1,), -1, dtype=rows.dtype, device=rows.device))
    summed = scatter_add(torch.zeros_like(x.values), inverse, x.values)
    return {"Out": [SelectedRows(uniq, summed, x.height)]}


@register_op("get_tensor_from_selected_rows", not_differentiable=True,
             grad_free=True)
def _get_tensor_from_selected_rows(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.values if isinstance(x, SelectedRows) else x]}


@register_op("split_selected_rows", not_differentiable=True, grad_free=True)
def _split_selected_rows(ctx, ins, attrs):
    """reference: split_selected_rows_op.cc — shard rows by height
    sections (PS param split). Fixed-size: each shard keeps the full row
    list with out-of-section rows marked -1 / zeroed."""
    x = ins["X"][0]
    outs = []
    start = 0
    for sec in (int(s) for s in attrs["height_sections"]):
        if isinstance(x, SelectedRows):
            in_sec = (x.rows >= start) & (x.rows < start + sec)
            rows = torch.where(in_sec, x.rows - start,
                               torch.full_like(x.rows, -1))
            vals = torch.where(in_sec[:, None], x.values,
                               torch.zeros((), dtype=x.values.dtype,
                                           device=x.values.device))
            outs.append(SelectedRows(rows, vals, sec))
        else:
            outs.append(x[start:start + sec])
        start += sec
    return {"Out": outs}


@register_op("average_accumulates", not_differentiable=True,
             is_optimizer_op=True)
def _average_accumulates(ctx, ins, attrs):
    """reference: average_accumulates_op.h — the ModelAverage op's
    running parameter-sum accumulators."""
    param = ins["param"][0]
    sum1 = ins["in_sum_1"][0]
    sum2 = ins["in_sum_2"][0]
    sum3 = ins["in_sum_3"][0]
    num_acc = ins["in_num_accumulates"][0]
    old_num = ins["in_old_num_accumulates"][0]
    num_upd = ins["in_num_updates"][0]
    avg_window = attrs.get("average_window", 0.0)
    max_avg = int(attrs.get("max_average_window", 10000))
    min_avg = int(attrs.get("min_average_window", 10000))

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    sum1 = sum1 + param
    window = torch.clamp_max(torch.clamp_min(avg_window * num_upd, min_avg),
                             max_avg).to(num_acc.dtype)
    roll = num_acc > window
    sum2 = torch.where(roll, sum2 + sum1, sum2)
    sum3_new = torch.where(old_num + num_acc > max_avg, sum2, sum3)
    old_num2 = torch.where(roll, num_acc, old_num)
    sum1 = torch.where(roll, torch.zeros_like(sum1), sum1)
    num_acc = torch.where(roll, torch.zeros_like(num_acc), num_acc)
    return {"out_sum_1": [sum1], "out_sum_2": [sum2],
            "out_sum_3": [sum3_new],
            "out_num_accumulates": [num_acc],
            "out_old_num_accumulates": [old_num2],
            "out_num_updates": [num_upd]}


@register_op("dgc_clip_by_norm", not_differentiable=True, grad_free=True)
def _dgc_clip_by_norm(ctx, ins, attrs):
    """reference: dgc_clip_by_norm_op.cc — clip_by_norm gated on the
    current step vs the DGC rampup begin step."""
    x = ins["X"][0]
    step = ins["current_step"][0].reshape(())
    rampup = attrs.get("rampup_begin_step", 0.0)
    max_norm = torch.full((), attrs.get("max_norm", 1.0), dtype=x.dtype,
                          device=x.device)
    norm = torch.sqrt((x * x).sum())
    clipped = x * torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12),
                                  1.0)
    return {"Out": [torch.where(step < rampup, x, clipped)]}


# ---------------------------------------------------------------------------
# int8 quantization trio (reference: quantize_op.cc, dequantize_op.cc,
# requantize_op.cc — scale-based symmetric int8); torch.round rounds half
# to even, as jnp.round does
# ---------------------------------------------------------------------------

@register_op("quantize", not_differentiable=True, grad_free=True)
def _quantize(ctx, ins, attrs):
    scale = attrs.get("Scale", 1.0)
    shift = attrs.get("Shift", 0.0)
    # qmax < 127 (sub-8-bit simulation) saturates at its own grid edge
    qmax = float(attrs.get("qmax", 127))
    x = ins["Input"][0]
    q = torch.clamp(torch.round(x * scale + shift), -qmax - 1, qmax)
    return {"Output": [q.to(torch.int8)]}


@register_op("dequantize", not_differentiable=True, grad_free=True)
def _dequantize(ctx, ins, attrs):
    x = ins["Input"][0].to(torch.float32)
    return {"Output": [_true_div(x - attrs.get("Shift", 0.0),
                                 attrs.get("Scale", 1.0))]}


@register_op("requantize", not_differentiable=True, grad_free=True)
def _requantize(ctx, ins, attrs):
    x = ins["Input"][0].to(torch.float32)
    q = torch.round(_true_div(x * attrs.get("Scale_out", 1.0),
                              attrs.get("Scale_in", 1.0)))
    return {"Output": [torch.clamp(q, -128, 127).to(torch.int8)]}
