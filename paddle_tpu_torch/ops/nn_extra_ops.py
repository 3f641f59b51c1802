"""NN long-tail ops: spatial transformers, RoI variants, CTR/rank ops,
LSTM variants (reference: paddle/fluid/operators/*_op.cc).

Port of `paddle_tpu/ops/nn_extra_ops.py` by name (affine_channel:16,
affine_grid:27, grid_sampler:48, random_crop:80, max_pool2d_with_index:130,
unpool:141, spp:157, psroi_pool:184, cvm:243, data_norm:257, fsp:272,
similarity_focus:284, positive_negative_pair:306, filter_by_instag:330,
match_matrix_tensor:346, center_loss:361, sample_logits:384 with its
grad_lower :428, lstm_unit:447, lstmp:466, the lstm/gru aliases :525-526,
row_conv:529, fc:543, sync_batch_norm:558, deformable_conv:604,
tree_conv:682, attention_lstm:755), with JAX's marks. Grads take the
generic torch.func.vjp path except sample_logits' (JAX's explicit
scatter-add).

Every gather is an advanced-indexing read and every scatter-add an
`index_put_(accumulate=True)` (`framework.selected_rows.scatter_add`):
sort-based on CUDA, no atomics, so the bilinear samplers' and the pools'
backward and center_loss's centre update rerun bitwise on the card
(`F.grid_sample` and `F.max_unpool2d` would add with atomics).
deformable_conv gathers its four bilinear corners in one read of the
input laid out [n, h, w, group, channels], so the columns come out
[n * oh * ow, group * taps * channels] for one GEMM with the filter.
psroi_pool sums each bin as rows-mask x plane x columns-mask (two
batched matmuls), JAX's masked plane sum without its [RoIs, bins, h, w]
mask. random_crop and sample_logits' log-uniform sampler draw on the
run's torch.Generator (other numbers than JAX's keys, ROADMAP §C).
"""

import torch
import torch.nn.functional as F

from ..framework.registry import get_op_def, register_op
from ..framework.selected_rows import scatter_add
from .detection_ops import _batch_index, _true_div
from .nn_ops import linspace_f32

# ---------------------------------------------------------------------------
# channel/spatial transforms
# ---------------------------------------------------------------------------


@register_op("affine_channel", no_grad_inputs={"Scale", "Bias"})
def _affine_channel(ctx, ins, attrs):
    """reference: affine_channel_op.cc — x * scale[c] + bias[c]."""
    x = ins["X"][0]
    scale = ins["Scale"][0].reshape(-1)
    bias = ins["Bias"][0].reshape(-1)
    layout = attrs.get("data_layout", "NCHW")
    shape = (1, -1, 1, 1) if layout == "NCHW" else (1, 1, 1, -1)
    return {"Out": [x * scale.reshape(shape) + bias.reshape(shape)]}


@register_op("affine_grid")
def _affine_grid(ctx, ins, attrs):
    """reference: affine_grid_op.cc — theta [n,2,3] -> sampling grid
    [n,h,w,2] in normalized [-1,1] coords (align_corners semantics)."""
    theta = ins["Theta"][0]
    hw = attrs.get("output_shape")
    if not hw:
        raise ValueError("affine_grid needs the static output_shape "
                         "attr ([n, c, h, w])")
    h, w = int(hw[2]), int(hw[3])
    ys = linspace_f32(-1.0, 1.0, h, theta.device)
    xs = linspace_f32(-1.0, 1.0, w, theta.device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")      # [h, w]
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return {"Output": [torch.einsum("hwk,nak->nhwa", base,
                                    theta.to(base.dtype))]}


def _corner_read(xl, b, yy, xx, h, w):
    """Values of xl [n, h, w, ...] at the integer-valued float corners
    (yy, xx) of image b: an advanced-indexing read of the clipped corner,
    and 1 where the corner lies in the image, the far edge (h - 1)
    included, else 0."""
    ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
    return xl[b, yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()], \
        ok.to(xl.dtype)


@register_op("grid_sampler")
def _grid_sampler(ctx, ins, attrs):
    """reference: grid_sampler_op.cc — bilinear sample X [n,c,h,w] at
    Grid [n,gh,gw,2] (normalized [-1,1], align_corners)."""
    x, grid = ins["X"][0], ins["Grid"][0]
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0     # [n, gh, gw]
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    lx = gx - x0
    ly = gy - y0
    xl = x.permute(0, 2, 3, 1)                    # [n, h, w, c]
    b = torch.arange(n, device=x.device)[:, None, None]

    def tap(yy, xx):
        v, ok = _corner_read(xl, b, yy, xx, h, w)
        return v * ok[..., None]                  # [n, gh, gw, c]

    ly, lx = ly[..., None], lx[..., None]
    out = (tap(y0, x0) * (1 - ly) * (1 - lx)
           + tap(y0, x0 + 1) * (1 - ly) * lx
           + tap(y0 + 1, x0) * ly * (1 - lx)
           + tap(y0 + 1, x0 + 1) * ly * lx)
    return {"Output": [out.permute(0, 3, 1, 2).contiguous()]}


@register_op("random_crop", not_differentiable=True, grad_free=True,
             stateful=True)
def _random_crop(ctx, ins, attrs):
    """reference: random_crop_op.h — crop trailing dims to `shape` at a
    random offset, drawn on the run's generator and applied on the
    device (an index read; nothing comes back to the host)."""
    x = ins["X"][0]
    shape = [int(s) for s in attrs["shape"]]
    lead = x.ndim - len(shape)
    if ctx.abstract:
        return {"Out": [x.new_empty(tuple(x.shape[:lead]) + tuple(shape))]}
    g = ctx.rng()
    out = x
    for i, s in enumerate(shape):
        hi = x.shape[lead + i] - s
        start = torch.randint(0, hi + 1, (1,), generator=g,
                              device=x.device)
        idx = start + torch.arange(s, device=x.device)
        out = out.index_select(lead + i, idx)
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# pooling variants
# ---------------------------------------------------------------------------

def _maxpool_with_index(x, ksize, strides, paddings):
    n, c, h, w = x.shape
    kh, kw = ksize
    sh, sw = strides
    ph, pw = paddings
    xp = F.pad(x, (pw, pw, ph, ph), value=float("-inf"))
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    dev = x.device
    iy = (torch.arange(oh, device=dev) * sh)[:, None] \
        + torch.arange(kh, device=dev)[None, :]
    ix = (torch.arange(ow, device=dev) * sw)[:, None] \
        + torch.arange(kw, device=dev)[None, :]
    win = xp[:, :, iy[:, None, :, None], ix[None, :, None, :]]
    win = win.reshape(n, c, oh, ow, kh * kw)
    # the first maximum (jnp.argmax's); amax's gradient splits a tie
    # evenly, as jnp.max's does
    arg = torch.argmax(win, dim=-1)
    val = torch.amax(win, dim=-1)
    ky = torch.div(arg, kw, rounding_mode="floor")
    kx = arg % kw
    gy = (torch.arange(oh, device=dev) * sh)[None, None, :, None] + ky - ph
    gx = (torch.arange(ow, device=dev) * sw)[None, None, None, :] + kx - pw
    flat = gy.clamp(0, h - 1) * w + gx.clamp(0, w - 1)
    return val, flat.to(torch.int32)


@register_op("max_pool2d_with_index", non_diff_outputs={"Mask"})
def _max_pool2d_with_index(ctx, ins, attrs):
    """reference: pool_with_index_op.cc (registers max_pool2d_with_index);
    Mask is the flat index into the unpadded input."""
    x = ins["X"][0]
    val, mask = _maxpool_with_index(
        x, [int(k) for k in attrs["ksize"]],
        [int(s) for s in attrs.get("strides", [1, 1])],
        [int(p) for p in attrs.get("paddings", [0, 0])])
    return {"Out": [val], "Mask": [mask]}


@register_op("unpool", no_grad_inputs={"Indices"})
def _unpool(ctx, ins, attrs):
    """reference: unpool_op.cc — max-unpooling: X added back at the
    positions recorded in Indices (repeats add, as JAX's .at[].add)."""
    x, idx = ins["X"][0], ins["Indices"][0]
    n, c, h, w = x.shape
    oh, ow = [int(s) for s in attrs["unpooled_size"]] \
        if "unpooled_size" in attrs else (h * 2, w * 2)
    plane = torch.arange(n * c, device=x.device).reshape(n, c, 1) * (oh * ow)
    flat = (idx.reshape(n, c, -1).long() + plane).reshape(-1)
    out = x.new_zeros((n * c * oh * ow,))
    out = scatter_add(out, flat, x.reshape(-1))
    return {"Out": [out.reshape(n, c, oh, ow)]}


@register_op("spp")
def _spp(ctx, ins, attrs):
    """reference: spp_op.cc — spatial pyramid pooling: levels 0..L-1 pool
    into 2^l x 2^l bins, concat flattened."""
    x = ins["X"][0]
    levels = int(attrs.get("pyramid_height", 2))
    ptype = attrs.get("pooling_type", "max")
    n, c, h, w = x.shape
    outs = []
    for lv in range(levels):
        bins = 2 ** lv
        kh, kw = -(-h // bins), -(-w // bins)
        ph = (kh * bins - h + 1) // 2
        pw = (kw * bins - w + 1) // 2
        pad_val = float("-inf") if ptype == "max" else 0.0
        xp = F.pad(x, (pw, kw * bins - w - pw, ph, kh * bins - h - ph),
                   value=pad_val)
        win = xp.reshape(n, c, bins, kh, bins, kw)
        v = win.amax(dim=(3, 5)) if ptype == "max" else win.mean(dim=(3, 5))
        outs.append(v.reshape(n, -1))
    return {"Out": [torch.cat(outs, dim=1)]}


@register_op("psroi_pool", no_grad_inputs={"ROIs", "RoisNum"})
def _psroi_pool(ctx, ins, attrs):
    """reference: psroi_pool_op.h — position-sensitive RoI average pool:
    X [n, C*ph*pw, h, w], each output bin (i,j) pools its OWN channel
    group. RoisNum [n] maps each RoI to its image (as in roi_align);
    without it all RoIs pool from image 0. A bin's window is a rows mask
    times a columns mask, so its sum is mask_h . plane . mask_w: per
    image one batched matmul over the rows, then one over the columns."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    rois_num = ins.get("RoisNum", [None])[0]
    ph = int(attrs["pooled_height"])
    pw = int(attrs["pooled_width"])
    oc = int(attrs["output_channels"])
    scale = attrs.get("spatial_scale", 1.0)
    n, c, h, w = x.shape
    r = rois.shape[0]
    dev = x.device
    bi = _batch_index(rois_num, n, r, dev)
    x1 = torch.round(rois[:, 0]) * scale
    y1 = torch.round(rois[:, 1]) * scale
    x2 = (torch.round(rois[:, 2]) + 1) * scale
    y2 = (torch.round(rois[:, 3]) + 1) * scale
    bh = _true_div(torch.clamp_min(y2 - y1, 0.1), ph)
    bw = _true_div(torch.clamp_min(x2 - x1, 0.1), pw)

    def mask(start, size, bins, extent):
        i = torch.arange(bins, device=dev, dtype=start.dtype)
        lo = torch.floor(start[:, None] + i * size[:, None])
        hi = torch.ceil(start[:, None] + (i + 1) * size[:, None])
        pos = torch.arange(extent, device=dev)
        return ((pos >= lo.clamp(0, extent)[..., None])
                & (pos < hi.clamp(0, extent)[..., None])).to(x.dtype)

    mh = mask(y1, bh, ph, h)                      # [r, ph, h]
    mw = mask(x1, bw, pw, w)                      # [r, pw, w]
    cnt = torch.clamp_min(mh.sum(-1)[:, :, None] * mw.sum(-1)[:, None, :],
                          1.0)                    # [r, ph, pw]
    planes = x.reshape(n, oc, ph, pw, h, w)
    out = None
    for img in range(n):
        sel = (bi == img).to(x.dtype)[:, None, None]
        rows = torch.einsum("riy,cijyx->rcijx", mh * sel, planes[img])
        part = torch.einsum("rcijx,rjx->rcij", rows, mw)
        out = part if out is None else out + part
    return {"Out": [out / cnt[:, None]]}


# ---------------------------------------------------------------------------
# CTR / ranking / distillation
# ---------------------------------------------------------------------------

@register_op("cvm")
def _cvm(ctx, ins, attrs):
    """reference: cvm_op.h — click-through feature transform. X [n, d]
    whose first two columns are (show, click)."""
    x = ins["X"][0]
    if bool(attrs.get("use_cvm", True)):
        c0 = torch.log(x[:, 0] + 1)
        c1 = torch.log(x[:, 1] + 1) - c0
        return {"Y": [torch.cat([c0[:, None], c1[:, None], x[:, 2:]],
                                dim=1)]}
    return {"Y": [x[:, 2:]]}


@register_op("data_norm", non_diff_outputs={"Means", "Scales"},
             no_grad_inputs={"BatchSize", "BatchSum", "BatchSquareSum"})
def _data_norm(ctx, ins, attrs):
    """reference: data_norm_op.cc — normalize by externally-accumulated
    batch statistics (CTR models)."""
    x = ins["X"][0]
    bs = ins["BatchSize"][0].reshape(-1)
    bsum = ins["BatchSum"][0].reshape(-1)
    bsq = ins["BatchSquareSum"][0].reshape(-1)
    means = bsum / bs
    scales = torch.sqrt(bs / bsq)
    return {"Y": [(x - means[None, :]) * scales[None, :]],
            "Means": [means], "Scales": [scales]}


@register_op("fsp")
def _fsp(ctx, ins, attrs):
    """reference: fsp_op.cc — FSP matrix for distillation:
    Out[n, c1, c2] = mean_hw X[n,c1,hw] * Y[n,c2,hw]."""
    x, y = ins["X"][0], ins["Y"][0]
    n, c1, h, w = x.shape
    xf = x.reshape(n, c1, h * w)
    yf = y.reshape(n, y.shape[1], h * w)
    return {"Out": [torch.einsum("nch,ndh->ncd", xf, yf) / (h * w)]}


@register_op("similarity_focus", not_differentiable=True, grad_free=True)
def _similarity_focus(ctx, ins, attrs):
    """reference: similarity_focus_op.h — build a focus mask: for the
    chosen axis/index slices, mark the (row, col) of per-channel maxima."""
    x = ins["X"][0]                 # [n, c, a, b]
    axis = int(attrs.get("axis", 1))
    indexes = [int(i) for i in attrs.get("indexes", [0])]
    if axis not in (1, 2, 3):
        raise ValueError(f"similarity_focus: axis must be 1, 2 or 3, "
                         f"got {axis}")
    mask = torch.zeros_like(x)
    for idx in indexes:
        plane = x.select(axis, idx)             # [n, d1, d2]
        row_max = plane.amax(dim=2, keepdim=True)
        col_max = plane.amax(dim=1, keepdim=True)
        m = ((plane == row_max) | (plane == col_max)).to(x.dtype)
        mask = torch.maximum(mask, m.unsqueeze(axis))
    return {"Out": [mask]}


@register_op("positive_negative_pair", not_differentiable=True,
             grad_free=True)
def _positive_negative_pair(ctx, ins, attrs):
    """reference: positive_negative_pair_op.h — ranking metric: within
    each query, count score-ordered pairs that agree/disagree with label
    order."""
    score = ins["Score"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1)
    qid = ins["QueryID"][0].reshape(-1)
    same_q = qid[:, None] == qid[None, :]
    upper = torch.ones_like(same_q).triu(1)
    valid = same_q & upper & (label[:, None] != label[None, :])
    s_diff = score[:, None] - score[None, :]
    l_diff = label[:, None] - label[None, :]
    pos = (valid & (s_diff * l_diff > 0)).sum()
    neg = (valid & (s_diff * l_diff < 0)).sum()
    neu = (valid & (s_diff == 0)).sum()
    f32 = torch.float32
    return {"PositivePair": [(pos + 0.5 * neu).to(f32)[None]],
            "NegativePair": [(neg + 0.5 * neu).to(f32)[None]],
            "NeutralPair": [neu.to(f32)[None]]}


@register_op("filter_by_instag", not_differentiable=True, grad_free=True)
def _filter_by_instag(ctx, ins, attrs):
    """reference: filter_by_instag_op.h. Fixed-size redesign: rows whose
    tag set intersects the filter keep their values, others are zeroed;
    LossWeight marks kept rows."""
    x = ins["Ins"][0]                       # [n, d]
    tags = ins["Ins_tag"][0].reshape(x.shape[0], -1)
    filt = ins["Filter_tag"][0].reshape(-1)
    keep = (tags[:, :, None] == filt[None, None, :]).any(dim=2).any(dim=1)
    out = torch.where(keep[:, None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    rows = torch.arange(x.shape[0], device=x.device)
    return {"Out": [out],
            "LossWeight": [keep.to(torch.float32)[:, None]],
            "IndexMap": [torch.stack([rows, rows], dim=1)]}


@register_op("match_matrix_tensor")
def _match_matrix_tensor(ctx, ins, attrs):
    """reference: match_matrix_tensor_op.cc — text matching: for each
    channel t, Out = X W_t Y^T. Dense redesign: X [n, lx, d],
    Y [n, ly, d], W [d, t, d] -> Out [n, t, lx, ly]."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["W"][0]
    tmp = torch.einsum("nld,dte->nlte", x, w)
    out = torch.einsum("nlte,nme->ntlm", tmp, y)
    return {"Out": [out], "Tmp": [tmp]}


# ---------------------------------------------------------------------------
# losses with state / samplers
# ---------------------------------------------------------------------------

@register_op("center_loss", no_grad_inputs={"Label", "Centers",
                                            "CenterUpdateRate"},
             non_diff_outputs={"SampleCenterDiff", "CentersOut"})
def _center_loss(ctx, ins, attrs):
    """reference: center_loss_op.h — intra-class compactness loss with
    running class centers; the counts and the update are scatter-adds
    over the batch's labels (repeats summed in order)."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1).long()
    centers = ins["Centers"][0]
    alpha = ins["CenterUpdateRate"][0].reshape(())
    diff = x - centers[label]
    loss = 0.5 * (diff * diff).sum(dim=1, keepdim=True)
    new_centers = centers
    if bool(attrs.get("need_update", True)):
        cnt = scatter_add(x.new_zeros((centers.shape[0],)), label,
                          torch.ones_like(label, dtype=x.dtype))
        upd = scatter_add(torch.zeros_like(centers), label, diff)
        upd = upd / (1.0 + cnt)[:, None]
        new_centers = centers + alpha * upd
    return {"Loss": [loss], "SampleCenterDiff": [diff],
            "CentersOut": [new_centers]}


@register_op("sample_logits", stateful=True,
             no_grad_inputs={"Labels", "CustomizedSamples",
                             "CustomizedProbabilities"},
             non_diff_outputs={"Samples", "Probabilities",
                               "SampledLabels", "LogitsDim", "LabelsDim"})
def _sample_logits(ctx, ins, attrs):
    """reference: sample_logits_op.h — sampled-softmax candidate
    sampling: keep the true classes + num_samples log-uniform negatives,
    with log-Q correction (remove_accidental_hits)."""
    logits = ins["Logits"][0]               # [n, K]
    labels = ins["Labels"][0].long()        # [n, T]
    n, k = logits.shape
    t = labels.shape[1]
    s = int(attrs.get("num_samples", 16))
    dev = logits.device
    if bool(attrs.get("use_customized_samples", False)):
        samples = ins["CustomizedSamples"][0].long()
        probs = ins["CustomizedProbabilities"][0]
    else:
        # log-uniform (Zipf) negative sampler, one draw per row and sample
        u = torch.rand((n, s), generator=ctx.rng(), device=dev)
        logk = torch.log(torch.full((), k + 1.0, device=dev))
        neg = (torch.exp(u * logk) - 1.0).long().clamp(0, k - 1)
        samples = torch.cat([labels, neg], dim=1)   # [n, T+S]
        probs = torch.log((samples + 2.0) / (samples + 1.0)) / logk
    rows = torch.arange(n, device=dev)[:, None]
    sampled = logits[rows, samples] - torch.log(probs + 1e-20)
    if bool(attrs.get("remove_accidental_hits", True)):
        # negatives equal to a true label get -inf-ish logits
        hit = (samples[:, t:, None] == labels[:, None, :]).any(-1)
        penalty = torch.where(hit, -1e20, 0.0).to(sampled.dtype)
        sampled = torch.cat([sampled[:, :t], sampled[:, t:] + penalty],
                            dim=1)
    sampled_labels = torch.arange(t, device=dev)[None, :].expand(n, t)
    return {"Samples": [samples],
            "Probabilities": [probs.to(logits.dtype)],
            "SampledLogits": [sampled],
            "SampledLabels": [sampled_labels.contiguous()]}


def _sample_logits_grad_lower(ctx, ins, attrs):
    """d(SampledLogits)/d(Logits) is a gather, so the grad is the
    scatter-add of the cotangent back through the sampled indices (the
    -log(Q) shift and the accidental-hit penalty are additive constants);
    repeats add in order (index_put_ with accumulate)."""
    logits = ins["Logits"][0]
    samples = ins["__out__Samples"][0].long()
    g = ins["SampledLogits@GRAD"][0]
    rows = torch.arange(logits.shape[0], device=logits.device)[:, None]
    dx = torch.zeros_like(logits).index_put_(
        (rows.expand_as(samples), samples), g.to(logits.dtype),
        accumulate=True)
    return {"Logits@GRAD": [dx]}


get_op_def("sample_logits").grad_lower = _sample_logits_grad_lower


# ---------------------------------------------------------------------------
# LSTM variants (reference: lstm_unit_op.h, lstmp_op.h, lstm_op.cc)
# ---------------------------------------------------------------------------

@register_op("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    """reference: lstm_unit_op.h — X [b, 4D] (i,f,o,g gates), C_prev
    [b, D] -> C, H."""
    x, c_prev = ins["X"][0], ins["C_prev"][0]
    d = c_prev.shape[1]
    fb = attrs.get("forget_bias", 0.0)
    i = torch.sigmoid(x[:, 0 * d:1 * d])
    f = torch.sigmoid(x[:, 1 * d:2 * d] + fb)
    o = torch.sigmoid(x[:, 2 * d:3 * d])
    g = torch.tanh(x[:, 3 * d:4 * d])
    c = f * c_prev + i * g
    return {"C": [c], "H": [o * torch.tanh(c)]}


_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
        "relu": torch.relu, "identity": lambda v: v}


@register_op("lstmp", no_grad_inputs={"C0", "H0"},
             non_diff_outputs={"BatchGate", "BatchCellPreAct",
                               "BatchHidden", "Cell"})
def _lstmp(ctx, ins, attrs):
    """reference: lstmp_op.h — LSTM with a recurrent projection layer.
    Dense redesign: Input [b, T, 4D] (pre-computed x·W contributions),
    Weight [P, 4D] recurrent weights on the projected state, ProjWeight
    [D, P]. Projection h_proj = act(h · ProjWeight) feeds back. A Python
    loop over T (JAX: lax.scan)."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    pw = ins["ProjWeight"][0]
    bias = ins.get("Bias", [None])[0]
    d = w.shape[1] // 4
    b, steps = x.shape[0], x.shape[1]
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACT[attrs.get("cell_activation", "tanh")]
    cand_act = _ACT[attrs.get("candidate_activation", "tanh")]
    proj_act = _ACT[attrs.get("proj_activation", "tanh")]
    c = ins.get("C0", [None])[0]
    if c is None:
        c = x.new_zeros((b, d))
    hp = ins.get("H0", [None])[0]
    if hp is None:
        hp = x.new_zeros((b, pw.shape[1]))
    hs, cs = [], []
    for t in range(steps):
        gates = x[:, t] + hp @ w
        if bias is not None:
            gates = gates + bias.reshape(1, -1)[:, :4 * d]
        i = gate_act(gates[:, 0 * d:1 * d])
        f = gate_act(gates[:, 1 * d:2 * d])
        o = gate_act(gates[:, 2 * d:3 * d])
        g = cand_act(gates[:, 3 * d:4 * d])
        c = f * c + i * g
        hp = proj_act((o * cell_act(c)) @ pw)
        hs.append(hp)
        cs.append(c)
    if not hs:
        return {"Projection": [x.new_zeros((b, 0, pw.shape[1]))],
                "Cell": [x.new_zeros((b, 0, d))]}
    return {"Projection": [torch.stack(hs, dim=1)],
            "Cell": [torch.stack(cs, dim=1)]}


def _alias_op(new_name, existing, **kw):
    """Register `new_name` with the rule and marks of an existing op (the
    reference registers e.g. 'lstm' for what the themed module calls
    dynamic_lstm); as in JAX, a custom grad of the original does not
    carry over."""
    base = get_op_def(existing)
    register_op(new_name, no_grad_inputs=base.no_grad_inputs,
                non_diff_outputs=base.non_diff_outputs,
                stateful=base.stateful,
                not_differentiable=base.not_differentiable,
                grad_free=base.grad_free, **kw)(base.lower)


_alias_op("lstm", "dynamic_lstm")
_alias_op("gru", "dynamic_gru")


@register_op("row_conv")
def _row_conv(ctx, ins, attrs):
    """reference: row_conv_op.cc — lookahead (future-context) row
    convolution. Dense redesign: X [b, T, d], Filter [future_context, d];
    Out[b, t] = sum_w Filter[w] * X[b, t+w] (zero past the end)."""
    x, filt = ins["X"][0], ins["Filter"][0]
    fc_len = filt.shape[0]
    pad = F.pad(x, (0, 0, 0, fc_len - 1))
    out = torch.zeros_like(x)
    for wi in range(fc_len):
        out = out + pad[:, wi:wi + x.shape[1]] * filt[wi][None, None, :]
    return {"Out": [out]}


@register_op("fc")
def _fc(ctx, ins, attrs):
    """reference: fc_op.cc — fused matmul+bias (the fc fuse pass target).
    Input [n, ...], W [d, size]."""
    x, w = ins["Input"][0], ins["W"][0]
    rank = int(attrs.get("in_num_col_dims", 1))
    lead = 1
    for d in x.shape[:rank]:
        lead *= d
    out = x.reshape(lead, -1) @ w
    if "Bias" in ins:
        out = out + ins["Bias"][0].reshape(1, -1)
    return {"Out": [out.reshape(tuple(x.shape[:rank]) + (w.shape[1],))]}


@register_op("sync_batch_norm",
             no_grad_inputs={"Mean", "Variance"},
             non_diff_outputs={"MeanOut", "VarianceOut", "SavedMean",
                               "SavedVariance"})
def _sync_batch_norm(ctx, ins, attrs):
    """reference: sync_batch_norm_op.cu — batch norm whose batch
    statistics are reduced across data-parallel replicas. On one rank it
    is batch_norm (JAX's rule outside an SPMD region); the cross-rank
    mean over a data axis is ROADMAP A.8a and raises."""
    x = ins["X"][0]
    scale = ins["Scale"][0].reshape(-1)
    bias = ins["Bias"][0].reshape(-1)
    mean_in = ins["Mean"][0].reshape(-1)
    var_in = ins["Variance"][0].reshape(-1)
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = attrs.get("is_test", False) or getattr(ctx, "is_test", False)
    layout = attrs.get("data_layout", "NCHW")
    axes = (0, 2, 3) if (layout == "NCHW" and x.ndim == 4) else \
        tuple(range(x.ndim - 1)) if layout != "NCHW" else (0,)
    shape = (1, -1) + (1,) * (x.ndim - 2) if layout == "NCHW" \
        else (1,) * (x.ndim - 1) + (-1,)
    data_axes = [a for a in getattr(ctx, "spmd_axes", ())
                 if a in ("dp", "data")]
    if data_axes and not is_test:
        raise NotImplementedError(
            f"sync_batch_norm: the mean over the data axes {data_axes} "
            "across ranks is ROADMAP A.8a (data parallel and collectives); "
            "on one rank the op is batch_norm")
    if is_test:
        mean, var = mean_in, var_in
        mean_out, var_out = mean_in, var_in
    else:
        xf = x.float()
        mean = xf.mean(axes)
        var = ((xf - mean.reshape(shape)) ** 2).mean(axes)
        mean_out = momentum * mean_in + (1 - momentum) * mean
        var_out = momentum * var_in + (1 - momentum) * var
    inv = torch.rsqrt(var + eps)
    y = (x - mean.reshape(shape).to(x.dtype)) * \
        (inv * scale).reshape(shape).to(x.dtype) + \
        bias.reshape(shape).to(x.dtype)
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [mean], "SavedVariance": [inv]}


@register_op("deformable_conv", no_grad_inputs={"Mask"})
def _deformable_conv(ctx, ins, attrs):
    """reference: deformable_conv_op.cc (v2: with modulation Mask).
    X [n, c, h, w], Offset [n, 2*dg*kh*kw, oh, ow] as (dy, dx) pairs,
    Mask [n, dg*kh*kw, oh, ow], Filter [oc, c, kh, kw]. Each tap's
    bilinear sample (zero outside the image) times its mask, then one
    GEMM of the columns with the filter (JAX: an einsum over [c, taps,
    oh, ow] columns). The four corners of every sample are one
    advanced-indexing read of X laid out [n, h, w, dg, c / dg], whose
    gradient is one sort-based index_put_; the columns come out
    [n * oh * ow, dg * taps * c / dg]. Mask takes no gradient (JAX's
    no_grad_inputs; DCNv2 learns it: ROADMAP §C)."""
    x = ins["Input"][0]
    offset = ins["Offset"][0]
    mask = ins.get("Mask", [None])[0]
    filt = ins["Filter"][0]
    stride = [int(s) for s in attrs.get("strides", [1, 1])]
    padding = [int(p) for p in attrs.get("paddings", [0, 0])]
    dilation = [int(d) for d in attrs.get("dilations", [1, 1])]
    dg = int(attrs.get("deformable_groups", 1))
    n, c, h, w = x.shape
    oc, _, kh, kw = filt.shape
    oh = (h + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    ow = (w + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    if c % dg != 0:
        raise ValueError(
            f"deformable_conv: channels {c} not divisible by "
            f"deformable_groups {dg}")
    cg = c // dg
    k, ln = kh * kw, oh * ow
    dev = x.device
    # [n, L, dg, K] each: the tap's offset pair and mask
    off = offset.reshape(n, dg, k, 2, ln).permute(0, 4, 1, 2, 3)
    dy, dx = off[..., 0], off[..., 1]
    taps = torch.arange(k, device=dev)
    ky = torch.div(taps, kw, rounding_mode="floor") * dilation[0]
    kx = (taps % kw) * dilation[1]
    base_y = (torch.arange(oh, device=dev) * stride[0] - padding[0])
    base_x = (torch.arange(ow, device=dev) * stride[1] - padding[1])
    py = (base_y[:, None].expand(oh, ow).reshape(ln)[:, None, None]
          + ky[None, None, :]) + dy                # [n, L, dg, K]
    px = (base_x[None, :].expand(oh, ow).reshape(ln)[:, None, None]
          + kx[None, None, :]) + dx
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    ly = py - y0
    lx = px - x0
    # the four corners stacked first: [4, n, L, dg, K]
    cy = torch.stack([y0, y0, y0 + 1, y0 + 1])
    cx = torch.stack([x0, x0 + 1, x0, x0 + 1])
    wts = torch.stack([(1 - ly) * (1 - lx), (1 - ly) * lx,
                       ly * (1 - lx), ly * lx])
    ok = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
    wts = wts * ok.to(wts.dtype)
    if mask is not None:
        mk = mask.reshape(n, dg, k, ln).permute(0, 3, 1, 2)
        wts = wts * mk.to(wts.dtype)
    xl = x.permute(0, 2, 3, 1).reshape(n, h, w, dg, cg)
    bidx = torch.arange(n, device=dev)[None, :, None, None, None]
    gidx = torch.arange(dg, device=dev)[None, None, None, :, None]
    vals = xl[bidx, cy.clamp(0, h - 1).long(), cx.clamp(0, w - 1).long(),
              gidx]                                # [4, n, L, dg, K, cg]
    col = (vals * wts[..., None]).sum(0)           # [n, L, dg, K, cg]
    wmat = filt.reshape(oc, dg, cg, k).permute(1, 3, 2, 0) \
        .reshape(dg * k * cg, oc)
    out = col.reshape(n * ln, dg * k * cg) @ wmat   # [n * L, oc]
    return {"Output": [out.reshape(n, oh, ow, oc).permute(0, 3, 1, 2)
                       .contiguous()]}


@register_op("tree_conv", no_grad_inputs={"EdgeSet"})
def _tree_conv(ctx, ins, attrs):
    """reference: tree_conv_op.h + math/tree2col — tree-based convolution
    (TBCNN). EdgeSet [b, E, 2] int (1-based parent->child, 0-padded),
    NodesVector [b, n, F], Filter [F, 3, out, filters]. Each node u
    gathers its subtree patch to max_depth; patch member v contributes
    feat_v weighted by (eta_t, eta_l, eta_r) from its (depth, sibling
    index, sibling count). Dense redesign: adjacency matrix powers give
    per-(u, v) depths — no host traversal. As in JAX, a padding edge
    writes its sibling index and count to node n and sets adj[n, n]; where
    several edges write one node's index, the last in edge order wins
    (XLA's sequential scatter on the CPU), chosen here explicitly."""
    edges = ins["EdgeSet"][0].long()
    feats = ins["NodesVector"][0]
    filt = ins["Filter"][0]
    max_depth = int(attrs.get("max_depth", 2))
    b, e, _ = edges.shape
    n = feats.shape[1]
    f_dim, _, out_size, n_filters = filt.shape
    w2 = filt.reshape(f_dim * 3, out_size * n_filters)
    d = float(max_depth)
    dev = feats.device
    f32 = torch.float32
    u, v = edges[:, :, 0], edges[:, :, 1]                  # [b, e]
    valid = (u > 0) & (v > 0)
    same_parent = (u[:, None, :] == u[:, :, None]) & valid[:, None, :] \
        & valid[:, :, None]                                # [b, e, e]
    earlier = torch.ones(e, e, dtype=torch.bool, device=dev).tril(-1)
    index = (same_parent & earlier).sum(2) + 1              # [b, e]
    pclen_e = same_parent.sum(2)
    n1 = n + 1
    nodes = torch.arange(n1, device=dev)
    pos_v = torch.where(valid, v, n)
    pos_u = torch.where(valid, u, n)
    # the last edge (in order) writing each node: [b, n+1], -1 if none
    writers = pos_v[:, None, :] == nodes[None, :, None]     # [b, n+1, e]
    order = torch.arange(1, e + 1, device=dev)
    last = (writers * order).amax(2) - 1
    lastc = last.clamp_min(0)
    idx_node = torch.where(last >= 0, torch.gather(index, 1, lastc), 0)
    pcl_node = torch.where(last >= 0, torch.gather(pclen_e, 1, lastc), 1)
    # adjacency (1-based ids); depth(u,v) via boolean matrix powers
    bidx = torch.arange(b, device=dev)[:, None].expand(b, e)
    adj = torch.zeros((b, n1, n1), dtype=torch.bool, device=dev)
    adj = adj.index_put((bidx, pos_u, pos_v),
                        torch.ones((), dtype=torch.bool, device=dev))
    eye = torch.eye(n1, dtype=torch.bool, device=dev)[None]
    depth = torch.where(eye, 0, -1).expand(b, n1, n1)
    reach = eye.expand(b, n1, n1)
    for k in range(1, max_depth):
        reach = (reach.to(f32) @ adj.to(f32)) > 0
        depth = torch.where((depth < 0) & reach, k, depth)
    in_patch = depth >= 0
    dep = depth.to(f32)
    zero = torch.zeros((), dtype=f32, device=dev)
    eta_t = torch.where(in_patch, (d - dep) / d, zero)
    idx_f = idx_node.to(f32)[:, None, :]
    pcl_f = pcl_node.to(f32)[:, None, :]
    temp = torch.where(pcl_f == 1, 0.5,
                       (idx_f - 1.0) / torch.clamp_min(pcl_f - 1.0, 1.0))
    temp = torch.where(eye, 0.5, temp)           # root: index=1, pclen=1
    eta_l = (1.0 - eta_t) * temp
    eta_r = (1.0 - eta_t) * (1.0 - eta_l)
    w3 = torch.stack([eta_t, eta_l, eta_r], dim=-1)         # [b, u, v, 3]
    w3 = torch.where(in_patch[..., None], w3, zero).to(feats.dtype)
    xpad = torch.cat([feats.new_zeros((b, 1, f_dim)), feats], dim=1)
    patch = torch.einsum("buvt,bvf->buft", w3, xpad)        # [b, n+1, F, 3]
    out = patch.reshape(b, n1, f_dim * 3) @ w2
    # valid roots: nodes that appear in any edge (plus node 1)
    seen = torch.zeros((b, n1), dtype=torch.bool, device=dev)
    true = torch.ones((), dtype=torch.bool, device=dev)
    seen = seen.index_put((bidx, torch.where(valid, u, 0)), true)
    seen = seen.index_put((bidx, torch.where(valid, v, 0)), true)
    seen[:, 1] = True
    seen[:, 0] = False
    out = torch.where(seen[..., None], out, torch.zeros((), dtype=out.dtype,
                                                        device=dev))
    return {"Out": [out[:, 1:].reshape(b, n, out_size, n_filters)]}


@register_op("attention_lstm",
             no_grad_inputs={"SeqLen"},
             non_diff_outputs={"Cell"})
def _attention_lstm(ctx, ins, attrs):
    """reference: attention_lstm_op.cc — per step, a 1-unit attention fc
    over the whole sequence (conditioned on the previous cell state)
    pools the inputs, which feed a peephole-less LSTM. Dense redesign:
    X [b, T, M] + SeqLen [b]; outputs Hidden/Cell [b, T, D]. A Python
    loop over T (JAX: lax.scan)."""
    x = ins["X"][0]
    b, t, m = x.shape
    dev = x.device
    seq_len = ins["SeqLen"][0].reshape(-1).long() if "SeqLen" in ins \
        else torch.full((b,), t, dtype=torch.long, device=dev)
    c = ins["C0"][0]
    h = ins.get("H0", [None])[0]
    atten_w = ins["AttentionWeight"][0].reshape(-1)     # [M+D]
    atten_b = ins.get("AttentionBias", [None])[0]
    atten_scalar = ins.get("AttentionScalar", [None])[0]
    atten_scalar_b = ins.get("AttentionScalarBias", [None])[0]
    lstm_w = ins["LSTMWeight"][0]                       # [D+M, 4D]
    lstm_b = ins["LSTMBias"][0].reshape(-1)             # [4D]
    dd = c.shape[1]
    act_gate = _ACT[attrs.get("gate_activation", "sigmoid")]
    act_cell = _ACT[attrs.get("cell_activation", "tanh")]
    act_cand = _ACT[attrs.get("candidate_activation", "tanh")]
    if h is None:
        h = x.new_zeros((b, dd))
    mask = torch.arange(t, device=dev)[None, :] < seq_len[:, None]
    atted = torch.einsum("btm,m->bt", x, atten_w[:m])
    if atten_b is not None:
        atted = atted + atten_b.reshape(())
    neg = torch.full((), -1e20, dtype=x.dtype, device=dev)
    hs, cs = [], []
    for ti in range(t):
        sc = torch.relu(atted + (c @ atten_w[m:])[:, None])
        if atten_scalar is not None:
            sc = sc * atten_scalar.reshape(())
            if atten_scalar_b is not None:
                sc = torch.relu(sc + atten_scalar_b.reshape(()))
        sc = torch.where(mask, sc, neg)
        a = torch.softmax(sc, dim=1)                    # [b, T]
        pooled = torch.einsum("bt,btm->bm", a, x)
        gates = pooled @ lstm_w[dd:] + h @ lstm_w[:dd] + lstm_b[None, :]
        g = act_gate(gates[:, :3 * dd])
        cand = act_cand(gates[:, 3 * dd:])
        c_new = g[:, :dd] * c + g[:, dd:2 * dd] * cand
        h_new = act_cell(c_new) * g[:, 2 * dd:3 * dd]
        active = (ti < seq_len)[:, None]
        c = torch.where(active, c_new, c)
        h = torch.where(active, h_new, h)
        hs.append(h)
        cs.append(c)
    return {"Hidden": [torch.stack(hs, dim=1)],
            "Cell": [torch.stack(cs, dim=1)]}
