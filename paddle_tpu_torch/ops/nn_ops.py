"""NN ops: the convolutions (2-D, transposed, 3-D), pooling (2-D, 3-D,
adaptive), the norms (batch, layer, group, instance, local response,
spectral), prelu, dropout and its mask replay, the losses
(softmax_with_cross_entropy, cross_entropy,
sigmoid_cross_entropy_with_logits, huber, smooth L1, square error, KL),
accuracy and the nearest, bilinear and trilinear interpolations: every
rule of `paddle_tpu/ops/nn_ops.py`.

Port of that file's rules by name (conv2d:23-66, conv2d_transpose:69,
conv3d:102, pool2d:121, adaptive_pool2d:187, batch_norm:234,
layer_norm:280, group_norm:301, instance_norm:319, lrn:334, prelu:349,
dropout and dropout_mask_apply :362-424, softmax_with_cross_entropy
:437-511, cross_entropy:514, sigmoid_cross_entropy_with_logits:530,
huber_loss:542, smooth_l1_loss:553, square_error_cost:571,
kldiv_loss:577, accuracy:595, the interpolations :612-675,
conv3d_transpose:683, pool3d:713, spectral_norm:750,
trilinear_interp:774). dropout's grad replays its saved Mask, the
cross-entropy grad works from the saved Softmax, and every other grad
takes the generic vjp path (each replays its forward; the convolutions
run on cuDNN through `F.conv2d`, `F.conv_transpose2d`, `F.conv3d`,
`F.conv_transpose3d`).

The interpolations port JAX's coordinate rules, not `F.interpolate`'s
modes: bilinear and nearest sample at ratio * dst (align_mode 1, the
default), at half-pixel centres (align_mode 0) or on the corner grid
(align_corners), nearest rounding on the corner grid and flooring
otherwise; trilinear without align_corners is `jax.image.resize`'s
scale-and-translate triangle kernel, widened by the scale when it
downsamples (antialiased) and renormalised at the edges. Their
gathers are advanced indexing and their weights matmuls, so no
gradient needs an atomic add. lrn is k + alpha * sum(x^2) with alpha not
divided by n, as the JAX rule computes it.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..framework.registry import register_op


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------

def _conv_padding(paddings, algo, ksize, dilations, spatial, strides):
    """((top, bottom), (left, right)) zero padding of the JAX rule's
    `padding` argument: "SAME" pads so that out = ceil(in / stride), the
    larger half at the end, as lax.conv_general_dilated does; "VALID" pads
    nothing; 2 or 4 explicit values otherwise."""
    if algo == "SAME":
        pads = []
        for n, k, d, s in zip(spatial, ksize, dilations, strides):
            out = -(-n // s)
            total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if algo == "VALID":
        return [(0, 0), (0, 0)]
    if len(paddings) == 2:
        return [(paddings[0], paddings[0]), (paddings[1], paddings[1])]
    return [(paddings[0], paddings[1]), (paddings[2], paddings[3])]


@register_op("conv2d")
def _conv2d(ctx, ins, attrs):
    """Filters are stored OIHW whatever the layout; with data_format NHWC
    the input and output are permuted around `F.conv2d` (NCHW). The output
    takes the input's dtype, as in the JAX rule (f32 accumulation for f32
    input)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = tuple(attrs.get("strides", [1, 1]))
    dil = tuple(attrs.get("dilations", [1, 1]))
    groups = attrs.get("groups", 1)
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    (pt, pb), (pl, pr) = _conv_padding(
        attrs.get("paddings", [0, 0]),
        attrs.get("padding_algorithm", "EXPLICIT"), w.shape[2:], dil,
        x.shape[2:], strides)
    if pt == pb and pl == pr:
        out = F.conv2d(x, w, stride=strides, padding=(pt, pl),
                       dilation=dil, groups=groups)
    else:
        out = F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, stride=strides,
                       dilation=dil, groups=groups)
    if nhwc:
        out = out.permute(0, 2, 3, 1)
    return {"Output": [out.to(x.dtype)]}


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ctx, ins, attrs):
    x, w = ins["Input"][0], ins["Filter"][0]
    attrs = dict(attrs)
    attrs["groups"] = x.shape[
        3 if attrs.get("data_format", "NCHW") == "NHWC" else 1]
    return _conv2d(ctx, {"Input": [x], "Filter": [w]}, attrs)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

@register_op("pool2d")
def _pool2d(ctx, ins, attrs):
    """The JAX rule's reduce_window, on NCHW: explicit padding (-inf for
    max, 0 for avg, and ceil_mode's extra right pad, nn_ops.py:156-162),
    then windows with no padding of their own; avg divides the window sums
    by the count of unpadded values (exclusive) or by the window size.
    torch's own ceil_mode drops a last window that starts in the padding,
    and its max_pool2d refuses padding over half the kernel, hence the
    explicit pad."""
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    sp_axes = (1, 2) if nhwc else (2, 3)
    if attrs.get("global_pooling", False) or attrs.get("adaptive", False) \
            and tuple(attrs.get("ksize")) == (1, 1):
        if ptype == "max":
            out = torch.amax(x, dim=sp_axes, keepdim=True)
        else:
            out = torch.mean(x, dim=sp_axes, keepdim=True)
        return {"Out": [out]}
    if attrs.get("adaptive", False):
        sub = {"pooling_size": attrs["ksize"], "pooling_type": ptype}
        if nhwc:
            out = _adaptive_pool2d(ctx, {"X": [x.permute(0, 3, 1, 2)]},
                                   sub)["Out"][0]
            return {"Out": [out.permute(0, 2, 3, 1)]}
        return _adaptive_pool2d(ctx, {"X": [x]}, sub)
    ksize = tuple(attrs["ksize"])
    strides = tuple(attrs.get("strides", ksize))
    p = attrs.get("paddings", [0, 0])
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    extra = [0, 0]
    if attrs.get("ceil_mode", False):
        for i, (dim, k, s, pp) in enumerate(
                zip(x.shape[2:], ksize, strides, p)):
            rem = (dim + 2 * pp - k) % s
            extra[i] = (s - rem) % s if rem else 0
    pads = (p[1], p[1] + extra[1], p[0], p[0] + extra[0])
    if ptype == "max":
        fill = -torch.inf if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        out = F.max_pool2d(F.pad(x, pads, value=fill), ksize, strides)
    else:
        ssum = F.avg_pool2d(F.pad(x, pads), ksize, strides,
                            divisor_override=1)
        if attrs.get("exclusive", True):
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            cnt = F.avg_pool2d(F.pad(ones, pads), ksize, strides,
                               divisor_override=1)
            out = ssum / cnt
        else:
            out = ssum / float(ksize[0] * ksize[1])
    if nhwc:
        out = out.permute(0, 2, 3, 1)
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

@register_op("batch_norm",
             non_diff_outputs={"MeanOut", "VarianceOut", "SavedMean",
                               "SavedVariance"},
             no_grad_inputs={"Mean", "Variance"})
def _batch_norm(ctx, ins, attrs):
    """reference: batch_norm_op.cc, as the JAX rule computes it (not
    F.batch_norm): statistics in f32 for any input dtype, the biased batch
    variance, Paddle's momentum as the weight of the old running value
    (mean_out = momentum * mean + (1 - momentum) * batch_mean), and
    SavedVariance = 1 / sqrt(var + eps). MeanOut/VarianceOut alias the
    Mean/Variance persistables in the IR; the generic grad replays this
    rule but binds only the input grads, so the running statistics move
    once a step."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    layout = attrs.get("data_layout", "NCHW")
    if x.ndim == 2:
        axes, shape = (0,), (1, -1)
    elif layout == "NCHW":
        axes, shape = (0, 2, 3), (1, -1, 1, 1)
    else:
        axes, shape = (0, 1, 2), (1, 1, 1, -1)

    x32 = x.float()
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
        saved_mean = torch.zeros_like(mean)
        saved_var = torch.zeros_like(var)
    else:
        use_mean = torch.mean(x32, dim=axes)
        use_var = torch.var(x32, dim=axes, unbiased=False)
        mean_out = momentum * mean + (1.0 - momentum) * use_mean
        var_out = momentum * var + (1.0 - momentum) * use_var
        saved_mean = use_mean
        saved_var = 1.0 / torch.sqrt(use_var + eps)

    inv = 1.0 / torch.sqrt(use_var + eps)
    y = (x32 - use_mean.reshape(shape)) * (inv * scale).reshape(shape) \
        + bias.reshape(shape)
    return {"Y": [y.to(x.dtype)], "MeanOut": [mean_out],
            "VarianceOut": [var_out],
            "SavedMean": [saved_mean], "SavedVariance": [saved_var]}


@register_op("layer_norm", non_diff_outputs={"Mean", "Variance"})
def _layer_norm(ctx, ins, attrs):
    """reference: layer_norm_op.cc; normalizes over dims >= begin_norm_axis.
    Stats are computed in f32 even for bf16 activations."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    axis = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(axis, x.ndim))
    x32 = x.float()
    mean = torch.mean(x32, dim=axes, keepdim=True)
    var = torch.var(x32, dim=axes, keepdim=True, unbiased=False)
    y = (x32 - mean) / torch.sqrt(var + eps)
    nshape = (1,) * axis + tuple(x.shape[axis:])
    if "Scale" in ins:
        y = y * ins["Scale"][0].float().reshape(nshape)
    if "Bias" in ins:
        y = y + ins["Bias"][0].float().reshape(nshape)
    return {"Y": [y.to(x.dtype)], "Mean": [torch.squeeze(mean)],
            "Variance": [torch.squeeze(var)]}


def _dropout_grad_maker(op, block, no_grad_set):
    from ..framework.core import grad_var_name
    return [{
        "type": "dropout_grad",
        "inputs": {"Mask": op.output("Mask"),
                   "Out@GRAD": [grad_var_name(op.output("Out")[0])]},
        "outputs": {"X@GRAD": [grad_var_name(op.input("X")[0])]},
        "attrs": dict(op.attrs),
    }]


def _dropout_grad_lower(ctx, ins, attrs):
    """dropout is linear in X: its grad is the forward's map of Out@GRAD
    with the saved Mask."""
    return {"X@GRAD": [_dropout_apply(ins["Out@GRAD"][0], ins["Mask"][0],
                                      attrs)]}


@register_op("dropout", stateful=True, non_diff_outputs={"Mask"},
             grad_maker=_dropout_grad_maker, grad_lower=_dropout_grad_lower)
def _dropout(ctx, ins, attrs):
    """reference: dropout_op.cc. Mask is a real output (uint8). With
    is_test and upscale_in_train the op is the identity."""
    x = ins["X"][0]
    if attrs.get("is_test", False):
        return {"Out": [_dropout_apply(x, None, attrs)],
                "Mask": [torch.ones(x.shape, dtype=torch.uint8,
                                    device=x.device)]}
    keep = torch.rand(x.shape, generator=ctx.rng(), device=x.device) \
        < (1.0 - attrs.get("dropout_prob", 0.5))
    return {"Out": [_dropout_apply(x, keep, attrs)],
            "Mask": [keep.to(torch.uint8)]}


def _softmax_xent_grad_maker(op, block, no_grad_set):
    from ..framework.core import grad_var_name
    return [{
        "type": "softmax_with_cross_entropy_grad",
        "inputs": {"Softmax": op.output("Softmax"),
                   "Label": op.input("Label"),
                   "Loss@GRAD": [grad_var_name(op.output("Loss")[0])],
                   # present only when an aux loss consumed the Softmax
                   # output; the accumulator resolves it to "" otherwise
                   "Softmax@GRAD": [grad_var_name(
                       op.output("Softmax")[0])]},
        "outputs": {"Logits@GRAD": [grad_var_name(op.input("Logits")[0])]},
        "attrs": dict(op.attrs),
    }]


def _softmax_xent_grad_lower(ctx, ins, attrs):
    """d_logits = (softmax - onehot(label)) * d_loss from the saved Softmax
    (the reference grad kernel's design, softmax_with_cross_entropy_op.h),
    with no replay of the log-softmax."""
    softmax = ins["Softmax"][0]
    label = ins["Label"][0]
    g = ins["Loss@GRAD"][0]
    axis = attrs.get("axis", -1) % softmax.ndim
    sm = softmax.float()
    if attrs.get("soft_label", False):
        d = sm - label.float()
    else:
        lab = label
        if lab.ndim == softmax.ndim and lab.shape[axis] == 1:
            lab = torch.squeeze(lab, axis)
        idx = torch.unsqueeze(lab.long(), axis)
        ignore = attrs.get("ignore_index", -100)
        d = sm.scatter_add(axis, idx.clamp(0, sm.shape[axis] - 1),
                           torch.full(idx.shape, -1.0, device=sm.device))
        d = torch.where(torch.unsqueeze(lab == ignore, axis),
                        torch.zeros((), device=d.device), d)
    dl = d * g.float()
    g_sm = ins.get("Softmax@GRAD", [None])[0]
    if g_sm is not None:
        # aux-loss path through the Softmax output: softmax vjp
        gs = g_sm.float()
        dl = dl + (gs - torch.sum(gs * sm, dim=axis, keepdim=True)) * sm
    return {"Logits@GRAD": [dl.to(softmax.dtype)]}


@register_op("softmax_with_cross_entropy", no_grad_inputs={"Label"},
             grad_maker=_softmax_xent_grad_maker,
             grad_lower=_softmax_xent_grad_lower)
def _softmax_xent(ctx, ins, attrs):
    """reference: softmax_with_cross_entropy_op.cc — log-softmax + NLL in
    one, f32 internal math."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = attrs.get("axis", -1) % logits.ndim
    logp = torch.log_softmax(logits.float(), dim=axis)
    softmax = torch.exp(logp).to(logits.dtype)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lab = label
        if lab.ndim == logits.ndim and lab.shape[axis] == 1:
            lab = torch.squeeze(lab, axis)
        idx = torch.unsqueeze(lab.long(), axis)
        ignore = attrs.get("ignore_index", -100)
        nll = -torch.gather(logp, axis, idx.clamp(0, logp.shape[axis] - 1))
        loss = torch.where(torch.unsqueeze(lab == ignore, axis),
                           torch.zeros((), dtype=nll.dtype,
                                       device=nll.device), nll)
    return {"Softmax": [softmax], "Loss": [loss]}


@register_op("square_error_cost", no_grad_inputs={"Label"})
def _square_error_cost(ctx, ins, attrs):
    return {"Out": [torch.square(ins["X"][0] - ins["Label"][0])]}


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@register_op("accuracy", not_differentiable=True, grad_free=True)
def _accuracy(ctx, ins, attrs):
    """reference: metrics/accuracy_op.cc — takes top-k Indices + Label."""
    idx = ins["Indices"][0]
    label = ins["Label"][0]
    if label.ndim > 1 and label.shape[-1] == 1:
        label = torch.squeeze(label, -1)
    correct = torch.any(idx == label[:, None], dim=1)
    n = idx.shape[0]
    num_correct = torch.sum(correct.float())
    return {"Accuracy": [(num_correct / n).reshape((1,))],
            "Correct": [num_correct.to(torch.int32).reshape((1,))],
            "Total": [torch.full((1,), n, dtype=torch.int32,
                                 device=idx.device)]}


def _dropout_apply(x, mask, attrs):
    """dropout's forward with a given keep mask."""
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        return x if impl == "upscale_in_train" else x * (1.0 - p)
    if impl == "upscale_in_train":
        scale = 0.0 if p >= 1.0 else 1.0 / (1.0 - p)
        return x * mask.to(x.dtype) * scale
    return x * mask.to(x.dtype)


@register_op("dropout_mask_apply", not_differentiable=True, grad_free=True)
def _dropout_mask_apply(ctx, ins, attrs):
    """A dropout replayed with its saved Mask (the recompute transpiler's
    replay): the forward's arithmetic, no new draw."""
    return {"Out": [_dropout_apply(ins["X"][0], ins["Mask"][0], attrs)]}


# ---------------------------------------------------------------------------
# transposed and 3-D convolutions, 3-D and adaptive pooling
# ---------------------------------------------------------------------------

@register_op("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    """Filter [C_in, C_out/g, kh, kw], torch's layout for a transposed
    conv; out = (in - 1) s - 2p + d (k - 1) + 1 (no output_size or
    output_padding, as in JAX)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    p = attrs.get("paddings", [0, 0])
    return {"Output": [F.conv_transpose2d(
        x, w, stride=tuple(attrs.get("strides", [1, 1])),
        padding=(p[0], p[1]), groups=int(attrs.get("groups", 1)),
        dilation=tuple(attrs.get("dilations", [1, 1])))]}


@register_op("conv3d")
def _conv3d(ctx, ins, attrs):
    """NCDHW, filters OIDHW; paddings 3 (symmetric) or 6 values."""
    x, w = ins["Input"][0], ins["Filter"][0]
    p = attrs.get("paddings", [0, 0, 0])
    if len(p) == 3:
        pad = tuple(p)
    else:
        x = F.pad(x, (p[4], p[5], p[2], p[3], p[0], p[1]))
        pad = 0
    return {"Output": [F.conv3d(
        x, w, stride=tuple(attrs.get("strides", [1, 1, 1])), padding=pad,
        dilation=tuple(attrs.get("dilations", [1, 1, 1])),
        groups=attrs.get("groups", 1))]}


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs):
    """conv2d_transpose in 3-D: filter [C_in, C_out/g, kd, kh, kw]."""
    x, w = ins["Input"][0], ins["Filter"][0]
    p = attrs.get("paddings", [0, 0, 0])
    return {"Output": [F.conv_transpose3d(
        x, w, stride=tuple(attrs.get("strides", [1, 1, 1])),
        padding=tuple(p[:3]), groups=int(attrs.get("groups", 1)),
        dilation=tuple(attrs.get("dilations", [1, 1, 1])))]}


@register_op("pool3d")
def _pool3d(ctx, ins, attrs):
    """pool2d's rule on NCDHW: explicit padding (-inf for max, 0 for avg,
    ceil_mode's extra end pad), then unpadded windows; avg over the
    unpadded count (exclusive) or the window size."""
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    if attrs.get("global_pooling", False):
        fn = torch.amax if ptype == "max" else torch.mean
        return {"Out": [fn(x, dim=(2, 3, 4), keepdim=True)]}
    ksize = tuple(attrs["ksize"])
    strides = tuple(attrs.get("strides", ksize))
    p = attrs.get("paddings", [0, 0, 0])
    extra = [0, 0, 0]
    if attrs.get("ceil_mode", False):
        for i, (dim, k, st, pp) in enumerate(
                zip(x.shape[2:], ksize, strides, p)):
            rem = (dim + 2 * pp - k) % st
            extra[i] = (st - rem) % st if rem else 0
    pads = (p[2], p[2] + extra[2], p[1], p[1] + extra[1],
            p[0], p[0] + extra[0])
    if ptype == "max":
        return {"Out": [F.max_pool3d(F.pad(x, pads, value=-torch.inf),
                                     ksize, strides)]}
    ssum = F.avg_pool3d(F.pad(x, pads), ksize, strides, divisor_override=1)
    if attrs.get("exclusive", True):
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        cnt = F.avg_pool3d(F.pad(ones, pads), ksize, strides,
                           divisor_override=1)
        return {"Out": [ssum / cnt]}
    return {"Out": [ssum / float(math.prod(ksize))]}


def _bin_bounds(in_dim, out_dim, device):
    """Adaptive bin i covers [floor(i in / out), ceil((i + 1) in / out))."""
    i = torch.arange(out_dim, device=device)
    return (i * in_dim) // out_dim, -((-(i + 1) * in_dim) // out_dim)


def _bin_means(in_dim, out_dim, dtype, device):
    """(out, in): 1 / len(bin) over each bin's members, 0 elsewhere."""
    lo, hi = _bin_bounds(in_dim, out_dim, device)
    j = torch.arange(in_dim, device=device)
    member = (j >= lo[:, None]) & (j < hi[:, None])
    return (member.float() / (hi - lo).float()[:, None]).to(dtype)


@register_op("adaptive_pool2d")
def _adaptive_pool2d(ctx, ins, attrs):
    """reference: pool_op.cc adaptive=True. Divisible sizes pool a reshape;
    ragged avg contracts with two bin-membership matrices, ragged max
    takes each bin's slice maximum (the bins are static), as JAX does."""
    x = ins["X"][0]
    oh, ow = (int(d) for d in attrs["pooling_size"])
    n, c, h, w = x.shape
    ptype = attrs.get("pooling_type", "avg")
    if h % oh == 0 and w % ow == 0:
        xr = x.reshape(n, c, oh, h // oh, ow, w // ow)
        if ptype == "max":
            return {"Out": [torch.amax(xr, dim=(3, 5))]}
        return {"Out": [torch.mean(xr, dim=(3, 5))]}
    if ptype == "max":
        def bins(in_dim, out_dim):
            return [((i * in_dim) // out_dim,
                     -(-((i + 1) * in_dim) // out_dim))
                    for i in range(out_dim)]
        xh = torch.stack([torch.amax(x[:, :, a:b], dim=2)
                          for a, b in bins(h, oh)], dim=2)
        return {"Out": [torch.stack([torch.amax(xh[:, :, :, a:b], dim=3)
                                     for a, b in bins(w, ow)], dim=3)]}
    mh = _bin_means(h, oh, x.dtype, x.device)
    mw = _bin_means(w, ow, x.dtype, x.device)
    return {"Out": [torch.einsum("oh,nchw,pw->ncop", mh, x, mw)]}


# ---------------------------------------------------------------------------
# group, instance, local response and spectral norms; prelu
# ---------------------------------------------------------------------------

@register_op("group_norm", non_diff_outputs={"Mean", "Variance"})
def _group_norm(ctx, ins, attrs):
    """Biased variance over each group's channels and positions, in X's
    dtype; Mean and Variance (n, groups)."""
    x = ins["X"][0]
    g = attrs["groups"]
    eps = attrs.get("epsilon", 1e-5)
    n, c, h, w = x.shape
    xr = x.reshape(n, g, c // g, h, w)
    mean = torch.mean(xr, dim=(2, 3, 4), keepdim=True)
    var = torch.var(xr, dim=(2, 3, 4), keepdim=True, unbiased=False)
    y = ((xr - mean) / torch.sqrt(var + eps)).reshape(n, c, h, w)
    if "Scale" in ins:
        y = y * ins["Scale"][0].reshape(1, -1, 1, 1)
    if "Bias" in ins:
        y = y + ins["Bias"][0].reshape(1, -1, 1, 1)
    return {"Y": [y], "Mean": [mean.reshape(n, g)],
            "Variance": [var.reshape(n, g)]}


@register_op("instance_norm",
             non_diff_outputs={"SavedMean", "SavedVariance"})
def _instance_norm(ctx, ins, attrs):
    """Biased variance over each sample's channel; SavedMean and
    SavedVariance (n, c), the variance itself as JAX returns it."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    mean = torch.mean(x, dim=(2, 3), keepdim=True)
    var = torch.var(x, dim=(2, 3), keepdim=True, unbiased=False)
    y = (x - mean) / torch.sqrt(var + eps)
    if "Scale" in ins:
        y = y * ins["Scale"][0].reshape(1, -1, 1, 1)
    if "Bias" in ins:
        y = y + ins["Bias"][0].reshape(1, -1, 1, 1)
    return {"Y": [y], "SavedMean": [mean.reshape(x.shape[:2])],
            "SavedVariance": [var.reshape(x.shape[:2])]}


@register_op("lrn", non_diff_outputs={"MidOut"})
def _lrn(ctx, ins, attrs):
    """x / (k + alpha * sum of x^2 over n neighbouring channels)^beta;
    alpha is not divided by n (F.local_response_norm divides it)."""
    x = ins["X"][0]
    n = attrs.get("n", 5)
    pad = n // 2
    sqp = F.pad(torch.square(x), (0, 0, 0, 0, pad, n - 1 - pad))
    acc = sum(sqp[:, i:i + x.shape[1]] for i in range(n))
    mid = attrs.get("k", 2.0) + attrs.get("alpha", 1e-4) * acc
    return {"Out": [x / mid ** attrs.get("beta", 0.75)], "MidOut": [mid]}


@register_op("prelu")
def _prelu(ctx, ins, attrs):
    """mode "all" (one alpha), "channel" (alpha a channel) or "element"
    (alpha shaped as X without its batch dim)."""
    x, alpha = ins["X"][0], ins["Alpha"][0]
    if attrs.get("mode", "all") == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    return {"Out": [torch.where(x > 0, x, alpha * x)]}


@register_op("spectral_norm", non_diff_outputs={"UOut", "VOut"})
def _spectral_norm(ctx, ins, attrs):
    """Weight / sigma, sigma from `power_iters` power iterations on the
    persistent U and V (written back as UOut, VOut); u and v are detached
    before sigma, as JAX's stop_gradient."""
    w = ins["Weight"][0]
    u = ins["U"][0].reshape(-1)
    v = ins["V"][0].reshape(-1)
    dim = attrs.get("dim", 0)
    eps = attrs.get("eps", 1e-12)
    mat = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)

    def normalize(t):
        return t / (torch.sqrt(torch.sum(t * t)) + eps)

    for _ in range(max(attrs.get("power_iters", 1), 0)):
        v = normalize(mat.T @ u)
        u = normalize(mat @ v)
    u, v = u.detach(), v.detach()
    sigma = u @ (mat @ v)
    return {"Out": [w / sigma], "UOut": [u], "VOut": [v]}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _squeeze_label(label):
    if label.ndim > 1 and label.shape[-1] == 1:
        return torch.squeeze(label, -1)
    return label


@register_op("cross_entropy", no_grad_inputs={"Label"})
def _cross_entropy(ctx, ins, attrs):
    """reference: cross_entropy_op.cc: -log p of the label on
    probabilities (post-softmax), p floored at 1e-20; ignore_index rows
    0."""
    x, label = ins["X"][0], ins["Label"][0]
    if attrs.get("soft_label", False):
        return {"Y": [-torch.sum(label * torch.log(torch.clamp_min(
            x, 1e-20)), dim=-1, keepdim=True)]}
    lab = _squeeze_label(label)
    idx = lab[..., None].long().clamp(0, x.shape[-1] - 1)
    loss = -torch.log(torch.clamp_min(torch.gather(x, -1, idx), 1e-20))
    ignore = attrs.get("ignore_index", -100)
    return {"Y": [torch.where((lab == ignore)[..., None],
                              torch.zeros((), dtype=loss.dtype,
                                          device=loss.device), loss)]}


@register_op("sigmoid_cross_entropy_with_logits", no_grad_inputs={"Label"})
def _sigmoid_xent(ctx, ins, attrs):
    """max(x, 0) - x z + log1p(exp(-|x|)); ignore_index positions 0;
    `normalize` divides by the count of the others (at least 1)."""
    x, label = ins["X"][0], ins["Label"][0]
    loss = torch.clamp_min(x, 0.0) - x * label \
        + torch.log1p(torch.exp(-torch.abs(x)))
    ignore = attrs.get("ignore_index", -100)
    loss = torch.where(label == ignore,
                       torch.zeros((), dtype=loss.dtype, device=loss.device),
                       loss)
    if attrs.get("normalize", False):
        loss = loss / torch.clamp_min(
            torch.sum((label != ignore).to(loss.dtype)), 1.0)
    return {"Out": [loss]}


@register_op("huber_loss", non_diff_outputs={"Residual"},
             no_grad_inputs={"Y"})
def _huber_loss(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    d = attrs.get("delta", 1.0)
    r = y - x
    loss = torch.where(torch.abs(r) <= d, 0.5 * r * r,
                       d * (torch.abs(r) - 0.5 * d))
    return {"Out": [loss], "Residual": [r]}


@register_op("smooth_l1_loss", non_diff_outputs={"Diff"},
             no_grad_inputs={"Y", "InsideWeight", "OutsideWeight"})
def _smooth_l1(ctx, ins, attrs):
    """Per-sample sum of the smooth L1 of (x - y) (inside-weighted),
    outside-weighted before the sum; Out (n, 1)."""
    x, y = ins["X"][0], ins["Y"][0]
    s2 = attrs.get("sigma", 1.0) ** 2
    diff = x - y
    if "InsideWeight" in ins:
        diff = diff * ins["InsideWeight"][0]
    ad = torch.abs(diff)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    if "OutsideWeight" in ins:
        loss = loss * ins["OutsideWeight"][0]
    return {"Out": [torch.sum(loss, dim=tuple(range(1, x.ndim)))[..., None]],
            "Diff": [diff]}


@register_op("kldiv_loss", no_grad_inputs={"Target"})
def _kldiv_loss(ctx, ins, attrs):
    """t (log t - x), t floored at 1e-20 inside the log; reduction mean,
    sum, batchmean (a (1,) result) or none."""
    x, t = ins["X"][0], ins["Target"][0]
    loss = t * (torch.log(torch.clamp_min(t, 1e-20)) - x)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = torch.mean(loss).reshape((1,))
    elif red == "sum":
        loss = torch.sum(loss).reshape((1,))
    elif red == "batchmean":
        loss = (torch.sum(loss) / x.shape[0]).reshape((1,))
    return {"Loss": [loss]}


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------

def _interp_out_hw(x, attrs):
    oh = attrs.get("out_h", 0)
    ow = attrs.get("out_w", 0)
    if (not oh or not ow) and attrs.get("scale", 0.0):
        oh = int(x.shape[2] * attrs["scale"])
        ow = int(x.shape[3] * attrs["scale"])
    if not oh or not ow:
        raise ValueError("interp op needs out_h/out_w or scale")
    return oh, ow


def linspace_f32(start, stop, num, device):
    """jnp.linspace(start, stop, num) in f32 with JAX's own arithmetic:
    start (1 - i/div) + stop i/div, the last point stop itself (num > 1).
    start and stop are python floats or 0-d f32 tensors."""
    if num == 1:
        return torch.zeros((1,), device=device) + start
    step = torch.arange(num - 1, dtype=torch.float32, device=device) \
        / float(num - 1)
    out = start * (1 - step) + stop * step
    end = torch.zeros((1,), device=device) + stop
    return torch.cat([out, end])


def _interp_coords(in_dim, out_dim, align_corners, align_mode, device):
    """Source coordinate of each output index, in f32 as JAX computes it:
    the corner grid (align_corners; 0 for a single output), half-pixel
    centres (align_mode 0) or ratio * dst (align_mode 1), clipped to the
    input."""
    if align_corners:
        if out_dim <= 1:
            return torch.zeros((out_dim,), device=device)
        return linspace_f32(0.0, in_dim - 1.0, out_dim, device)
    i = torch.arange(out_dim, dtype=torch.float32, device=device)
    if align_mode == 0:
        return torch.clamp((i + 0.5) * (in_dim / out_dim) - 0.5,
                           0, in_dim - 1)
    return torch.clamp(i * (in_dim / out_dim), 0, in_dim - 1)


@register_op("nearest_interp")
def _nearest_interp(ctx, ins, attrs):
    """Rounds the source coordinate (half to even) with align_corners,
    floors it without."""
    x = ins["X"][0]
    oh, ow = _interp_out_hw(x, attrs)
    ac = attrs.get("align_corners", True)
    am = attrs.get("align_mode", 1)
    snap = torch.round if ac else torch.floor
    ih = snap(_interp_coords(x.shape[2], oh, ac, am, x.device)).long()
    iw = snap(_interp_coords(x.shape[3], ow, ac, am, x.device)).long()
    return {"Out": [x[:, :, ih[:, None], iw]]}


@register_op("bilinear_interp")
def _bilinear_interp(ctx, ins, attrs):
    x = ins["X"][0]
    oh, ow = _interp_out_hw(x, attrs)
    ac = attrs.get("align_corners", True)
    am = attrs.get("align_mode", 1)
    h, w = x.shape[2], x.shape[3]
    ys = _interp_coords(h, oh, ac, am, x.device)
    xs = _interp_coords(w, ow, ac, am, x.device)
    y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
    y1, x1 = torch.clamp_max(y0 + 1, h - 1), torch.clamp_max(x0 + 1, w - 1)
    ly = (ys - y0)[None, None, :, None]
    lx = (xs - x0)[None, None, None, :]
    v00 = x[:, :, y0[:, None], x0]
    v01 = x[:, :, y0[:, None], x1]
    v10 = x[:, :, y1[:, None], x0]
    v11 = x[:, :, y1[:, None], x1]
    out = (v00 * (1 - ly) * (1 - lx) + v01 * (1 - ly) * lx
           + v10 * ly * (1 - lx) + v11 * ly * lx)
    return {"Out": [out.to(x.dtype)]}


def _resize_weights(in_dim, out_dim, device):
    """(in, out) weights of jax.image.resize's linear method along one
    axis: the triangle kernel at the half-pixel sample positions, widened
    by 1/scale when downsampling (antialias), each column renormalised,
    and zero where the sample lies outside the input."""
    inv = 1.0 / (out_dim / in_dim)
    sample = (torch.arange(out_dim, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    dist = torch.abs(sample[None, :] - torch.arange(
        in_dim, dtype=torch.float32, device=device)[:, None]) / max(inv, 1.0)
    w = torch.clamp_min(1 - dist, 0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    zero = torch.zeros((), device=device)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(
        np.float32).eps), w / torch.where(total != 0, total,
                                          torch.ones_like(total)), zero)
    inside = (sample >= -0.5) & (sample <= in_dim - 0.5)
    return torch.where(inside[None, :], w, zero)


@register_op("trilinear_interp")
def _trilinear_interp(ctx, ins, attrs):
    """[n, c, D, H, W]. align_corners (the default): linear on the corner
    grid, axis by axis. Otherwise jax.image.resize's "trilinear": each
    axis whose size changes contracted with its `_resize_weights`."""
    x = ins["X"][0]
    sizes = (int(attrs["out_d"]), int(attrs["out_h"]), int(attrs["out_w"]))
    out = x
    if attrs.get("align_corners", True):
        for axis, dst in zip((2, 3, 4), sizes):
            src = out.shape[axis]
            cs = torch.zeros((1,), device=x.device) if dst == 1 else \
                linspace_f32(0.0, src - 1.0, dst, x.device)
            lo = torch.floor(cs).long()
            hi = torch.clamp_max(lo + 1, src - 1)
            t = (cs - lo).reshape([-1 if i == axis else 1
                                   for i in range(out.ndim)])
            a = out[(slice(None),) * axis + (lo,)]
            b = out[(slice(None),) * axis + (hi,)]
            out = a * (1 - t) + b * t
        return {"Out": [out]}
    for axis, dst in zip((2, 3, 4), sizes):
        if out.shape[axis] != dst:
            w = _resize_weights(out.shape[axis], dst, x.device).to(x.dtype)
            out = torch.movedim(torch.movedim(out, axis, -1) @ w, -1, axis)
    return {"Out": [out]}
