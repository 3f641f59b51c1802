"""NN ops of the GPT, BERT and ResNet slices: conv2d, depthwise_conv2d,
pool2d, batch_norm, layer_norm, dropout, softmax_with_cross_entropy and
accuracy, with their gradients.

Port of the matching rules in `paddle_tpu/ops/nn_ops.py` (conv2d:23-66,
pool2d:121, batch_norm:234, layer_norm:280, dropout:362-424,
softmax_with_cross_entropy:437-499, accuracy:595): dropout's grad replays
its saved Mask, the cross-entropy grad works from the saved Softmax, and
the grads of conv2d, pool2d, batch_norm and layer_norm take the generic vjp
path (each replays its forward; the convs run on cuDNN through
`F.conv2d`).
"""

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
        raise NotImplementedError(
            "pool2d(adaptive=True) needs adaptive_pool2d, which is not "
            "ported to paddle_tpu_torch yet")
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
    mask = ins["Mask"][0]
    dout = ins["Out@GRAD"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        g = dout if impl == "upscale_in_train" else dout * (1.0 - p)
    elif impl == "upscale_in_train":
        scale = 0.0 if p >= 1.0 else 1.0 / (1.0 - p)
        g = dout * mask.to(dout.dtype) * scale
    else:
        g = dout * mask.to(dout.dtype)
    return {"X@GRAD": [g]}


@register_op("dropout", stateful=True, non_diff_outputs={"Mask"},
             grad_maker=_dropout_grad_maker, grad_lower=_dropout_grad_lower)
def _dropout(ctx, ins, attrs):
    """reference: dropout_op.cc. Mask is a real output (uint8). With
    is_test and upscale_in_train the op is the identity."""
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": [out],
                "Mask": [torch.ones(x.shape, dtype=torch.uint8,
                                    device=x.device)]}
    keep = torch.rand(x.shape, generator=ctx.rng(), device=x.device) \
        < (1.0 - p)
    if impl == "upscale_in_train":
        scale = 0.0 if p >= 1.0 else 1.0 / (1.0 - p)
        out = x * keep.to(x.dtype) * scale
    else:
        out = x * keep.to(x.dtype)
    return {"Out": [out], "Mask": [keep.to(torch.uint8)]}


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
