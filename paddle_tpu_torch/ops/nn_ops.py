"""NN ops of the GPT slices: layer_norm, dropout, softmax_with_cross_entropy,
with their gradients.

Port of the matching rules in `paddle_tpu/ops/nn_ops.py` (layer_norm:280,
dropout:362-424, softmax_with_cross_entropy:437-499): dropout's grad
replays its saved Mask, the cross-entropy grad works from the saved
Softmax, and layer_norm's grad takes the generic vjp path.
"""

import torch

from ..framework.registry import register_op


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
