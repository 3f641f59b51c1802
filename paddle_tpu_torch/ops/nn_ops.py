"""NN ops of the inference slice: layer_norm, dropout,
softmax_with_cross_entropy (forward).

Port of the matching rules in `paddle_tpu/ops/nn_ops.py` (layer_norm:280,
dropout:407, softmax_with_cross_entropy:487). Their grad makers and grad
lowerings come with the training slice.
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


@register_op("dropout", stateful=True, non_diff_outputs={"Mask"})
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


@register_op("softmax_with_cross_entropy", no_grad_inputs={"Label"})
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
