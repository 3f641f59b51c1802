"""Ops of `paddle_tpu/ops/extra_ops.py`: eye (:17), label_smooth (:52),
selu (:66, the JAX registry's final selu), reverse (:91) and is_empty
(:141), the ones the layer files append. The rest of that file comes with
ROADMAP A.7.

label_smooth's, selu's and reverse's grads take the generic vjp path;
eye and is_empty have none.
"""

import torch

from ..framework.registry import register_op, torch_dtype


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
