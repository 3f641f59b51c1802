"""Activation ops of the GPT and BERT slices: gelu, softmax.

Port of the `gelu` (:26) and `softmax` (:91) entries of
`paddle_tpu/ops/activation_ops.py`. gelu's `approximate=True` is the tanh
form (GPT-2's gelu_new, the form the models' FFN uses, `models/_common.py`),
`approximate=False` the exact erf form. softmax computes in f32 and returns
the input's dtype, so under AMP bf16 only halves the memory traffic. Both
grads take the generic vjp path.
"""

import torch

from ..framework.registry import register_op


@register_op("gelu")
def _gelu(ctx, ins, attrs):
    approx = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [torch.nn.functional.gelu(ins["X"][0], approximate=approx)]}


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    x = ins["X"][0]
    out = torch.softmax(x.float(), dim=attrs.get("axis", -1))
    return {"Out": [out.to(x.dtype)]}
