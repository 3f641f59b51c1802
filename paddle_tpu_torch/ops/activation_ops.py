"""Activation ops of the inference slice: gelu.

Port of the `gelu` entry of `paddle_tpu/ops/activation_ops.py` (:26):
`approximate=True` is the tanh form (GPT-2's gelu_new, the form the models'
FFN uses, `models/_common.py`), `approximate=False` the exact erf form.
"""

import torch

from ..framework.registry import register_op


@register_op("gelu")
def _gelu(ctx, ins, attrs):
    approx = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [torch.nn.functional.gelu(ins["X"][0], approximate=approx)]}
