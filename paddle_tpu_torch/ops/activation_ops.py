"""Activation ops of the GPT, BERT and ResNet slices: relu, gelu, softmax;
sqrt, which the global-norm clip appends; and sigmoid and tanh, which the
book models and `nets.glu` append.

Port of the `relu` (:20), `sigmoid` (:22), `tanh` (:24), `gelu` (:26),
`sqrt` (:46) and `softmax` (:91) entries of
`paddle_tpu/ops/activation_ops.py`. gelu's `approximate=True` is the tanh
form (GPT-2's gelu_new, the form the models' FFN uses, `models/_common.py`),
`approximate=False` the exact erf form. softmax computes in f32 and returns
the input's dtype, so under AMP bf16 only halves the memory traffic. All
six grads take the generic vjp path (relu's is 0 at 0, as jax.nn.relu's).
"""

import torch

from ..framework.registry import register_op


@register_op("relu")
def _relu(ctx, ins, attrs):
    return {"Out": [torch.relu(ins["X"][0])]}


@register_op("sigmoid")
def _sigmoid(ctx, ins, attrs):
    return {"Out": [torch.sigmoid(ins["X"][0])]}


@register_op("tanh")
def _tanh(ctx, ins, attrs):
    return {"Out": [torch.tanh(ins["X"][0])]}


@register_op("gelu")
def _gelu(ctx, ins, attrs):
    approx = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [torch.nn.functional.gelu(ins["X"][0], approximate=approx)]}


@register_op("sqrt")
def _sqrt(ctx, ins, attrs):
    return {"Out": [torch.sqrt(ins["X"][0])]}


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    x = ins["X"][0]
    out = torch.softmax(x.float(), dim=attrs.get("axis", -1))
    return {"Out": [out.to(x.dtype)]}
