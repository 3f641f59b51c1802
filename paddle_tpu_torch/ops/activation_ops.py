"""Activation ops of the GPT, BERT and ResNet slices: relu, gelu, softmax;
sqrt, which the global-norm clip appends; sigmoid and tanh, which the
book models and `nets.glu` append; square (the control-flow tests'
losses, GradientMerge's); exp, pow and cos, which the LR schedules
append; and the rounding ops floor, ceil, round and sign (the
schedules' staircases, the L1 regularizer).

Port of the `relu` (:20), `sigmoid` (:22), `tanh` (:24), `gelu` (:26),
`exp` (:41), `sqrt` (:46), `square` (:48), `cos` (:52), `pow` (:60) and `softmax` (:91)
entries of `paddle_tpu/ops/activation_ops.py` and of its `_register_round`
table (:79-88). gelu's `approximate=True` is the tanh form (GPT-2's
gelu_new, the form the models' FFN uses, `models/_common.py`),
`approximate=False` the exact erf form. softmax computes in f32 and
returns the input's dtype, so under AMP bf16 only halves the memory
traffic. The activations' grads take the generic vjp path (relu's is 0
at 0, as jax.nn.relu's); the rounding ops have none. `round` rounds half
to even, as jnp.round.
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


@register_op("square")
def _square(ctx, ins, attrs):
    return {"Out": [torch.square(ins["X"][0])]}


@register_op("exp")
def _exp(ctx, ins, attrs):
    return {"Out": [torch.exp(ins["X"][0])]}


@register_op("cos")
def _cos(ctx, ins, attrs):
    return {"Out": [torch.cos(ins["X"][0])]}


@register_op("pow")
def _pow(ctx, ins, attrs):
    return {"Out": [torch.pow(ins["X"][0], attrs.get("factor", 1.0))]}


def _register_round(name, fn):
    @register_op(name, not_differentiable=True, grad_free=True)
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0])]}


_register_round("floor", torch.floor)
_register_round("ceil", torch.ceil)
_register_round("round", torch.round)
_register_round("sign", torch.sign)


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    x = ins["X"][0]
    out = torch.softmax(x.float(), dim=attrs.get("axis", -1))
    return {"Out": [out.to(x.dtype)]}
