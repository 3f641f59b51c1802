"""Activation ops: every entry of the JAX package's activation table,
log_softmax and maxout.

Port of `paddle_tpu/ops/activation_ops.py`: the `_ACTS` table (:19-71),
`_register_round` (:79-88), softmax (:91), log_softmax (:101) and maxout
(:107); `selu` is the JAX registry's final rule, `ops/extra_ops.py:66`,
and `sign` is `ops/misc_ops.py:396` (differentiable), both registered in
the port's `misc_ops.py`/`extra_ops.py`. Each map is written as the JAX
rule writes it, not as torch's nearest function: softplus is
logaddexp(x, 0) (no threshold), leaky_relu is where(x >= 0, x, alpha x)
with JAX's default alpha 0.02, elu is alpha * expm1 under a where. gelu's
`approximate=True` is the tanh form (GPT-2's gelu_new, the form the
models' FFN uses, `models/_common.py`), `approximate=False` the exact erf
form. softmax computes in f32 and returns the input's dtype, so under AMP
bf16 only halves the memory traffic. Every activation's grad takes the
generic vjp path (relu's is 0 at 0, as jax.nn.relu's); the rounding ops
have none. `round` rounds half to even, as jnp.round.
"""

import torch

from ..framework.registry import register_op


def _register_act(name, fn):
    @register_op(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0], attrs)]}


def _where0(cond, x):
    """jnp.where(cond, x, 0.0): a 0-d zero of x's dtype on x's device."""
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0), no threshold
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _softshrink(x, a):
    lam = a.get("lambda", 0.5)
    return torch.where(x > lam, x - lam, _where0(x < -lam, x + lam))


_ACTS = {
    "relu": lambda x, a: torch.relu(x),
    "relu6": lambda x, a: torch.clamp(x, 0.0, a.get("threshold", 6.0)),
    "sigmoid": lambda x, a: torch.sigmoid(x),
    "logsigmoid": lambda x, a: -_softplus(-x),
    "tanh": lambda x, a: torch.tanh(x),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "gelu": lambda x, a: torch.nn.functional.gelu(
        x, approximate="tanh" if a.get("approximate", False) else "none"),
    "leaky_relu": lambda x, a: torch.where(x >= 0, x,
                                           a.get("alpha", 0.02) * x),
    "elu": lambda x, a: torch.where(
        x > 0, x, a.get("alpha", 1.0) * torch.expm1(_where0(x <= 0, x))),
    "softplus": lambda x, a: _softplus(x),
    "softsign": lambda x, a: x / (torch.abs(x) + 1),
    "swish": lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x),
    "silu": lambda x, a: x * torch.sigmoid(x),
    "hard_sigmoid": lambda x, a: torch.clamp(
        a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0),
    "hard_swish": lambda x, a: x * torch.clamp(
        x + a.get("offset", 3.0), 0.0, a.get("threshold", 6.0))
        / a.get("scale", 6.0),
    "mish": lambda x, a: x * torch.tanh(_softplus(x)),
    "exp": lambda x, a: torch.exp(x),
    "log": lambda x, a: torch.log(x),
    "log2": lambda x, a: torch.log2(x),
    "log10": lambda x, a: torch.log10(x),
    "log1p": lambda x, a: torch.log1p(x),
    "sqrt": lambda x, a: torch.sqrt(x),
    "rsqrt": lambda x, a: torch.rsqrt(x),
    "square": lambda x, a: torch.square(x),
    "abs": lambda x, a: torch.abs(x),
    "reciprocal": lambda x, a: 1.0 / x,
    "sin": lambda x, a: torch.sin(x),
    "cos": lambda x, a: torch.cos(x),
    "tan": lambda x, a: torch.tan(x),
    "asin": lambda x, a: torch.asin(x),
    "acos": lambda x, a: torch.acos(x),
    "atan": lambda x, a: torch.atan(x),
    "sinh": lambda x, a: torch.sinh(x),
    "cosh": lambda x, a: torch.cosh(x),
    "erf": lambda x, a: torch.erf(x),
    "pow": lambda x, a: torch.pow(x, a.get("factor", 1.0)),
    "stanh": lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
        a.get("scale_a", 0.67) * x),
    "softshrink": _softshrink,
    "hard_shrink": lambda x, a: _where0(
        torch.abs(x) > a.get("threshold", 0.5), x),
    "thresholded_relu": lambda x, a: _where0(
        x > a.get("threshold", 1.0), x),
    "brelu": lambda x, a: torch.clamp(x, a.get("t_min", 0.0),
                                      a.get("t_max", 24.0)),
}

for _name, _fn in _ACTS.items():
    _register_act(_name, _fn)


def _register_round(name, fn):
    @register_op(name, not_differentiable=True, grad_free=True)
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0])]}


_register_round("floor", torch.floor)
_register_round("ceil", torch.ceil)
_register_round("round", torch.round)


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    x = ins["X"][0]
    out = torch.softmax(x.float(), dim=attrs.get("axis", -1))
    return {"Out": [out.to(x.dtype)]}


@register_op("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return {"Out": [torch.log_softmax(ins["X"][0],
                                      dim=attrs.get("axis", -1))]}


@register_op("maxout")
def _maxout(ctx, ins, attrs):
    """Max over each run of `groups` consecutive channels (NCHW)."""
    x = ins["X"][0]
    groups = attrs["groups"]
    n, c, h, w = x.shape
    return {"Out": [torch.amax(x.reshape(n, c // groups, groups, h, w),
                               dim=2)]}
