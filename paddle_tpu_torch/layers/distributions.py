"""Probability distributions over graph Variables (reference:
python/paddle/fluid/layers/distributions.py): Uniform, Normal,
Categorical and MultivariateNormalDiag, with sample, entropy, log_prob and
kl_divergence as graph-building methods.

Copied from `paddle_tpu/layers/distributions.py`: the same ops, so a
program built by either DSL serializes alike. The samplers draw with the
uniform_random and gaussian_random ops, on the run's torch.Generator.
"""

from __future__ import annotations

import math

from . import math as _m
from . import nn as _nn
from . import tensor as _t
from ..framework.layer_helper import LayerHelper

__all__ = ["Distribution", "Uniform", "Normal", "Categorical",
           "MultivariateNormalDiag"]


def _as_var(v, dtype="float32"):
    from ..framework.core import Variable
    if isinstance(v, Variable):
        return v
    return _t.fill_constant([1], dtype, float(v))


class Distribution:
    def sample(self, shape=None, seed=0):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    """U[low, high) (reference distributions.py Uniform)."""

    def __init__(self, low, high):
        self.low = _as_var(low)
        self.high = _as_var(high)

    def sample(self, shape, seed=0):
        helper = LayerHelper("uniform_sample")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op("uniform_random", {}, {"Out": [out.name]},
                         {"shape": list(shape), "dtype": "float32",
                          "min": 0.0, "max": 1.0, "seed": seed})
        return self.low + out * (self.high - self.low)

    def entropy(self):
        return _nn.log(self.high - self.low)

    def log_prob(self, value):
        # -log(high-low) inside the support; caller keeps values in range
        return 0.0 - _nn.log(self.high - self.low) + value * 0.0

    def kl_divergence(self, other):
        raise NotImplementedError("uniform KL depends on support overlap")


class Normal(Distribution):
    def __init__(self, loc, scale):
        self.loc = _as_var(loc)
        self.scale = _as_var(scale)

    def sample(self, shape, seed=0):
        helper = LayerHelper("normal_sample")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op("gaussian_random", {}, {"Out": [out.name]},
                         {"shape": list(shape), "dtype": "float32",
                          "mean": 0.0, "std": 1.0, "seed": seed})
        return self.loc + out * self.scale

    def entropy(self):
        c = 0.5 + 0.5 * math.log(2.0 * math.pi)
        return c + _nn.log(self.scale)

    def log_prob(self, value):
        var = self.scale * self.scale
        c = -0.5 * math.log(2.0 * math.pi)
        return c - _nn.log(self.scale) \
            - (value - self.loc) * (value - self.loc) / (2.0 * var)

    def kl_divergence(self, other):
        """KL(self || other), both Normal."""
        var_ratio = (self.scale / other.scale)
        var_ratio = var_ratio * var_ratio
        t1 = (self.loc - other.loc) / other.scale
        t1 = t1 * t1
        return 0.5 * (var_ratio + t1 - 1.0) - _nn.log(
            self.scale / other.scale)


class Categorical(Distribution):
    def __init__(self, logits):
        self.logits = logits

    def entropy(self):
        p = _nn.softmax(self.logits)
        logp = _nn.log_softmax(self.logits)
        return _m.scale(_m.reduce_sum(p * logp, dim=-1), scale=-1.0)

    def log_prob(self, value):
        """value: int64 [..., 1] class indices."""
        logp = _nn.log_softmax(self.logits)
        oh = _nn.one_hot(value, self.logits.shape[-1])
        return _m.reduce_sum(logp * oh, dim=-1)

    def kl_divergence(self, other):
        p = _nn.softmax(self.logits)
        return _m.reduce_sum(
            p * (_nn.log_softmax(self.logits)
                 - _nn.log_softmax(other.logits)), dim=-1)


class MultivariateNormalDiag(Distribution):
    def __init__(self, loc, scale):
        """loc [.., d], scale [.., d] (diagonal stddev)."""
        self.loc = loc
        self.scale = scale

    def entropy(self):
        d = self.loc.shape[-1]
        c = 0.5 * d * (1.0 + math.log(2.0 * math.pi))
        return c + _m.reduce_sum(_nn.log(self.scale), dim=-1)

    def log_prob(self, value):
        d = self.loc.shape[-1]
        z = (value - self.loc) / self.scale
        return -0.5 * _m.reduce_sum(z * z, dim=-1) \
            - _m.reduce_sum(_nn.log(self.scale), dim=-1) \
            - 0.5 * d * math.log(2.0 * math.pi)

    def kl_divergence(self, other):
        ratio = self.scale / other.scale
        t1 = _m.reduce_sum(ratio * ratio, dim=-1)
        diff = (self.loc - other.loc) / other.scale
        t2 = _m.reduce_sum(diff * diff, dim=-1)
        d = self.loc.shape[-1]
        t3 = _m.reduce_sum(_nn.log(other.scale) - _nn.log(self.scale),
                           dim=-1)
        return 0.5 * (t1 + t2 - float(d)) + t3
