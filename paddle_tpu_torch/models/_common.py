"""Shared transformer building blocks of the port's models (copy of the
GPT-relevant part of `paddle_tpu/models/_common.py`: the same layers, names
and initializers, so programs built by either package serialize alike)."""

from __future__ import annotations

import paddle_tpu_torch as pt
from ..framework.layer_helper import ParamAttr
from ..initializer import Constant, Normal

__all__ = ["attr", "layer_norm", "ffn", "check_max_pos"]


def attr(name, cfg):
    return ParamAttr(name=name, initializer=Normal(0.0, cfg.init_range))


def layer_norm(x, name):
    return pt.layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name=f"{name}.scale",
                             initializer=Constant(1.0)),
        bias_attr=ParamAttr(name=f"{name}.bias"))


def ffn(x, cfg, prefix, names=("ffn1", "ffn2"), act="gelu"):
    """Two-matmul feed-forward: hidden -> cfg.ffn (act) -> hidden. gelu is
    the tanh approximation (GPT-2's gelu_new, BERT's TF modeling.py); any
    other `act` is the first fc's activation."""
    n1, n2 = names
    h1 = pt.layers.fc(x, cfg.ffn, num_flatten_dims=2,
                      act=None if act == "gelu" else act,
                      param_attr=attr(f"{prefix}/{n1}.w", cfg),
                      bias_attr=ParamAttr(name=f"{prefix}/{n1}.b"))
    if act == "gelu":
        h1 = pt.layers.gelu(h1, approximate=True)
    return pt.layers.fc(h1, cfg.hidden, num_flatten_dims=2,
                        param_attr=attr(f"{prefix}/{n2}.w", cfg),
                        bias_attr=ParamAttr(name=f"{prefix}/{n2}.b"))


def check_max_pos(seq, cfg):
    if seq > cfg.max_pos:
        raise ValueError(
            f"sequence length {seq} exceeds max_pos {cfg.max_pos}; the "
            "position table would silently clip (raise max_pos)")
