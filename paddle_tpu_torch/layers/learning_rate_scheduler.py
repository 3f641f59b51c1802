"""LR schedules built as IR ops over a global step counter.

A copy of `paddle_tpu/layers/learning_rate_scheduler.py` (which imports no
JAX; reference: python/paddle/fluid/layers/learning_rate_scheduler.py):
noam, exponential, natural_exp, inverse_time, polynomial, piecewise,
cosine decay and linear warmup. Each returns a Variable recomputed by ops
of the step (op_role "lr_sched") from a persistable float32 step counter
that an `increment` op raises before use, so the value is computed on the
executor's device and nothing in a step reads it to the host.
"""

import math

from ..framework.core import unique_name
from ..framework.layer_helper import LayerHelper
from .tensor import create_global_var

__all__ = ["noam_decay", "exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "piecewise_decay",
           "cosine_decay", "linear_lr_warmup"]


_ROLE = {"op_role": "lr_sched"}


def _global_step():
    """float32 step counter incremented once per program run."""
    step = create_global_var(shape=[1], value=0.0, dtype="float32",
                             persistable=True,
                             name=unique_name("@LR_DECAY_COUNTER@"))
    helper = LayerHelper("lr_step")
    helper.append_op("increment", {"X": [step.name]}, {"Out": [step.name]},
                     {"step": 1.0, **_ROLE}, infer_shape=False)
    return step


def _unary(op_type, x, attrs=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(op_type, {"X": [x.name]}, {"Out": [out.name]},
                     {**(attrs or {}), **_ROLE})
    return out


def _binary(op_type, x, y, attrs=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(op_type, {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name]}, {**(attrs or {}), **_ROLE})
    return out


def _scale(x, s=1.0, b=0.0):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("scale", {"X": [x.name]}, {"Out": [out.name]},
                     {"scale": float(s), "bias": float(b), **_ROLE})
    return out


def _fill(value):
    helper = LayerHelper("fill_constant")
    out = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("fill_constant", {}, {"Out": [out.name]},
                     {"shape": [1], "dtype": "float32",
                      "value": float(value), **_ROLE})
    return out


def _less_than(x, y):
    helper = LayerHelper("less_than")
    out = helper.create_variable_for_type_inference("bool", True)
    helper.append_op("less_than", {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name]}, dict(_ROLE))
    return out


def _where(cond, x, y):
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("where",
                     {"Condition": [cond.name], "X": [x.name],
                      "Y": [y.name]}, {"Out": [out.name]}, dict(_ROLE))
    return out


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """lr = lr0 * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
    (reference learning_rate_scheduler.py noam_decay; Transformer schedule)"""
    step = _global_step()
    a = _unary("pow", step, {"factor": -0.5})
    b = _scale(step, s=warmup_steps ** -1.5)
    m = _binary("elementwise_min", a, b)
    return _scale(m, s=learning_rate * d_model ** -0.5)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _global_step()
    exponent = _scale(step, s=1.0 / decay_steps)
    if staircase:
        exponent = _unary("floor", exponent)
    rate = _fill(decay_rate)
    decay = _binary("elementwise_pow", rate, exponent)
    return _scale(decay, s=learning_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _global_step()
    exponent = _scale(step, s=1.0 / decay_steps)
    if staircase:
        exponent = _unary("floor", exponent)
    decay = _unary("exp", _scale(exponent, s=-decay_rate))
    return _scale(decay, s=learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _global_step()
    frac = _scale(step, s=1.0 / decay_steps)
    if staircase:
        frac = _unary("floor", frac)
    denom = _scale(frac, s=decay_rate, b=1.0)
    lr0 = _fill(learning_rate)
    return _binary("elementwise_div", lr0, denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _global_step()
    if cycle:
        # reference learning_rate_scheduler.py: the decay horizon grows
        # to decay_steps * ceil(step / decay_steps), so lr saws back up
        # at each multiple instead of flooring at end_learning_rate
        # true division, not a pre-rounded reciprocal: f32
        # step * (1/decay_steps) overshoots at exact multiples (e.g.
        # 21 * (1/7) = 3.0000002 -> ceil 4) and breaks cycle boundaries
        ratio = _unary("ceil", _binary("elementwise_div", step,
                                       _fill(float(decay_steps))))
        # step == 0 -> ceil == 0 would divide by zero; reference forces 1
        ratio = _binary("elementwise_max", ratio, _fill(1.0))
        horizon = _scale(ratio, s=float(decay_steps))
        frac = _scale(_binary("elementwise_div", step, horizon), s=-1.0,
                      b=1.0)
    else:
        capped = _unary("clip", step,
                        {"min": 0.0, "max": float(decay_steps)})
        frac = _scale(capped, s=-1.0 / decay_steps, b=1.0)
    p = _unary("pow", frac, {"factor": power})
    return _scale(p, s=learning_rate - end_learning_rate,
                  b=end_learning_rate)


def piecewise_decay(boundaries, values):
    """lr = values[i] for step in (boundaries[i-1], boundaries[i]]."""
    assert len(values) == len(boundaries) + 1
    step = _global_step()
    lr = _fill(values[-1])
    # build nested where() from the right
    for bound, val in zip(reversed(boundaries), reversed(values[:-1])):
        cond = _less_than(step, _fill(float(bound)))
        lr = _where(cond, _fill(val), lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """lr = 0.5*lr0*(1+cos(pi*epoch/epochs))"""
    step = _global_step()
    epoch = _unary("floor", _scale(step, s=1.0 / step_each_epoch))
    inner = _scale(epoch, s=math.pi / epochs)
    c = _unary("cos", inner)
    return _scale(_scale(c, b=1.0), s=0.5 * learning_rate)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _global_step()
    warm = _scale(step, s=(end_lr - start_lr) / warmup_steps, b=start_lr)
    if not hasattr(learning_rate, "name"):
        learning_rate = _fill(learning_rate)
    return _where(_less_than(step, _fill(float(warmup_steps))), warm,
                  learning_rate)
