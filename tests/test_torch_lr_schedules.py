"""The LR schedules of the PyTorch port (`layers.learning_rate_scheduler`)
against the JAX package's, on the CPU, after JAX's TestLRScheduler
(tests/test_optimizer_ops.py:157): a one-layer regression trained with
SGD (Adam for noam) on the schedule's learning rate.

  * both DSLs build the same program and startup, op for op, and every
    schedule op carries op_role "lr_sched" (so clone(for_test=True)
    drops it);
  * each schedule's value over 10 steps (the step counter is raised
    before use, so step 1 is the first value) within 1e-6 relative of
    JAX's: noam, exponential, natural_exp and inverse_time (smooth and
    staircase), polynomial (with and without cycle), piecewise, cosine,
    and linear warmup to a constant and to a schedule;
  * piecewise and polynomial(cycle=True) also equal the closed forms of
    JAX's own tests.
"""

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_gpt_inference import _program_dict
from torch_port_common import one_torch_thread  # noqa: F401


STEPS = 10
RTOL = 1e-6

# id -> schedule builder (layers module) -> lr Variable
SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, warmup_steps=4),
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.1, 3, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 3, 0.5),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.1, 3, 0.5, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 3, 0.5),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.1, 3, 0.5, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 6, 0.01, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(
        0.1, decay_steps=3, end_learning_rate=0.01, power=1.0, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([2, 4], [0.1, 0.01, 0.001]),
    "cosine": lambda L: L.cosine_decay(0.1, 2, 6),
    "warmup_const": lambda L: L.linear_lr_warmup(0.1, 4, 0.0, 0.1),
    "warmup_schedule": lambda L: L.linear_lr_warmup(
        L.exponential_decay(0.1, 3, 0.5), 4, 0.01, 0.1),
}


def _program(pkg, name):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [2])
        y = pkg.layers.data("y", [1])
        pred = pkg.layers.fc(x, 1, bias_attr=False)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        lr = SCHEDULES[name](pkg.layers)
        opt = pkg.optimizer.Adam if name == "noam" else pkg.optimizer.SGD
        opt(lr).minimize(loss)
    return main, startup, lr


def _values(pkg, name):
    main, startup, lr = _program(pkg, name)
    exe = pt.Executor() if pkg is pt else ptt.Executor(ptt.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 2), "f"), "y": np.ones((2, 1), "f")}
    return [float(np.ravel(exe.run(main, feed=feed, fetch_list=[lr],
                                   scope=scope)[0])[0])
            for _ in range(STEPS)], main, startup


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    jvals, jmain, jstart = _values(pt, name)
    tvals, tmain, tstart = _values(ptt, name)
    assert _program_dict(tmain) == _program_dict(jmain)
    assert _program_dict(tstart) == _program_dict(jstart)
    np.testing.assert_allclose(tvals, jvals, rtol=RTOL, atol=0)
    assert len(set(tvals)) > 1, tvals
    sched = [op for op in tmain.global_block.ops
             if op.attrs.get("op_role") == "lr_sched"]
    assert sched and sched[0].type == "increment"
    test_types = [op.type for op in
                  tmain.clone(for_test=True).global_block.ops]
    assert "increment" not in test_types


def test_closed_forms():
    """JAX's TestLRScheduler expectations, on the port."""
    vals = _values(ptt, "piecewise")[0]
    np.testing.assert_allclose(
        vals[:6], [0.1, 0.01, 0.01, 0.001, 0.001, 0.001], rtol=RTOL)
    vals = _values(ptt, "polynomial_cycle")[0]
    want = [0.09 * (1 - st / (3 * np.ceil(st / 3))) + 0.01
            for st in range(1, STEPS + 1)]
    np.testing.assert_allclose(vals, want, rtol=1e-5)
    vals = _values(ptt, "noam")[0]
    assert int(np.argmax(vals)) == 3   # the warmup peaks at warmup_steps
