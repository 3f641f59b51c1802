"""GPT training under bf16 AMP in the PyTorch port against the JAX package,
on the CPU, at the size of tests/test_torch_gpt_train.py (vocab 256, hidden
64, 2 layers, 4 heads, batch 2).

  * both DSLs build the same AMP train program (`gpt_lm_program(...,
    amp=True)`: the optimizer wrapped by contrib.mixed_precision.decorate),
    casts, declared dtypes and grad ops included, and the same startup
    program;
  * from the JAX startup values carried over with io.set_params_from_numpy,
    3 Adam steps at s=640 with FLAGS_attention_impl=flash (the tiled
    forward, 128-key reference blocks, and the tiled backward pair; JAX's
    Pallas kernels in interpret mode against the port's plain versions,
    the forward's in bf16) hold to the tolerances of
    tests/test_torch_bert_train.py::test_amp_adam_steps_match_jax, the AMP
    gradients against JAX's fp32 ones.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models.gpt import GPTConfig, gpt_lm_program
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import flash_attention as tfa
from test_torch_gpt_inference import _program_dict
from test_torch_gpt_train import LR, STEPS, _cfg, _tokens
from torch_port_common import one_torch_thread  # noqa: F401


SEQ = 640


def _build(seq, impl, amp, dropout=0.0):
    with pt.unique_name_guard():
        jprog = gpt_lm_program(_cfg(GPTConfig, impl, dropout), seq,
                               learning_rate=LR, amp=amp)
    with ptt.unique_name_guard():
        tprog = tgpt.gpt_lm_program(_cfg(tgpt.GPTConfig, impl, dropout),
                                    seq, learning_rate=LR, amp=amp)
    return jprog, tprog


@pytest.mark.parametrize("seq,impl", [(256, "fused"), (640, "flash")])
def test_amp_train_program_matches_jax(seq, impl):
    (jmain, jstart, _), (tmain, tstart, _) = _build(seq, impl, True,
                                                    dropout=0.1)
    types = [op.type for op in tmain.global_block.ops]
    assert types == [op.type for op in jmain.global_block.ops]
    assert {"cast", "cast_grad", "adam", "fused_attention",
            "fused_attention_grad", "dropout_grad"} <= set(types)
    assert _program_dict(tmain) == _program_dict(jmain)
    assert _program_dict(tstart) == _program_dict(jstart)
    blk = tmain.global_block
    assert blk.var(blk.ops[-1].input("Grad")[0]).dtype == "float32"
    assert {blk.var(op.input("Q")[0]).dtype for op in blk.ops
            if op.type == "fused_attention"} == {"bfloat16"}


def _run(exe, main, fetch, scope, params, steps):
    """`steps` train steps; (losses, step-1 grads, params after)."""
    grads = [p + "@GRAD" for p in params]
    losses, g1 = [], None
    for i in range(steps):
        res = exe.run(main, feed={"tokens": _tokens(SEQ, i)},
                      fetch_list=[fetch["loss"]] + (grads if i == 0 else []),
                      scope=scope)
        losses.append(float(np.ravel(res[0])[0]))
        if i == 0:
            g1 = {n: np.asarray(g, np.float32) for n, g in zip(grads,
                                                                res[1:])}
    state = {n: np.asarray(scope.find_var(n)) if isinstance(scope, pt.Scope)
             else scope.get_numpy(n) for n in params}
    return losses, g1, state


def test_amp_adam_steps_match_jax(monkeypatch):
    """Held, as BERT's AMP run is: losses within 1e-3 relative of JAX's AMP
    run; step-1 gradients, per tensor, within 2e-2 * max|g| + 1e-6 of the
    exact gradient (JAX's fp32 one from the same values), every weight
    matrix also within that of JAX's AMP gradient; parameters after 3
    steps within 2 * lr * 3 of JAX's AMP run (Adam normalises each
    gradient, so bf16 noise in a small one moves a parameter by up to lr a
    step). The port's tiled forward runs in bf16 at every layer."""
    monkeypatch.setenv("FLAGS_attention_impl", "flash")
    seen = []
    plain = tfa.flash_fwd_plain

    def recording(q, *args, **kw):
        seen.append(q.dtype)
        return plain(q, *args, **kw)

    monkeypatch.setattr(tfa, "flash_fwd_plain", recording)
    (jmain, jstart, jf), (tmain, _, tf) = _build(SEQ, "fused", True)
    jscope = pt.Scope()
    jexe = pt.Executor()
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.asarray(jscope.find_var(v.name))
            for v in jmain.list_vars()
            if v.persistable and jscope.find_var(v.name) is not None}
    tscope = ptt.Scope()
    ptt.io.set_params_from_numpy(tscope, init, "cpu")
    params = [p.name for p in jmain.global_block.all_parameters()]
    jrun = _run(jexe, jmain, jf, jscope, params, STEPS)
    trun = _run(ptt.Executor(ptt.CPUPlace()), tmain, tf, tscope, params,
                STEPS)
    assert seen == [torch.bfloat16] * (2 * STEPS)   # 2 layers a step
    np.testing.assert_allclose(trun[0], jrun[0], rtol=1e-3)
    assert all(np.isfinite(trun[0]))

    # the exact step-1 gradients: JAX's fp32 program from the same values
    with pt.unique_name_guard():
        emain, _, ef = gpt_lm_program(_cfg(GPTConfig, "fused"), SEQ,
                                      learning_rate=LR)
    escope = pt.Scope()
    for n, v in init.items():
        escope.set_var(n, v)
    exact = _run(pt.Executor(), emain, ef, escope, params, 1)[1]
    for n, g in exact.items():
        tol = 2e-2 * np.abs(g).max() + 1e-6
        assert np.abs(trun[1][n] - g).max() <= tol, n
        if g.ndim == 2:
            assert np.abs(trun[1][n] - jrun[1][n]).max() <= tol, n
    for n in params:
        np.testing.assert_allclose(trun[2][n], jrun[2][n],
                                   atol=2 * LR * STEPS, rtol=0, err_msg=n)
