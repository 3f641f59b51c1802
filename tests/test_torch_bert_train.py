"""BERT MLM pretrain step of the PyTorch port against the JAX package, on the
CPU, at `__graft_entry__._small_cfg()` size (vocab 1024, hidden 128, 2
layers, 4 heads, ffn 512) with dropout 0, s=128, batch 4, and a padding
`input_mask` (each row's last 10-40 % masked).

  * both DSLs build the same train program, ops, slots, attrs and declared
    dtypes included, for attn_impl einsum and fused, with and without the
    bf16 AMP rewrite (and the same startup program);
  * from the JAX startup values carried over with io.set_params_from_numpy,
    3 Adam steps in fp32 match JAX's losses to 1e-5 relative and its
    step-1 gradients to 1e-6 + 1e-4 relative, on both attention paths.
    On the fused path FLAGS_attention_impl=flash runs JAX's Pallas
    single-pass kernels (interpret mode) with the mask as a per-key bias,
    against the port's plain versions of its kernels;
  * the same in bf16 AMP on the fused path, at the tolerances stated in
    `test_amp_adam_steps_match_jax`;
  * optimizer="lamb" builds JAX's program (fp32 and AMP) and 3 LAMB steps
    match JAX's;
  * the options no slice has ported raise.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.models import bert as tbert
from test_torch_gpt_inference import _program_dict
from torch_port_common import one_torch_thread  # noqa: F401


SEQ, BATCH, LR, STEPS = 128, 4, 1e-3, 3
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4


def _cfg(mod, impl, dropout=0.0):
    # __graft_entry__._small_cfg() with the dropout and attention path set
    return mod.BertConfig(vocab_size=1024, hidden=128, layers=2, heads=4,
                          ffn=512, max_pos=128, dropout=dropout,
                          attn_impl=impl)


def _build(impl, amp, dropout=0.0, optimizer="adam"):
    with pt.unique_name_guard():
        jprog = jbert.bert_pretrain_program(_cfg(jbert, impl, dropout), SEQ,
                                            learning_rate=LR, amp=amp,
                                            optimizer=optimizer)
    with ptt.unique_name_guard():
        tprog = tbert.bert_pretrain_program(_cfg(tbert, impl, dropout), SEQ,
                                            learning_rate=LR, amp=amp,
                                            optimizer=optimizer)
    return jprog, tprog


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("impl", ["einsum", "fused"])
def test_train_program_matches_jax(impl, amp):
    (jmain, jstart, _), (tmain, tstart, _) = _build(impl, amp, dropout=0.1)
    types = [op.type for op in tmain.global_block.ops]
    assert types == [op.type for op in jmain.global_block.ops]
    want = {"adam", "sum", "layer_norm_grad", "lookup_table_grad",
            "softmax_with_cross_entropy_grad", "dropout_grad"}
    want |= {"fused_attention", "fused_attention_grad"} if impl == "fused" \
        else {"einsum", "einsum_grad", "softmax_grad"}
    if amp:
        want |= {"cast", "cast_grad"}
    assert want <= set(types)
    assert _program_dict(tmain) == _program_dict(jmain)
    assert _program_dict(tstart) == _program_dict(jstart)
    if amp:
        blk = tmain.global_block
        assert blk.var(blk.ops[-1].input("Grad")[0]).dtype == "float32"
        assert any(v.dtype == "bfloat16" for v in blk.vars.values())


def _feed(step):
    r = np.random.RandomState(50 + step)
    lens = r.randint(int(0.6 * SEQ), int(0.9 * SEQ) + 1, BATCH)
    return {"src_ids": r.randint(0, 1024, (BATCH, SEQ)).astype("int64"),
            "sent_ids": r.randint(0, 2, (BATCH, SEQ)).astype("int64"),
            "input_mask": (np.arange(SEQ)[None] < lens[:, None])
            .astype("float32"),
            "mlm_labels": r.randint(0, 1024, (BATCH, SEQ)).astype("int64")}


def _run(exe, main, fetch, scope, params, steps):
    """`steps` train steps; (losses, step-1 grads, params after)."""
    grads = [p + "@GRAD" for p in params]
    losses, g1 = [], None
    for i in range(steps):
        res = exe.run(main, feed=_feed(i),
                      fetch_list=[fetch["loss"]] + (grads if i == 0 else []),
                      scope=scope)
        losses.append(float(np.ravel(res[0])[0]))
        if i == 0:
            g1 = {n: np.asarray(g, np.float32) for n, g in zip(grads,
                                                                res[1:])}
    state = {n: np.asarray(scope.find_var(n)) if isinstance(scope, pt.Scope)
             else scope.get_numpy(n) for n in params}
    return losses, g1, state


def _trajectories(impl, amp, steps=STEPS, optimizer="adam"):
    """JAX and port runs of `steps` steps of `optimizer` from the JAX
    startup values; returns (jax run, port run, parameter names, JAX
    init)."""
    (jmain, jstart, jf), (tmain, _, tf) = _build(impl, amp,
                                                 optimizer=optimizer)
    jscope = pt.Scope()
    jexe = pt.Executor()
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.asarray(jscope.find_var(v.name))
            for v in jmain.list_vars()
            if v.persistable and jscope.find_var(v.name) is not None}
    tscope = ptt.Scope()
    ptt.io.set_params_from_numpy(tscope, init, "cpu")
    params = [p.name for p in jmain.global_block.all_parameters()]
    jrun = _run(jexe, jmain, jf, jscope, params, steps)
    trun = _run(ptt.Executor(ptt.CPUPlace()), tmain, tf, tscope, params,
                steps)
    return jrun, trun, params, init


@pytest.mark.parametrize("impl", ["einsum", "fused"])
def test_adam_steps_match_jax(impl, monkeypatch):
    """fp32. Measured: losses within 1.4e-7 relative, every step-1
    gradient within 0.015 of its tolerance (the embeddings' sums the
    closest), parameters within 1.2e-6 after 3 steps."""
    if impl == "fused":
        monkeypatch.setenv("FLAGS_attention_impl", "flash")
    jrun, trun, params, _ = _trajectories(impl, amp=False)
    np.testing.assert_allclose(trun[0], jrun[0], rtol=LOSS_RTOL)
    for n, g in jrun[1].items():
        np.testing.assert_allclose(trun[1][n], g, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=n)
    for n in params:
        np.testing.assert_allclose(trun[2][n], jrun[2][n], atol=1e-5,
                                   rtol=0, err_msg=n)


def test_amp_adam_steps_match_jax(monkeypatch):
    """bf16 AMP on the fused path (JAX's interpret-mode Pallas kernels on
    bf16 operands against the port's plain versions). Held:

      * losses within 1e-3 relative of JAX's AMP run (measured 6.5e-6);
      * step-1 gradients, per tensor, within 2e-2 * max|g| + 1e-6 of the
        exact gradient, JAX's fp32 one (measured worst 0.0113 * max|g|, an
        ffn1 bias), and every weight matrix also within that of JAX's AMP
        gradient (measured 0.0122 * max|g|, l1/q.w). JAX's own AMP bias
        gradients lie up to 0.060 * max|g| from its fp32 ones (l1/v.b),
        the port's within 0.0113: XLA sums the bf16 cotangents over the
        broadcast dims at lower precision than torch's f32 accumulation,
        so the AMP-to-AMP gap of a bias is JAX's rounding, not the port's;
      * parameters after 3 steps within 2 * lr * 3 (measured 0.0024,
        l1/ffn1.w): Adam normalises each gradient, so bf16 noise in a
        small gradient moves a parameter by up to lr a step.

    The attention key biases (every l*/k.b) have an exact gradient of 0
    (softmax is invariant to a per-row constant); theirs is rounding noise
    and the 1e-6 atol holds it."""
    monkeypatch.setenv("FLAGS_attention_impl", "flash")
    jrun, trun, params, init = _trajectories("fused", amp=True)
    np.testing.assert_allclose(trun[0], jrun[0], rtol=1e-3)
    assert all(np.isfinite(trun[0]))

    # the exact step-1 gradients: JAX's fp32 program from the same values
    with pt.unique_name_guard():
        jmain, _, jf = jbert.bert_pretrain_program(
            _cfg(jbert, "fused"), SEQ, learning_rate=LR)
    jscope = pt.Scope()
    for n, v in init.items():
        jscope.set_var(n, v)
    exact = _run(pt.Executor(), jmain, jf, jscope, params, 1)[1]
    for n, g in exact.items():
        tol = 2e-2 * np.abs(g).max() + 1e-6
        assert np.abs(trun[1][n] - g).max() <= tol, n
        if g.ndim == 2:
            assert np.abs(trun[1][n] - jrun[1][n]).max() <= tol, n
    for n in params:
        np.testing.assert_allclose(trun[2][n], jrun[2][n],
                                   atol=2 * LR * STEPS, rtol=0, err_msg=n)


@pytest.mark.parametrize("kw", [{"pipeline_microbatches": 2},
                                {"recompute": True}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        tbert.bert_pretrain_program(_cfg(tbert, "fused"), SEQ, **kw)


@pytest.mark.parametrize("amp", [False, True])
def test_lamb_program_matches_jax(amp):
    """optimizer="lamb": the same program as JAX's, a lamb op a parameter
    (on the f32 master weights under AMP)."""
    (jmain, jstart, _), (tmain, tstart, _) = _build("fused", amp,
                                                    optimizer="lamb")
    assert _program_dict(tmain) == _program_dict(jmain)
    assert _program_dict(tstart) == _program_dict(jstart)
    types = [op.type for op in tmain.global_block.ops]
    assert types.count("lamb") == len(tmain.global_block.all_parameters())
    assert "adam" not in types


def test_lamb_steps_match_jax():
    """3 LAMB steps in fp32 on the einsum path from the JAX startup values:
    losses within 1e-5 relative, step-1 gradients within 1e-6 + 1e-4
    relative, parameters within 1e-5 after 3 steps. The attention key
    biases (every l*/k.b) have an exact gradient of 0 and start at 0, so
    their trust ratio is 1 and their rounding-noise direction moves them
    up to lr a step either way, as under Adam: those are held to
    2 * lr a step."""
    jrun, trun, params, _ = _trajectories("einsum", amp=False,
                                          optimizer="lamb")
    np.testing.assert_allclose(trun[0], jrun[0], rtol=LOSS_RTOL)
    for n, g in jrun[1].items():
        np.testing.assert_allclose(trun[1][n], g, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=n)
    for n in params:
        atol = 2 * LR * STEPS if n.endswith("/k.b") else 1e-5
        np.testing.assert_allclose(trun[2][n], jrun[2][n], atol=atol,
                                   rtol=0, err_msg=n)


def test_context_parallelism_raises():
    cfg = _cfg(tbert, "fused")
    cfg.cp_axis = "sp"
    with pytest.raises(NotImplementedError, match="not ported"):
        tbert.bert_pretrain_program(cfg, SEQ)


def test_tp_shardings_and_flops_match_jax():
    jcfg, tcfg = jbert.BertConfig(), tbert.BertConfig()
    assert tbert.tp_shardings(tcfg) == jbert.tp_shardings(jcfg)
    assert tbert.flops_per_step(tcfg, 16, 512) == \
        jbert.flops_per_step(jcfg, 16, 512)
