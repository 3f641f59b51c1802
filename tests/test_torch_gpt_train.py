"""GPT training step of the PyTorch port against the JAX package, on the
CPU, at a tiny size (vocab 256, hidden 64, 2 layers, 4 heads, batch 2).

  * both DSLs build the same train program: ops, slots, attrs and vars,
    the grad ops, the `sum` of the tied gpt/wte's two grads and the `adam`
    ops included (dropout 0.1, so the dropout grads too);
  * with the JAX startup values carried across by io.set_params_from_numpy,
    dropout 0 and fp32, 3 Adam steps at s=256 and s=640 through
    Executor(CPUPlace()).run match JAX's per-step losses to 1e-5 relative
    and its step-1 gradients to 1e-6 + 1e-4 relative; the parameters and
    Adam moments after 3 steps are held to the tolerances stated at
    `_check_state`. attn_impl="flash" runs JAX's Pallas kernels in
    interpret mode against the port's kernels' plain versions;
    attn_impl="xla" the plain reference on both sides;
  * one SGD step matches too, and so do 3 LAMB steps
    (optimizer="lamb") and a regularized, clipped Adam step.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models.gpt import GPTConfig, gpt_lm_program
from paddle_tpu_torch.models import gpt as tgpt
from test_torch_gpt_inference import _program_dict
from torch_port_common import executor, one_torch_thread  # noqa: F401


LR = 1e-4
STEPS = 3
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4


def _cfg(mod, impl, dropout=0.0):
    return mod(vocab_size=256, hidden=64, layers=2, heads=4, max_pos=640,
               dropout=dropout, attn_impl=impl)


def _build(seq, impl, optimizer="adam", dropout=0.0):
    with pt.unique_name_guard():
        jprog = gpt_lm_program(_cfg(GPTConfig, impl, dropout), seq,
                               learning_rate=LR, optimizer=optimizer)
    with ptt.unique_name_guard():
        tprog = tgpt.gpt_lm_program(_cfg(tgpt.GPTConfig, impl, dropout), seq,
                                    learning_rate=LR, optimizer=optimizer)
    return jprog, tprog


@pytest.mark.parametrize("seq,impl", [(256, "fused"), (640, "flash")])
def test_train_program_matches_jax(seq, impl):
    (jmain, jstart, _), (tmain, tstart, _) = _build(seq, impl, dropout=0.1)
    types = [op.type for op in tmain.global_block.ops]
    assert types == [op.type for op in jmain.global_block.ops]
    assert {"sum", "adam", "dropout_grad", "fused_attention_grad",
            "softmax_with_cross_entropy_grad", "lookup_table_grad",
            "mul_grad", "matmul_grad"} <= set(types)
    assert _program_dict(tmain) == _program_dict(jmain)
    assert _program_dict(tstart) == _program_dict(jstart)


def _tokens(seq, step, batch=2):
    return np.random.RandomState(100 + step).randint(
        0, 256, (batch, seq)).astype("int64")


def _trajectories(seq, impl, optimizer="adam", steps=STEPS):
    """Run `steps` train steps in both packages from the JAX startup
    values. Returns (jax, port) each as (losses, step-1 grads, final
    persistables) and the names of the parameters."""
    (jmain, jstart, jf), (tmain, _, tf) = _build(seq, impl, optimizer)
    jscope = pt.Scope()
    jexe = executor(pt)
    jexe.run(jstart, scope=jscope)
    persist = [v.name for v in jmain.list_vars() if v.persistable
               and jscope.find_var(v.name) is not None]
    init = {n: np.asarray(jscope.find_var(n)) for n in persist}
    tscope = ptt.Scope()
    ptt.io.set_params_from_numpy(tscope, init, "cpu")
    texe = ptt.Executor(ptt.CPUPlace())
    params = [p.name for p in jmain.global_block.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    out = []
    for exe, main, scope, f in ((jexe, jmain, jscope, jf),
                                (texe, tmain, tscope, tf)):
        losses, g1 = [], None
        for i in range(steps):
            res = exe.run(main, feed={"tokens": _tokens(seq, i)},
                          fetch_list=[f["loss"]] + (grads if i == 0 else []),
                          scope=scope)
            losses.append(float(np.ravel(res[0])[0]))
            if i == 0:
                g1 = {n: np.asarray(g) for n, g in zip(grads, res[1:])}
        state = {n: np.asarray(scope.find_var(n)) if scope is jscope
                 else scope.get_numpy(n) for n in persist}
        out.append((losses, g1, state))
    return out[0], out[1], params


def _check_losses_and_grads(jax_run, port_run):
    np.testing.assert_allclose(port_run[0], jax_run[0], rtol=LOSS_RTOL)
    for n, g in jax_run[1].items():
        np.testing.assert_allclose(port_run[1][n], g, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=n)


def _check_state(jax_state, port_state, params, steps):
    """Adam normalises each gradient, so a parameter whose gradient is
    rounding noise steps about lr either way in each package: every
    l*/k.b (key bias) has an exact gradient of 0 (softmax is invariant to
    a per-row constant). Those may differ by 2 * lr a step; every other
    parameter is held to 1e-5, and the moments to 1e-6 + 1e-3 relative
    (Moment2 is a square, hence its own atol)."""
    for n, want in jax_state.items():
        got = port_state[n]
        if n in params:
            atol = 2 * LR * steps if n.endswith("/k.b") else 1e-5
            np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                       err_msg=n)
        elif "moment2" in n:
            np.testing.assert_allclose(got, want, atol=1e-12, rtol=1e-3,
                                       err_msg=n)
        else:   # moment1, beta pows, learning rate
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-3,
                                       err_msg=n)


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("seq", [256, 640])
def test_adam_steps_match_jax(seq, impl):
    jax_run, port_run, params = _trajectories(seq, impl)
    _check_losses_and_grads(jax_run, port_run)
    _check_state(jax_run[2], port_run[2], params, STEPS)
    assert any("moment1" in n for n in jax_run[2])


def test_sgd_step_matches_jax():
    jax_run, port_run, params = _trajectories(256, "fused", "sgd", steps=1)
    _check_losses_and_grads(jax_run, port_run)
    for n in params:   # p - lr * g: no normalisation, held tightly
        np.testing.assert_allclose(port_run[2][n], jax_run[2][n], atol=1e-7,
                                   rtol=1e-6, err_msg=n)


def test_scope_tensors_are_ordinary_and_updated_by_rebinding(tmp_path):
    """The executor runs under torch.no_grad, not inference mode: after a
    startup and a train step the scope holds ordinary tensors, which the
    caller may update in place. With donate=False a step rebinds each
    parameter to a new tensor (it does not write into the old one).
    Tensors that io.load_persistables puts in a scope are rebound by the
    donating executor too (donate=True, the default: it writes in place
    only into tensors it bound itself, so from the second step on), and
    training resumes from them with the saved optimizer state."""
    with ptt.unique_name_guard():
        main, startup, f = tgpt.gpt_lm_program(_cfg(tgpt.GPTConfig, "fused"),
                                               256)
    exe = ptt.Executor(ptt.CPUPlace(), donate=False)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    w = scope.find_var("gpt/l0/q.w")
    before = w.clone()
    exe.run(main, feed={"tokens": _tokens(256, 0)}, fetch_list=[f["loss"]],
            scope=scope)
    w2 = scope.find_var("gpt/l0/q.w")
    assert w2 is not w and torch.equal(w, before)
    assert not w2.equal(before)
    for t in (w, w2, scope.find_var("gpt/wte")):
        assert not t.is_inference() and not t.requires_grad

    ptt.io.save_persistables(exe, str(tmp_path), main, scope=scope)
    loaded = ptt.Scope()
    ptt.io.load_persistables(exe, str(tmp_path), main, scope=loaded)
    w3 = loaded.find_var("gpt/l0/q.w")
    assert torch.equal(w3, w2) and not w3.is_inference()
    donating = ptt.Executor(ptt.CPUPlace())
    losses = [e.run(main, feed={"tokens": _tokens(256, 1)},
                    fetch_list=[f["loss"]], scope=s)[0] for e, s in
              ((exe, scope), (donating, loaded))]
    np.testing.assert_array_equal(losses[0], losses[1])
    assert torch.equal(loaded.find_var("gpt/l0/q.w"),
                       scope.find_var("gpt/l0/q.w"))
    w4 = loaded.find_var("gpt/l0/q.w")
    assert w4 is not w3 and torch.equal(w3, w2)   # io's tensor untouched
    donating.run(main, feed={"tokens": _tokens(256, 2)},
                 fetch_list=[f["loss"]], scope=loaded)
    assert loaded.find_var("gpt/l0/q.w") is w4    # now updated in place
    w2.add_(1.0)   # in place, outside the executor


@pytest.mark.parametrize("kw", [{"recompute": True}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        tgpt.gpt_lm_program(_cfg(tgpt.GPTConfig, "fused"), 256, **kw)


def test_lamb_steps_match_jax():
    """optimizer="lamb": the same program as JAX's, and 3 LAMB steps at
    s=256 on the fused path match JAX's losses, step-1 gradients and
    state as the Adam steps do (the k.b allowance of `_check_state`: a
    key bias starts at 0, so its trust ratio is 1 and its rounding-noise
    direction moves it up to lr a step either way)."""
    (jmain, jstart, _), (tmain, tstart, _) = _build(256, "fused", "lamb")
    assert _program_dict(tmain) == _program_dict(jmain)
    assert _program_dict(tstart) == _program_dict(jstart)
    assert "lamb" in [op.type for op in tmain.global_block.ops]
    jax_run, port_run, params = _trajectories(256, "fused", "lamb")
    _check_losses_and_grads(jax_run, port_run)
    _check_state(jax_run[2], port_run[2], params, STEPS)


def _regularized(pkg, mod):
    """GPT's forward (gpt_lm_program(is_test=True)) with Adam,
    L2Decay(1e-2) on every parameter, L1Decay(1e-3) on the token
    embedding through its ParamAttr, and a global-norm clip."""
    with pkg.unique_name_guard():
        main, startup, f = mod.gpt_lm_program(
            _cfg(mod.GPTConfig, "fused"), 256, is_test=True)
        main.global_block.var("gpt/wte").regularizer = \
            pkg.regularizer.L1Decay(1e-3)
        with pkg.program_guard(main, startup):
            pkg.optimizer.Adam(
                LR, regularization=pkg.regularizer.L2Decay(1e-2),
                grad_clip=pkg.clip.GradientClipByGlobalNorm(1.0)).minimize(
                f["loss"])
    return main, startup, f


def test_regularized_adam_step_matches_jax():
    """regularization= and a per-parameter regularizer with grad_clip=:
    the clip's ops come before the decay's, the program is JAX's op for
    op, and one step's loss and parameters match JAX's (parameters within
    1e-5, the k.b allowance of `_check_state` for the key biases)."""
    jmain, jstart, jf = _regularized(pt, jgpt)
    tmain, _, tf = _regularized(ptt, tgpt)
    assert _program_dict(tmain) == _program_dict(jmain)
    types = [op.type for op in tmain.global_block.ops]
    assert "sign" in types and types.index("sign") > max(
        i for i, op in enumerate(tmain.global_block.ops)
        if any("@CLIP" in n and "@REG" not in n
               for n in op.output_names()))
    jscope = pt.Scope()
    executor(pt).run(jstart, scope=jscope)
    persist = [v.name for v in jmain.list_vars() if v.persistable
               and jscope.find_var(v.name) is not None]
    tscope = ptt.Scope()
    ptt.io.set_params_from_numpy(
        tscope, {n: np.asarray(jscope.find_var(n)) for n in persist}, "cpu")
    feed = {"tokens": _tokens(256, 0)}
    jl, = executor(pt).run(jmain, feed=feed, fetch_list=[jf["loss"]],
                            scope=jscope)
    tl, = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                           fetch_list=[tf["loss"]],
                                           scope=tscope)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    params = [p.name for p in jmain.global_block.all_parameters()]
    _check_state({n: np.asarray(jscope.find_var(n)) for n in persist},
                 {n: tscope.get_numpy(n) for n in persist}, params, 1)


def test_gradients_seeded_with_ones_matches_jax():
    """gradients() without target_gradients seeds each target with
    fill_any_like(1), in both packages."""
    x = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    w = np.random.RandomState(4).randn(6, 5).astype(np.float32)
    res = []
    for pkg, exe in ((pt, executor(pt)),
                     (ptt, ptt.Executor(ptt.CPUPlace()))):
        main = pkg.Program()
        blk = main.global_block
        blk.create_var(name="x", shape=x.shape, dtype="float32")
        blk.create_var(name="w", shape=w.shape, dtype="float32")
        blk.append_op("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["y"]}, {})
        gx, gw = pkg.gradients([blk.var("y")], [blk.var("x"), blk.var("w")])
        res.append(([op.type for op in blk.ops],
                    exe.run(main, feed={"x": x, "w": w},
                            fetch_list=[gx.name, gw.name])))
    (jtypes, jvals), (ttypes, tvals) = res
    assert ttypes == jtypes == ["mul", "fill_any_like", "mul_grad"]
    for t, j in zip(tvals, jvals):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)
