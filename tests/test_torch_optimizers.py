"""Every optimizer of the PyTorch port against the JAX package's, on the
CPU, on a small fc program (6 -> 8 tanh -> 1, batch 16).

  * each optimizer class (and the Nesterov, centered and l1/l2 variants):
    both DSLs build the same program and startup, op for op; then 3 steps
    from the JAX startup values: losses within 1e-5 relative, parameters
    and every accumulator within 1e-5 (+ 1e-5 relative);
  * L1/L2 regularization, global and per parameter, each with a global
    norm clip: the clip's ops come before the decay's (the reference's
    clip-then-decay order) and 3 steps equal JAX's; a sparse grad is
    skipped with a warning;
  * ExponentialMovingAverage (shadows, `apply` and `restore`) and
    ModelAverage (windowed sums and `apply`) equal JAX's;
  * for each update op the donated update (Executor(donate=True), in
    place from the second step) is bitwise the out-of-place one
    (donate=False), and the parameter keeps its storage;
  * GradientMergeOptimizer(SGD, k_steps=4) (its inner update in a cond
    block): 8 micro-steps' parameters within 1e-6 of JAX's, unchanged
    inside each merge window, and after one window equal to one SGD step
    over the 4 micro-batches concatenated (tests/test_parallel_extras.py
    :87);
  * what still raises names its ROADMAP item: DGC with nranks > 1 and
    PipelineOptimizer (A.8);
  * the port imports neither jax nor paddle_tpu with this slice's
    modules loaded (a subprocess).
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.tools.control_flow_cases import (
    GM_K, gradient_merge_micro_batches, gradient_merge_program)
from test_torch_gpt_inference import _program_dict
from torch_port_common import one_torch_thread  # noqa: F401


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
STEPS = 3

# id -> optimizer factory (pkg) -> Optimizer
OPTS = {
    "sgd": lambda o: o.SGD(0.1),
    "momentum": lambda o: o.Momentum(0.05, 0.9),
    "momentum_nesterov": lambda o: o.Momentum(0.05, 0.9, use_nesterov=True),
    "lars_momentum": lambda o: o.LarsMomentum(0.5, 0.9),
    "adam": lambda o: o.Adam(0.01),
    "adamw": lambda o: o.AdamW(0.01, coeff=0.1),
    "lamb": lambda o: o.Lamb(0.01),
    "adagrad": lambda o: o.Adagrad(0.1),
    "decayed_adagrad": lambda o: o.DecayedAdagrad(0.1),
    "adadelta": lambda o: o.Adadelta(1.0),
    "adamax": lambda o: o.Adamax(0.01),
    "rmsprop": lambda o: o.RMSProp(0.01),
    "rmsprop_centered": lambda o: o.RMSProp(0.01, momentum=0.9,
                                            centered=True),
    "ftrl": lambda o: o.Ftrl(0.1, l1=0.01, l2=0.01),
    "proximal_gd": lambda o: o.ProximalGD(0.1, l1=0.01, l2=0.01),
    "proximal_adagrad": lambda o: o.ProximalAdagrad(0.1, l1=0.01, l2=0.01),
    "dgc": lambda o: o.DGCMomentumOptimizer(0.05, 0.9, sparsity=0.5),
}


def _fc_program(pkg, make_opt, param_attr=None):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [6], dtype="float32")
        y = pkg.layers.data("y", [1], dtype="float32")
        h = pkg.layers.fc(x, size=8, act="tanh", param_attr=param_attr)
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        make_opt(pkg).minimize(loss)
    main.random_seed = startup.random_seed = 5
    return main, startup, loss


def _feeds(steps=STEPS, batch=16):
    rng = np.random.RandomState(0)
    w = np.linspace(-1, 1, 6).astype(np.float32)
    out = []
    for _ in range(steps):
        x = rng.randn(batch, 6).astype(np.float32)
        out.append({"x": x, "y": np.sin(x @ w)[:, None].astype(np.float32)})
    return out


def _both_runs(make_opt, param_attr=None):
    """Build the program in both packages (`param_attr(pkg)`, when given,
    is the first fc's weight attr), run 3 steps of each from the JAX
    startup values. Returns (jax, port) as (losses, persistables) and the
    two main programs."""
    jmain, jstart, jloss = _fc_program(
        pt, make_opt, param_attr and param_attr(pt))
    tmain, tstart, tloss = _fc_program(
        ptt, make_opt, param_attr and param_attr(ptt))
    assert _program_dict(tmain) == _program_dict(jmain)
    assert _program_dict(tstart) == _program_dict(jstart)
    jscope = pt.Scope()
    jexe = pt.Executor()
    jexe.run(jstart, scope=jscope)
    persist = [v.name for v in jmain.list_vars() if v.persistable
               and jscope.find_var(v.name) is not None]
    tscope = ptt.Scope()
    ptt.io.set_params_from_numpy(
        tscope, {n: np.asarray(jscope.find_var(n)) for n in persist}, "cpu")
    texe = ptt.Executor(ptt.CPUPlace())
    out = []
    for exe, main, loss, scope in ((jexe, jmain, jloss, jscope),
                                   (texe, tmain, tloss, tscope)):
        losses = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0])[0])
                  for f in _feeds()]
        state = {n: np.asarray(scope.find_var(n)) if scope is jscope
                 else scope.get_numpy(n) for n in persist}
        out.append((losses, state))
    return out[0], out[1], (jmain, tmain)


def _check(jrun, trun):
    np.testing.assert_allclose(trun[0], jrun[0], rtol=TOL)
    for n, want in jrun[1].items():
        np.testing.assert_allclose(trun[1][n], want, atol=TOL, rtol=TOL,
                                   err_msg=n)


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_steps_match_jax(name):
    jrun, trun, (_, tmain) = _both_runs(lambda pkg: OPTS[name](
        pkg.optimizer))
    _check(jrun, trun)
    accs = [v.name for v in tmain.list_vars() if v.persistable
            and "/fc_" in v.name]
    assert name in ("sgd", "proximal_gd") or accs, name


# ---------------------------------------------------------------------------
# regularization
# ---------------------------------------------------------------------------

_REG = {
    "l2_global": (lambda pkg: pkg.regularizer.L2Decay(0.05), None),
    "l1_global": (lambda pkg: pkg.regularizer.L1Decay(0.05), None),
    "per_param": (lambda pkg: pkg.regularizer.L2Decay(0.05),
                  lambda pkg: pkg.ParamAttr(
                      name="fc_w_l1",
                      regularizer=pkg.regularizer.L1Decay(0.1))),
}
_REG_OPT = {"sgd": ("SGD", (0.1,)), "momentum": ("Momentum", (0.05, 0.9)),
            "adam": ("Adam", (0.01,))}


def _outs_with(block, tags, but="@REG"):
    """Indices of the ops writing a var whose name holds one of `tags`
    (a decayed grad's name extends the clipped grad's with `but`)."""
    return [i for i, op in enumerate(block.ops)
            if any(t in n and but not in n for n in op.output_names()
                   for t in tags)]


@pytest.mark.parametrize("opt", list(_REG_OPT))
@pytest.mark.parametrize("case", list(_REG))
def test_regularization_with_clip_matches_jax(case, opt):
    glob, attr = _REG[case]
    cls, args = _REG_OPT[opt]

    def make(pkg):
        return getattr(pkg.optimizer, cls)(
            *args, regularization=glob(pkg),
            grad_clip=pkg.clip.GradientClipByGlobalNorm(0.05))
    jrun, trun, (_, tmain) = _both_runs(make, attr)
    _check(jrun, trun)
    blk = tmain.global_block
    decay = _outs_with(blk, ("@L1DECAY", "@L2DECAY"))
    assert decay and max(_outs_with(blk, ("@CLIP",))) < min(decay)
    if case == "per_param":
        assert _outs_with(blk, ("fc_w_l1@SIGN",))


def test_regularizer_skips_sparse_grad_with_a_warning():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name_guard(), ptt.program_guard(main, startup):
        ids = ptt.layers.data("ids", [1], dtype="int64")
        emb = ptt.layers.embedding(ids, size=[7, 3], is_sparse=True)
        loss = ptt.layers.mean(emb)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ptt.optimizer.SGD(
                0.1, regularization=ptt.regularizer.L2Decay(0.1)).minimize(
                loss)
    assert any("sparse gradient" in str(w.message) for w in caught)
    assert "sign" not in [op.type for op in main.global_block.ops]
    assert not any("@L2DECAY" in n for op in main.global_block.ops
                   for n in op.output_names())


# ---------------------------------------------------------------------------
# EMA and ModelAverage
# ---------------------------------------------------------------------------

def _averaged(pkg, which):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [6], dtype="float32")
        y = pkg.layers.data("y", [1], dtype="float32")
        pred = pkg.layers.fc(pkg.layers.fc(x, 8, act="tanh"), 1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(0.1).minimize(loss)
        avg = (pkg.optimizer.ExponentialMovingAverage(0.9) if which == "ema"
               else pkg.optimizer.ModelAverage(max_average_window=2))
        avg.update()
    test = main.clone(for_test=True)
    return main, startup, loss, pred, test, avg


@pytest.mark.parametrize("which", ["ema", "model_average"])
def test_averaging_matches_jax(which):
    jmain, jstart, jloss, jpred, jtest, javg = _averaged(pt, which)
    tmain, tstart, tloss, tpred, ttest, tavg = _averaged(ptt, which)
    assert _program_dict(tmain) == _program_dict(jmain)
    assert _program_dict(tstart) == _program_dict(jstart)
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    persist = [v.name for v in jmain.list_vars() if v.persistable
               and jscope.find_var(v.name) is not None]
    tscope = ptt.Scope()
    ptt.io.set_params_from_numpy(
        tscope, {n: np.asarray(jscope.find_var(n)) for n in persist}, "cpu")
    feeds = _feeds(4)
    res = []
    for pkg, exe, main, loss, pred, test, avg, scope in (
            (pt, pt.Executor(), jmain, jloss, jpred, jtest, javg, jscope),
            (ptt, ptt.Executor(ptt.CPUPlace()), tmain, tloss, tpred, ttest,
             tavg, tscope)):
        for f in feeds:
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        state = {n: np.array(scope.find_var(n)) if pkg is pt
                 else scope.get_numpy(n) for n in persist}
        params = [p.name for p in main.all_parameters()]
        before = {n: state[n] for n in params}
        with pkg.scope_guard(scope):
            with avg.apply():
                out, = exe.run(test, feed=feeds[0], fetch_list=[pred],
                               scope=scope)
                applied = {n: np.array(scope.find_var(n)) if pkg is pt
                           else scope.get_numpy(n) for n in params}
        after = {n: np.array(scope.find_var(n)) if pkg is pt
                 else scope.get_numpy(n) for n in params}
        for n in params:   # restore() put the trained values back
            np.testing.assert_array_equal(after[n], before[n])
            assert not np.array_equal(applied[n], before[n]), n
        res.append((state, np.asarray(out), applied))
    (js, jo, ja), (ts, to, ta) = res
    for n, want in js.items():
        np.testing.assert_allclose(ts[n], want, atol=TOL, rtol=TOL,
                                   err_msg=n)
    for n, want in ja.items():
        np.testing.assert_allclose(ta[n], want, atol=TOL, rtol=TOL,
                                   err_msg=n)
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# donation: in place == out of place, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(OPTS))
def test_donated_update_is_bitwise_out_of_place(name):
    """4 steps with donate=True (in place from the second step: the
    parameter the first step bound is the scope's tensor to the end) and
    with donate=False (every step binds a new tensor and leaves the old
    one as it was): the same bits in every parameter and accumulator."""
    main, startup, loss = _fc_program(ptt, lambda pkg: OPTS[name](
        pkg.optimizer))
    states = []
    for donate in (True, False):
        exe = ptt.Executor(ptt.CPUPlace(), donate=donate)
        scope = ptt.Scope()
        exe.run(startup, scope=scope)
        feeds = _feeds(4)
        exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
        w1 = scope.find_var("fc_0.w_0")
        snap = w1.clone()
        for f in feeds[1:]:
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        w4 = scope.find_var("fc_0.w_0")
        if donate:
            assert w4 is w1 and not torch.equal(w4, snap)
        else:
            assert w4 is not w1 and torch.equal(w1, snap)
        states.append({n: scope.find_var(n).clone()
                       for n in scope.var_names()
                       if isinstance(scope.find_var(n), torch.Tensor)})
    donated, plain = states
    assert donated.keys() == plain.keys()
    for n in donated:
        assert torch.equal(donated[n], plain[n]), n


# ---------------------------------------------------------------------------
# what still raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make,item", [
    (lambda: ptt.optimizer.DGCMomentumOptimizer(0.1, 0.9, nranks=2),
     "A.8"),
    (lambda: ptt.optimizer.PipelineOptimizer(ptt.optimizer.SGD(0.1)),
     "A.8"),
], ids=["dgc_nranks2", "pipeline"])
def test_unported_optimizers_raise_naming_their_item(make, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        make()


# ---------------------------------------------------------------------------
# GradientMergeOptimizer (tests/test_parallel_extras.py:87)
# ---------------------------------------------------------------------------

def _gm_params(pkg, scope, main):
    return {p.name: np.array(scope.get_numpy(p.name) if pkg is ptt
                             else np.asarray(scope.find_var(p.name)))
            for p in main.global_block.all_parameters()}


def test_gradient_merge_matches_jax():
    """k=4 over 8 micro-steps: the programs are JAX's op for op, the
    parameters after every micro-step within 1e-6 of JAX's, and frozen
    inside each merge window."""
    jm, js, jl = gradient_merge_program(pt)
    tm, ts, tl = gradient_merge_program(ptt)
    assert _program_dict(tm) == _program_dict(jm)
    assert _program_dict(ts) == _program_dict(js)
    jscope, tscope = pt.Scope(), ptt.Scope()
    jexe, texe = pt.Executor(), ptt.Executor(ptt.CPUPlace())
    jexe.run(js, scope=jscope)
    init = {v.name: np.asarray(jscope.find_var(v.name))
            for v in jm.list_vars()
            if v.persistable and jscope.find_var(v.name) is not None}
    ptt.io.set_params_from_numpy(tscope, init, "cpu")
    prev = _gm_params(pt, jscope, jm)
    for i, f in enumerate(gradient_merge_micro_batches()):
        jexe.run(jm, feed=f, fetch_list=[jl], scope=jscope)
        texe.run(tm, feed=f, fetch_list=[tl], scope=tscope)
        jp, tp = _gm_params(pt, jscope, jm), _gm_params(ptt, tscope, tm)
        for n in jp:
            np.testing.assert_allclose(tp[n], jp[n], atol=1e-6, rtol=0,
                                       err_msg=f"{n} step {i}")
            if (i + 1) % GM_K:
                np.testing.assert_array_equal(tp[n], prev[n])
            else:
                assert not np.array_equal(tp[n], prev[n]), (n, i)
        prev = tp


def test_gradient_merge_equals_one_big_batch_step():
    """After one merge window the parameters equal one SGD step over the
    k micro-batches concatenated (averaged gradients)."""
    micro = gradient_merge_micro_batches()
    big = {k: np.concatenate([m[k] for m in micro[:GM_K]])
           for k in ("x", "y")}
    res = []
    for merge, feeds in ((True, micro[:GM_K]), (False, [big])):
        main, startup, loss = gradient_merge_program(ptt, merge)
        scope, exe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
        exe.run(startup, scope=scope)
        for f in feeds:
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        res.append(_gm_params(ptt, scope, main))
    for n in res[0]:
        np.testing.assert_allclose(res[0][n], res[1][n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_optimizer_surface_matches_jax():
    """The same public names (every alias of JAX's __all__)."""
    assert sorted(ptt.optimizer.__all__) == sorted(pt.optimizer.__all__)
    for n in pt.optimizer.__all__:
        assert hasattr(ptt.optimizer, n), n
    assert sorted(ptt.regularizer.__all__) == sorted(pt.regularizer.__all__)
    assert sorted(ptt.layers.learning_rate_scheduler.__all__) == sorted(
        pt.layers.learning_rate_scheduler.__all__)


def test_optimizer_slice_imports_neither_jax_nor_paddle_tpu():
    code = (
        "import sys, numpy as np\n"
        "import paddle_tpu_torch as ptt\n"
        "from paddle_tpu_torch.framework import selected_rows\n"
        "from paddle_tpu_torch import regularizer\n"
        "main, startup = ptt.Program(), ptt.Program()\n"
        "with ptt.program_guard(main, startup):\n"
        "    ids = ptt.layers.data('ids', [3, 1], dtype='int64')\n"
        "    e = ptt.layers.embedding(ids, size=[9, 4], is_sparse=True)\n"
        "    out, aux = ptt.nets.switch_moe_ffn(e, 2, 4, 8)\n"
        "    loss = ptt.layers.mean(out) + aux\n"
        "    lr = ptt.layers.cosine_decay(0.1, 2, 4)\n"
        "    ptt.optimizer.Lamb(lr, regularization=regularizer.L2Decay(\n"
        "        1e-3)).minimize(loss)\n"
        "exe = ptt.Executor(ptt.CPUPlace()); sc = ptt.Scope()\n"
        "exe.run(startup, scope=sc)\n"
        "ids = np.array([[[1], [1], [4]], [[2], [1], [8]]])\n"
        "l, = exe.run(main, feed={'ids': ids},\n"
        "             fetch_list=[loss], scope=sc)\n"
        "assert np.isfinite(l).all()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'paddle_tpu'\n"
        "             or m.startswith('paddle_tpu.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
