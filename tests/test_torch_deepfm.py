"""DeepFM (models/deepfm.py, BASELINE.json's CTR config) and log_loss in
the PyTorch port against the JAX package, on the CPU, at a small width
(4 fields, vocabulary 200, embedding 4, layers (16, 16)):

  * `deepfm()` builds JAX's program and startup, op for op;
  * one local is_sparse=True Adam step from the JAX startup values: the
    loss within 1e-5 relative and every gradient (the two sparse tables'
    densified) within 5e-3 relative L2 (op_test's tolerances);
  * three sync PS steps (tools/bench_deepfm_ps.py's path: transpiler,
    PSPlan, one pskv server, Adam on the server): the losses equal the
    JAX package's PS run's (rtol 1e-5), and the pulled fm_v rows of the
    last batch too;
  * log_loss, the layer (epsilon 1e-4) and the bare op (its default
    1e-7): the loss within 1e-5 and the gradient within 5e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models.deepfm import deepfm as jdeepfm
from paddle_tpu.transpiler import (DistributeTranspiler as JDistTranspiler,
                                   start_pserver as j_start_pserver)
from paddle_tpu_torch.models.deepfm import deepfm as tdeepfm
from paddle_tpu_torch.transpiler import (DistributeTranspiler,
                                         start_pserver)
from test_dist_ps import _free_port
from test_torch_gpt_inference import _program_dict
from test_torch_loss_metrics import _rel_l2, _run_both
from torch_port_common import one_torch_thread  # noqa: F401


FIELDS, VOCAB, EMB, LAYERS = 4, 200, 4, (16, 16)
OUT_TOL, GRAD_L2 = 1e-5, 5e-3
PKG = {pt: jdeepfm, ptt: tdeepfm}


def _program(pkg, dense_dim=0, lr=1e-3):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        spec = PKG[pkg](num_fields=FIELDS, sparse_feature_dim=VOCAB,
                        embedding_size=EMB, dense_dim=dense_dim,
                        layer_sizes=LAYERS)
        pkg.optimizer.Adam(learning_rate=lr).minimize(spec["loss"])
    main.random_seed = startup.random_seed = 11
    return main, startup, spec


def _feed(rng, batch=16, dense_dim=0):
    ids = rng.randint(0, VOCAB, (batch, FIELDS)).astype(np.int64)
    f = {"feat_ids": ids,
         "label": (ids.sum(axis=1) % 2).astype(np.float32)[:, None]}
    if dense_dim:
        f["dense_feats"] = rng.rand(batch, dense_dim).astype(np.float32)
    return f


def _jax_startup(startup, main):
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor().run(startup)
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.global_block.vars.values()
            if v.persistable and scope.find_var(v.name) is not None}


@pytest.mark.parametrize("dense_dim", [0, 13])
def test_deepfm_program_is_jax_op_for_op(dense_dim):
    jm, js, jspec = _program(pt, dense_dim)
    tm, ts, tspec = _program(ptt, dense_dim)
    assert _program_dict(tm) == _program_dict(jm)
    assert _program_dict(ts) == _program_dict(js)
    assert tspec["feed"] == jspec["feed"]


def test_deepfm_local_sparse_adam_step_equals_jax():
    jm, js, jspec = _program(pt, dense_dim=3)
    tm, ts, tspec = _program(ptt, dense_dim=3)
    feed = _feed(np.random.RandomState(0), dense_dim=3)
    params = [p.name for p in jm.all_parameters()]
    fetch = [jspec["loss"].name] + [p + "@GRAD" for p in params]
    init = _jax_startup(js, jm)
    with pt.scope_guard(pt.Scope()):
        for n, a in init.items():
            pt.global_scope().set_var(n, jnp.asarray(a))
        jres = [np.asarray(r) for r in pt.Executor().run(
            jm, feed=feed, fetch_list=fetch)]
    scope = ptt.Scope()
    ptt.io.set_params_from_numpy(scope, init, "cpu")
    tres = ptt.Executor(ptt.CPUPlace()).run(tm, feed=feed, fetch_list=fetch,
                                            scope=scope)
    np.testing.assert_allclose(tres[0], jres[0], rtol=OUT_TOL)
    for name, a, b in zip(fetch[1:], tres[1:], jres[1:]):
        assert a.shape == b.shape, name
        assert _rel_l2(a, b) <= GRAD_L2, (name, _rel_l2(a, b))
    assert {"fm_w1@GRAD", "fm_v@GRAD"} <= set(fetch)


def test_deepfm_ps_steps_equal_jax_ps_run():
    rng = np.random.RandomState(1)
    feeds = [_feed(rng) for _ in range(3)]
    jm, js, _ = _program(pt)
    init = _jax_startup(js, jm)
    out = {}
    for pkg, transpiler, starter in ((pt, JDistTranspiler, j_start_pserver),
                                     (ptt, DistributeTranspiler,
                                      start_pserver)):
        main, startup, spec = _program(pkg)
        ep = f"127.0.0.1:{_free_port()}"
        t = transpiler()
        t.transpile(0, program=main, pservers=ep, trainers=1,
                    sync_mode=True, startup_program=startup)
        assert {s.name for s in main._ps_plan.specs if s.sparse} == \
            {"fm_w1", "fm_v"}
        srv = starter(t.get_pserver_program(ep))
        plan = main._ps_plan
        try:
            if pkg is pt:
                scope = pt.Scope()
                exe = pt.Executor()
                with pt.scope_guard(scope):
                    exe.run(startup)
                for n, a in init.items():
                    scope.set_var(n, jnp.asarray(a))

                def step(f):
                    with pt.scope_guard(scope):
                        return exe.run(main, feed=f,
                                       fetch_list=[spec["loss"]])[0]
            else:
                scope, exe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
                exe.run(startup, scope=scope)
                ptt.io.set_params_from_numpy(scope, init, "cpu")

                def step(f):
                    return exe.run(main, feed=f, fetch_list=[spec["loss"]],
                                   scope=scope)[0]
            losses = [float(np.ravel(step(f))[0]) for f in feeds]
            vspec = next(s for s in plan.specs if s.name == "fm_v")
            ids = np.unique(feeds[-1]["feat_ids"])
            rows = plan.pull_sparse_sharded(vspec, ids)
            out[pkg] = (losses, rows)
        finally:
            plan.shutdown()
            srv.stop()
    np.testing.assert_allclose(out[ptt][0], out[pt][0], rtol=OUT_TOL)
    np.testing.assert_allclose(out[ptt][1], out[pt][1], rtol=OUT_TOL,
                               atol=1e-7)


@pytest.mark.parametrize("form", ["layer", "op_default_epsilon"])
def test_log_loss_and_grad_equal_jax(form):
    rng = np.random.RandomState(2)
    feed = {"x": rng.randn(8, 5).astype(np.float32),
            "y": (rng.rand(8, 1) > 0.5).astype(np.float32)}

    def build(pkg):
        x = pkg.layers.data("x", [5], dtype="float32")
        y = pkg.layers.data("y", [1], dtype="float32")
        p = pkg.layers.sigmoid(pkg.layers.fc(x, 1))
        if form == "layer":
            out = pkg.layers.log_loss(p, y)
        else:
            blk = pkg.default_main_program().global_block
            out = blk.create_var(name="ll", shape=[-1, 1], dtype="float32")
            blk.append_op("log_loss", {"Predicted": [p.name],
                                       "Labels": [y.name]},
                          {"Loss": [out.name]}, {})
        return pkg.layers.mean(out), [p]

    jres, tres = _run_both(build, feed)
    np.testing.assert_allclose(tres[0], jres[0], rtol=OUT_TOL)
    assert _rel_l2(tres[1], jres[1]) <= GRAD_L2


def test_bench_deepfm_ps_runs_on_the_cpu():
    """tools/bench_deepfm_ps.py at a tiny size, trainer on the CPU, its
    sparse tables sharded over two servers: one row, JAX's metric name."""
    from paddle_tpu_torch.tools import bench_deepfm_ps
    row = bench_deepfm_ps.run(batch=8, vocab=300, steps=2, servers=2,
                              device="cpu")
    assert row["metric"] == "deepfm_sparse_ps_samples_per_s_2srv"
    assert row["value"] > 0 and "trainer on CPU" in row["unit"]
