"""SelectedRows sparse embedding gradients in the PyTorch port, on the CPU:
the cases of tests/test_selected_rows.py (all but the allreduce one,
which is the parallelism slice, ROADMAP A.8), each also held against the
JAX package, then word2vec with is_sparse=True against JAX's.

  * embedding(is_sparse=True) trains like the dense path, with duplicate
    ids in every batch, under sgd, adagrad and rmsprop (exactly the dense
    update), momentum and adam (lazy: equal when every row is touched),
    and under a global-norm clip; and each sparse run equals the JAX
    package's sparse run from the same startup values (losses within 1e-5
    relative, the table within 1e-5);
  * a fetched sparse grad densifies at the boundary;
  * merge_rows / row_mask / to_dense, the sparse clip on merged rows, and
    sum / scale / clip_by_norm / squared_l2_norm / elementwise_mul on
    SelectedRows equal JAX's rules;
  * sparse AdamW decays only the touched rows;
  * every sparse update op's donated update is bitwise the out-of-place
    one;
  * word2vec (models/book.py) with is_sparse=True: the same program as
    JAX's and 3 SGD / Momentum / Adam steps equal to JAX's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import selected_rows as jsr
from paddle_tpu.models import book as jbook
from paddle_tpu_torch.framework import selected_rows as tsr
from paddle_tpu_torch.models import book as tbook
from test_torch_gpt_inference import _program_dict
from torch_port_common import one_torch_thread  # noqa: F401


VOCAB, DIM, BATCH = 13, 4, 6
TOL = 1e-5


def _build(pkg, optimizer_factory, is_sparse, seed=3):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        ids = pkg.layers.data("ids", [1], dtype="int64")
        emb = pkg.layers.embedding(ids, size=[VOCAB, DIM],
                                   is_sparse=is_sparse)
        fc = pkg.layers.fc(emb, size=3)
        label = pkg.layers.data("label", [1], dtype="int64")
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(fc, label))
        optimizer_factory(pkg.optimizer, pkg).minimize(loss)
    main.random_seed = startup.random_seed = seed
    return main, startup, loss


def _batches(steps, all_rows):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        if all_rows:
            # lazy optimizers (adam/momentum) equal dense only when every
            # row is touched; duplicates still exercise the merge
            ids = np.concatenate(
                [rng.permutation(VOCAB),
                 rng.randint(0, VOCAB, 3)]).astype(np.int64)[:, None]
        else:
            ids = rng.randint(0, VOCAB, (BATCH, 1)).astype(np.int64)
            ids[1] = ids[0]
            ids[3] = ids[0]
        label = rng.randint(0, 3, (ids.shape[0], 1)).astype(np.int64)
        out.append({"ids": ids, "label": label})
    return out


def _train(pkg, factory, is_sparse, init=None, steps=4, all_rows=False):
    """Losses and the final table; from `init` (name -> array) when given,
    else from the program's own startup."""
    main, startup, loss = _build(pkg, factory, is_sparse)
    exe = pt.Executor() if pkg is pt else ptt.Executor(ptt.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    if init is not None:
        for n, v in init.items():
            if pkg is pt:
                scope.set_var(n, v)
            else:
                ptt.io.set_params_from_numpy(scope, {n: v}, "cpu")
    losses = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0])[0])
              for f in _batches(steps, all_rows)]
    w = scope.find_var("embedding_0.w_0")
    return losses, (np.asarray(w) if pkg is pt else w.numpy().copy())


def _jax_init(factory, is_sparse):
    main, startup, _ = _build(pt, factory, is_sparse)
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.list_vars() if v.persistable
            and scope.find_var(v.name) is not None}


# (factory, all_rows): lazy kernels (adam, momentum) equal dense only when
# every row is touched each step; sgd and adagrad equal it always, rmsprop
# densifies.
OPTIMIZERS = {
    "sgd": (lambda o, pkg: o.SGD(learning_rate=0.1), False),
    "momentum": (lambda o, pkg: o.Momentum(learning_rate=0.1, momentum=0.9),
                 True),
    "adam": (lambda o, pkg: o.Adam(learning_rate=0.05), True),
    "adagrad": (lambda o, pkg: o.Adagrad(learning_rate=0.1), False),
    "rmsprop": (lambda o, pkg: o.RMSProp(learning_rate=0.05), False),
    "sgd_global_norm_clip": (lambda o, pkg: o.SGD(
        learning_rate=0.1, grad_clip=pkg.clip.GradientClipByGlobalNorm(
            0.1)), False),
    "adamw": (lambda o, pkg: o.AdamW(learning_rate=0.05, coeff=0.1), True),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_sparse_matches_dense_and_jax(name):
    factory, all_rows = OPTIMIZERS[name]
    dense_losses, dense_w = _train(ptt, factory, False, all_rows=all_rows)
    sparse_losses, sparse_w = _train(ptt, factory, True, all_rows=all_rows)
    np.testing.assert_allclose(sparse_losses, dense_losses, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(sparse_w, dense_w, rtol=1e-4, atol=1e-5)
    init = _jax_init(factory, True)
    jl, jw = _train(pt, factory, True, init, all_rows=all_rows)
    tl, tw = _train(ptt, factory, True, init, all_rows=all_rows)
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    np.testing.assert_allclose(tw, jw, atol=TOL, rtol=TOL)


def test_fetch_sparse_grad_densifies():
    res = []
    for pkg in (pt, ptt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name_guard(), pkg.program_guard(main, startup):
            ids = pkg.layers.data("ids", [1], dtype="int64")
            emb = pkg.layers.embedding(ids, size=[VOCAB, DIM],
                                       is_sparse=True)
            loss = pkg.layers.mean(emb)
            pkg.optimizer.SGD(learning_rate=0.0).minimize(loss)
        gname = [v.name for v in main.global_block.vars.values()
                 if v.type == "selected_rows"]
        assert len(gname) == 1, "sparse grad var not marked selected_rows"
        exe = pt.Executor() if pkg is pt else ptt.Executor(ptt.CPUPlace())
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        g, = exe.run(main, feed={"ids": np.array([[1], [1], [2]])},
                     fetch_list=gname, scope=scope)
        res.append(np.asarray(g))
    jg, tg = res
    assert tg.shape == (VOCAB, DIM)
    np.testing.assert_allclose(tg[1], 2.0 / (3 * DIM), rtol=1e-5)
    np.testing.assert_allclose(tg[2], 1.0 / (3 * DIM), rtol=1e-5)
    np.testing.assert_allclose(tg[0], 0.0)
    np.testing.assert_allclose(tg, jg, rtol=TOL, atol=TOL)


def _pair(rows, vals, height):
    import jax.numpy as jnp
    return (jsr.SelectedRows(jnp.asarray(rows), jnp.asarray(vals), height),
            tsr.SelectedRows(torch.as_tensor(rows), torch.as_tensor(vals),
                             height))


def test_merge_rows_and_mask():
    j, t = _pair(np.array([2, 5, 2, 7, 2]),
                 np.array([[1.0], [2.0], [3.0], [4.0], [0.5]], np.float32),
                 10)
    merged = tsr.merge_rows(t)
    np.testing.assert_array_equal(merged.values.numpy(),
                                  [[4.5], [2.0], [4.5], [4.0], [4.5]])
    np.testing.assert_array_equal(merged.values.numpy(),
                                  np.asarray(jsr.merge_rows(j).values))
    mask = tsr.row_mask(t).numpy()
    assert mask.sum() == 3   # three unique rows
    np.testing.assert_array_equal(mask, np.asarray(jsr.row_mask(j)))
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()))
    assert t.shape == j.shape == (10, 1)
    assert t.astype(torch.float64).dtype == torch.float64


def _lower(pkg, op_type, ins, attrs):
    from paddle_tpu.framework.registry import LowerContext as JCtx
    from paddle_tpu_torch.framework.registry import LowerContext as TCtx
    reg = pt.framework.registry if pkg is pt else \
        ptt.framework.registry
    ctx = JCtx() if pkg is pt else TCtx()
    return reg.get_op_def(op_type).lower(ctx, ins, attrs)["Out"][0]


def _dense(x):
    return np.asarray(x.to_dense() if hasattr(x, "to_dense") else x)


_ROWS = np.array([3, 1, 3, 0, 3])
_VALS = np.random.RandomState(4).randn(5, 2).astype(np.float32)
_SPARSE_OPS = [
    ("clip_merged", "clip", {"min": 0.1, "max": 1.0}),
    ("clip_by_norm", "clip_by_norm", {"max_norm": 0.5}),
    ("squared_l2_norm", "squared_l2_norm", {}),
    ("scale", "scale", {"scale": -0.5}),
    ("scale_bias_densifies", "scale", {"scale": 2.0, "bias": 1.0}),
]


@pytest.mark.parametrize("case", _SPARSE_OPS, ids=[c[0] for c in
                                                   _SPARSE_OPS])
def test_sparse_op_matches_jax(case):
    _, op_type, attrs = case
    j, t = _pair(_ROWS, _VALS, 6)
    jo = _lower(pt, op_type, {"X": [j]}, attrs)
    to = _lower(ptt, op_type, {"X": [t]}, attrs)
    assert isinstance(to, tsr.SelectedRows) == isinstance(
        jo, jsr.SelectedRows)
    np.testing.assert_allclose(_dense(to), _dense(jo), rtol=TOL, atol=1e-7)


def test_sparse_sum_mul_and_clip_duplicates():
    """An all-sparse sum concatenates (a mix densifies); a scalar multiply
    stays sparse; the clip acts on the merged row, once (clip(0) = min
    would add mass)."""
    j1, t1 = _pair(_ROWS, _VALS, 6)
    j2, t2 = _pair(np.array([5, 3]), _VALS[:2], 6)
    to = _lower(ptt, "sum", {"X": [t1, t2]}, {})
    jo = _lower(pt, "sum", {"X": [j1, j2]}, {})
    assert isinstance(to, tsr.SelectedRows) and to.rows.shape == (7,)
    np.testing.assert_allclose(_dense(to), _dense(jo), rtol=TOL)
    dense = np.ones((6, 2), np.float32)
    mixed = _lower(ptt, "sum", {"X": [t1, torch.as_tensor(dense)]}, {})
    np.testing.assert_allclose(mixed.numpy(), _dense(jo) * 0 + dense
                               + _dense(_lower(pt, "sum", {"X": [j1]}, {})),
                               rtol=TOL)
    y = np.array([0.25], np.float32)
    to = _lower(ptt, "elementwise_mul",
                {"X": [t1], "Y": [torch.as_tensor(y)]}, {"axis": -1})
    import jax.numpy as jnp
    jo = _lower(pt, "elementwise_mul", {"X": [j1], "Y": [jnp.asarray(y)]},
                {"axis": -1})
    assert isinstance(to, tsr.SelectedRows)
    np.testing.assert_allclose(_dense(to), _dense(jo), rtol=TOL)
    j, t = _pair(np.array([3, 3]), np.array([[0.5], [0.5]], np.float32), 10)
    out = _dense(_lower(ptt, "clip", {"X": [t]}, {"min": 0.1, "max": 1.0}))
    np.testing.assert_allclose(out[3], [1.0])
    assert np.count_nonzero(out) == 1


def test_adamw_sparse_decays_only_touched_rows():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name_guard(), ptt.program_guard(main, startup):
        ids = ptt.layers.data("ids", [1], dtype="int64")
        emb = ptt.layers.embedding(ids, size=[9, 2], is_sparse=True)
        loss = ptt.layers.mean(emb)
        ptt.optimizer.AdamW(learning_rate=0.1, coeff=0.5).minimize(loss)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    wname = "embedding_0.w_0"
    w0 = scope.get_numpy(wname)
    exe.run(main, feed={"ids": np.array([[2], [2], [5]])}, fetch_list=[],
            scope=scope)
    delta = np.abs(scope.get_numpy(wname) - w0)
    assert delta[2].max() > 0 and delta[5].max() > 0
    untouched = [r for r in range(9) if r not in (2, 5)]
    np.testing.assert_allclose(delta[untouched], 0.0, atol=1e-8)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adagrad",
                                  "adamw"])
def test_sparse_donated_update_is_bitwise_out_of_place(name):
    factory, _ = OPTIMIZERS[name]
    main, startup, loss = _build(ptt, factory, True)
    states = []
    for donate in (True, False):
        exe = ptt.Executor(ptt.CPUPlace(), donate=donate)
        scope = ptt.Scope()
        exe.run(startup, scope=scope)
        for f in _batches(4, False):
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        states.append({n: scope.find_var(n).clone()
                       for n in scope.var_names()
                       if isinstance(scope.find_var(n), torch.Tensor)})
    for n in states[0]:
        assert torch.equal(states[0][n], states[1][n]), n


# ---------------------------------------------------------------------------
# word2vec, is_sparse=True
# ---------------------------------------------------------------------------

W2V_VOCAB = 40


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_word2vec_sparse_steps_match_jax(opt):
    make = {"sgd": lambda o: o.SGD(0.1),
            "momentum": lambda o: o.Momentum(0.1, 0.9),
            "adam": lambda o: o.Adam(0.01)}[opt]
    progs = []
    for pkg, mod in ((pt, jbook), (ptt, tbook)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name_guard(), pkg.program_guard(main, startup):
            spec = mod.word2vec(W2V_VOCAB, emb_dim=8, hidden=16,
                                is_sparse=True)
            make(pkg.optimizer).minimize(spec["loss"])
        progs.append((main, startup, spec))
    (jmain, jstart, jspec), (tmain, tstart, tspec) = progs
    assert _program_dict(tmain) == _program_dict(jmain)
    assert _program_dict(tstart) == _program_dict(jstart)
    assert any(v.type == "selected_rows"
               for v in tmain.global_block.vars.values())
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    persist = [v.name for v in jmain.list_vars() if v.persistable
               and jscope.find_var(v.name) is not None]
    tscope = ptt.Scope()
    ptt.io.set_params_from_numpy(
        tscope, {n: np.asarray(jscope.find_var(n)) for n in persist}, "cpu")
    rng = np.random.RandomState(9)
    res = []
    feeds = []
    for _ in range(3):
        f = {n: rng.randint(0, W2V_VOCAB, (8, 1)).astype(np.int64)
             for n in jspec["feed"]}
        f["context_1"] = f["context_0"]     # duplicate rows on purpose
        feeds.append(f)
    for exe, main, spec, scope in (
            (pt.Executor(), jmain, jspec, jscope),
            (ptt.Executor(ptt.CPUPlace()), tmain, tspec, tscope)):
        losses = [float(np.ravel(exe.run(main, feed=f,
                                         fetch_list=[spec["loss"]],
                                         scope=scope)[0])[0])
                  for f in feeds]
        res.append((losses, {n: np.asarray(scope.find_var(n))
                             if scope is jscope else scope.get_numpy(n)
                             for n in persist}))
    (jl, js), (tl, ts) = res
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    for n, want in js.items():
        np.testing.assert_allclose(ts[n], want, atol=TOL, rtol=TOL,
                                   err_msg=n)
