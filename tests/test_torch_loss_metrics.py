"""The loss ops (CTC, linear-chain CRF and its decoding, NCE, hierarchical
sigmoid), the streaming metric ops (auc, precision_recall,
ctr_metric_bundle) with their layers, and `metrics.py` / `average.py` of
the PyTorch port against the JAX package's, on the CPU.

  * each loss: both DSLs build the same program, op for op; from the JAX
    startup values and the same seeded feeds, the loss within 1e-5 and
    every gradient (inputs and parameters) within 5e-3 relative L2
    (op_test's tolerances); CTC over rows with and without labels, a
    blank other than 0, `norm_by_times`; crf_decoding's paths exactly;
  * nce with its negatives fed (the JAX and torch samplers differ): the
    cost and the explicit grad lowering against JAX's at fixed negatives;
    in a program, the grad op reads the negatives the forward drew (the
    port's gradient equals JAX's cost vjp at those negatives);
  * the metric ops: three batches through both packages, the persistable
    states and the metrics within 1e-6 relative; auc both as running
    totals and as a sliding ring; the donated auc update is bitwise the
    out-of-place one;
  * `metrics.py`'s accumulators and `average.WeightedAverage` equal JAX's
    on the same updates;
  * the port imports neither jax nor paddle_tpu with this slice's modules
    loaded (a subprocess).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.ops import loss_ops as jloss
from paddle_tpu_torch.ops import loss_ops as tloss
from test_torch_gpt_inference import _program_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_TOL = 1e-5
GRAD_L2 = 5e-3


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _run_both(build, feed, extra_fetch=()):
    """Build with both DSLs (same names), check the programs match, run
    the port from the JAX startup values on the same feed. `build(pkg)`
    returns (loss, [vars whose gradients to fetch]). Returns the JAX and
    port fetches: loss, the gradients, then `extra_fetch` by name."""
    outs = []
    for pkg in (pt, ptt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name_guard(), pkg.program_guard(main, startup):
            loss, wrt = build(pkg)
            pkg.append_backward(loss)
        main.random_seed = startup.random_seed = 3
        outs.append((main, startup, loss, [v.name + "@GRAD" for v in wrt]))
    (jm, js, jl, jg), (tm, ts, tl, tg) = outs
    assert _program_dict(jm) == _program_dict(tm)
    assert _program_dict(js) == _program_dict(ts)
    fetch = [jl.name] + jg + list(extra_fetch)
    jexe = pt.Executor()
    with pt.scope_guard(pt.Scope()):
        jexe.run(js)
        params = {v.name: np.asarray(pt.global_scope().find_var(v.name))
                  for v in jm.global_block.vars.values() if v.persistable
                  and pt.global_scope().find_var(v.name) is not None}
        jres = [np.asarray(r) for r in jexe.run(jm, feed=feed,
                                                fetch_list=fetch)]
    scope = ptt.Scope()
    ptt.io.set_params_from_numpy(scope, params, "cpu")
    texe = ptt.Executor(ptt.CPUPlace())
    tres = texe.run(tm, feed=feed, fetch_list=fetch, scope=scope)
    return jres, tres


def _check(jres, tres):
    np.testing.assert_allclose(tres[0], jres[0], rtol=OUT_TOL, atol=OUT_TOL)
    for j, t in zip(jres[1:], tres[1:]):
        assert np.isfinite(t).all()
        assert _rel_l2(t, j) <= GRAD_L2, _rel_l2(t, j)


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------

def _ctc_feed(seed, b=4, t=12, c=6, lmax=4):
    rng = np.random.RandomState(seed)
    return {"logits": rng.randn(b, t, c).astype(np.float32),
            "label": rng.randint(1, c, (b, lmax)).astype(np.int64),
            "logit_len": np.array([[t], [t - 3], [5], [t - 1]][:b],
                                  np.int64),
            "label_len": np.array([[lmax], [2], [0], [3]][:b], np.int64)}


@pytest.mark.parametrize("blank,norm", [(0, False), (2, True)])
def test_ctc_loss_and_grad_match_jax(blank, norm):
    feed = _ctc_feed(11)
    if blank:
        feed["label"] = np.where(feed["label"] == blank, 1, feed["label"])

    def build(pkg):
        x = pkg.layers.data("logits", [12, 6], stop_gradient=False)
        lab = pkg.layers.data("label", [4], dtype="int64")
        ll = pkg.layers.data("logit_len", [1], dtype="int64")
        bl = pkg.layers.data("label_len", [1], dtype="int64")
        h = pkg.layers.fc(x, 6, num_flatten_dims=2)
        ctc = pkg.layers.warpctc(h, lab, ll, bl, blank=blank,
                                 norm_by_times=norm)
        return pkg.layers.mean(ctc), [x]

    # each row's loss too: full, shorter and label-less rows
    jres, tres = _run_both(build, feed, extra_fetch=["fc_0.w_0@GRAD",
                                                     "warpctc_0.tmp_0"])
    _check(jres[:-1], tres[:-1])
    np.testing.assert_allclose(tres[-1], jres[-1], rtol=OUT_TOL,
                               atol=OUT_TOL)
    assert tres[-1].shape == (4, 1) and np.isfinite(tres[-1]).all()


# ---------------------------------------------------------------------------
# linear-chain CRF and Viterbi decoding
# ---------------------------------------------------------------------------

def _crf_feed(seed, b=5, t=7, c=4):
    rng = np.random.RandomState(seed)
    return {"emission": rng.randn(b, t, c).astype(np.float32),
            "label": rng.randint(0, c, (b, t)).astype(np.int64),
            "length": rng.randint(1, t + 1, (b, 1)).astype(np.int64)}


def test_crf_log_likelihood_and_grads_match_jax():
    feed = _crf_feed(2)

    def build(pkg):
        em = pkg.layers.data("emission", [7, 4], stop_gradient=False)
        lab = pkg.layers.data("label", [7], dtype="int64")
        ln = pkg.layers.data("length", [1], dtype="int64")
        nll, trans = pkg.layers.linear_chain_crf(em, lab, ln)
        return pkg.layers.mean(nll), [em, trans]

    jres, tres = _run_both(build, feed)
    _check(jres, tres)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crf_decoding_paths_equal_jax(seed):
    """Viterbi paths exactly (zeros past each length), with a transition
    of small integers so that ties occur and must go JAX's way."""
    feed = _crf_feed(seed, b=6, t=9, c=5)
    if seed == 2:
        feed["emission"] = np.round(feed["emission"]).astype(np.float32)
    rng = np.random.RandomState(seed + 10)
    trans = rng.randn(7, 5).astype(np.float32)
    if seed == 2:
        trans = np.round(trans).astype(np.float32)
    paths = []
    for pkg, exe in ((pt, pt.Executor()),
                     (ptt, ptt.Executor(ptt.CPUPlace()))):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name_guard(), pkg.program_guard(main, startup):
            em = pkg.layers.data("emission", [9, 5])
            ln = pkg.layers.data("length", [1], dtype="int64")
            tr = pkg.layers.create_parameter([7, 5], "float32",
                                             name="crf_t")
            path = pkg.layers.crf_decoding(em, tr, ln)
        f = {"emission": feed["emission"], "length": feed["length"]}
        if pkg is pt:
            with pt.scope_guard(pt.Scope()):
                pt.global_scope().set_var("crf_t", trans)
                paths.append(np.asarray(exe.run(main, feed=f,
                                                fetch_list=[path])[0]))
        else:
            sc = ptt.Scope()
            ptt.io.set_params_from_numpy(sc, {"crf_t": trans}, "cpu")
            paths.append(exe.run(main, feed=f, fetch_list=[path],
                                 scope=sc)[0])
    np.testing.assert_array_equal(paths[1], paths[0])
    lens = feed["length"][:, 0]
    assert (paths[1][np.arange(9)[None, :] >= lens[:, None]] == 0).all()


# ---------------------------------------------------------------------------
# NCE and the hierarchical sigmoid
# ---------------------------------------------------------------------------

def _nce_inputs(seed, b=6, d=5, c=11, k=4, bias=True):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, d).astype(np.float32),
            (rng.randn(c, d) * 0.5).astype(np.float32),
            rng.randn(c).astype(np.float32) if bias else None,
            rng.randint(0, c, (b, 1)).astype(np.int64),
            rng.randint(0, c, (b, k)).astype(np.int32),
            rng.rand(b, 1).astype(np.float32))


@pytest.mark.parametrize("bias", [True, False])
def test_nce_cost_and_grad_lowering_with_fed_negatives(bias):
    import jax.numpy as jnp
    import torch
    x, w, b, label, neg, og = _nce_inputs(4, bias=bias)
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else torch.from_numpy(b)
    jc = np.asarray(jloss._nce_forward(jnp.asarray(x), jnp.asarray(w), jb,
                                       jnp.asarray(label[:, 0]),
                                       jnp.asarray(neg)))
    tc = tloss._nce_forward(torch.from_numpy(x), torch.from_numpy(w), tb,
                            torch.from_numpy(label[:, 0]),
                            torch.from_numpy(neg)).numpy()
    np.testing.assert_allclose(tc, jc, rtol=OUT_TOL, atol=OUT_TOL)
    jins = {"Input": [jnp.asarray(x)], "Weight": [jnp.asarray(w)],
            "Label": [jnp.asarray(label)], "Negatives": [jnp.asarray(neg)],
            "Cost@GRAD": [jnp.asarray(og)]}
    if b is not None:
        jins["Bias"] = [jb]
    tins = {k: [torch.from_numpy(np.asarray(v[0]))] for k, v in jins.items()}
    jg = jloss._nce_grad_lower(None, jins, {})
    tg = tloss._nce_grad_lower(None, tins, {})
    assert sorted(jg) == sorted(tg)
    for slot in jg:
        assert _rel_l2(tg[slot][0].numpy(), np.asarray(jg[slot][0])) \
            <= GRAD_L2, slot


def test_nce_program_grad_reads_the_drawn_negatives():
    """The port's nce in a program: negatives drawn from the run's
    generator in [0, C), the same draws on a rerun of a fresh scope, and
    the cost and gradients equal JAX's at the negatives drawn."""
    import jax.numpy as jnp
    x, w, b, label, _, _ = _nce_inputs(7)
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name_guard(), ptt.program_guard(main, startup):
        xv = ptt.layers.data("x", [5], stop_gradient=False)
        lab = ptt.layers.data("label", [1], dtype="int64")
        cost = ptt.layers.nce(xv, lab, 11, num_neg_samples=4)
        loss = ptt.layers.reduce_sum(cost)
        ptt.append_backward(loss)
    nce_op = next(op for op in main.global_block.ops if op.type == "nce")
    neg_name = nce_op.output("Negatives")[0]
    wn, bn = nce_op.input("Weight")[0], nce_op.input("Bias")[0]
    runs = []
    for _ in range(2):
        sc = ptt.Scope()
        ptt.io.set_params_from_numpy(sc, {wn: w, bn: b}, "cpu")
        runs.append(ptt.Executor(ptt.CPUPlace()).run(
            main, feed={"x": x, "label": label},
            fetch_list=[cost, neg_name, "x@GRAD", wn + "@GRAD",
                        bn + "@GRAD"], scope=sc))
    for a, c in zip(*runs):
        np.testing.assert_array_equal(a, c)
    tcost, neg, gx, gw, gb = runs[0]
    assert neg.dtype == np.int32 and neg.shape == (6, 4)
    assert neg.min() >= 0 and neg.max() < 11
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    jcost = np.asarray(jloss._nce_forward(jx, jw, jb,
                                          jnp.asarray(label[:, 0]),
                                          jnp.asarray(neg)))
    np.testing.assert_allclose(tcost, jcost, rtol=OUT_TOL, atol=OUT_TOL)
    jg = jloss._nce_grad_lower(None, {
        "Input": [jx], "Weight": [jw], "Bias": [jb],
        "Label": [jnp.asarray(label)], "Negatives": [jnp.asarray(neg)],
        "Cost@GRAD": [jnp.ones((6, 1), jnp.float32)]}, {})
    for t, slot in zip((gx, gw, gb), ("Input@GRAD", "Weight@GRAD",
                                       "Bias@GRAD")):
        assert _rel_l2(t, np.asarray(jg[slot][0])) <= GRAD_L2


@pytest.mark.parametrize("num_classes,bias", [(6, True), (9, False),
                                              (2, True)])
def test_hierarchical_sigmoid_and_grads_match_jax(num_classes, bias):
    rng = np.random.RandomState(num_classes)
    feed = {"x": rng.randn(7, 5).astype(np.float32),
            "label": rng.randint(0, num_classes, (7, 1)).astype(np.int64)}

    def build(pkg):
        x = pkg.layers.data("x", [5], stop_gradient=False)
        lab = pkg.layers.data("label", [1], dtype="int64")
        cost = pkg.layers.hsigmoid(x, lab, num_classes,
                                   bias_attr=None if bias else False)
        return pkg.layers.mean(cost), [x]

    params = ["hsigmoid_0.w_0@GRAD"] + (["hsigmoid_0.b_0@GRAD"]
                                        if bias else [])
    jres, tres = _run_both(build, feed, extra_fetch=params)
    _check(jres, tres)


# ---------------------------------------------------------------------------
# metric ops
# ---------------------------------------------------------------------------

def _metric_batches(seed, n=3, b=64):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        p = rng.rand(b, 1).astype(np.float32)
        out.append({"p": np.concatenate([1 - p, p], 1),
                    "y": (rng.rand(b, 1) < p).astype(np.int64),
                    "cls": rng.randint(0, 5, (b, 1)).astype(np.int64),
                    "lbl": rng.randint(0, 5, (b, 1)).astype(np.int64),
                    "w": rng.rand(b, 1).astype(np.float32),
                    "prob": p, "click": (rng.rand(b, 1) < 0.3)
                    .astype(np.float32)})
    return out


def _metric_program(pkg, slide_steps, weighted):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        p = pkg.layers.data("p", [2])
        y = pkg.layers.data("y", [1], dtype="int64")
        cls = pkg.layers.data("cls", [1], dtype="int64")
        lbl = pkg.layers.data("lbl", [1], dtype="int64")
        w = pkg.layers.data("w", [1])
        prob = pkg.layers.data("prob", [1])
        click = pkg.layers.data("click", [1])
        auc, stats = pkg.layers.auc(p, y, num_thresholds=255,
                                    slide_steps=slide_steps)
        bm, am, states = pkg.layers.precision_recall(
            prob, cls, lbl, 5, weights=w if weighted else None)
        ctr = pkg.contrib.layers.ctr_metric_bundle(prob, click)
    fetch = [auc, bm, am, states] + list(stats) + list(ctr)
    return main, startup, fetch


@pytest.mark.parametrize("slide_steps,weighted", [(0, True), (2, False)])
def test_metric_ops_states_match_jax(slide_steps, weighted):
    batches = _metric_batches(slide_steps)
    got = []
    for pkg in (pt, ptt):
        main, startup, fetch = _metric_program(pkg, slide_steps, weighted)
        rows = []
        if pkg is pt:
            exe = pt.Executor()
            with pt.scope_guard(pt.Scope()):
                exe.run(startup)
                for f in batches:
                    rows.append([np.asarray(r) for r in
                                 exe.run(main, feed=f, fetch_list=fetch)])
        else:
            exe, sc = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
            exe.run(startup, scope=sc)
            for f in batches:
                rows.append(exe.run(main, feed=f, fetch_list=fetch,
                                    scope=sc))
        got.append(rows)
    for jr, tr in zip(*got):
        for j, t in zip(jr, tr):
            np.testing.assert_allclose(t.astype(np.float64),
                                       j.astype(np.float64), rtol=1e-6,
                                       atol=1e-6)
    auc = got[1][-1][0]
    assert 0.0 < float(auc) < 1.0


def test_auc_donated_update_is_bitwise_out_of_place():
    finals = {}
    batches = _metric_batches(9, n=4)
    for donate in (True, False):
        main, startup, fetch = _metric_program(ptt, 0, False)
        exe, sc = ptt.Executor(ptt.CPUPlace(), donate=donate), ptt.Scope()
        exe.run(startup, scope=sc)
        stat = fetch[4].name
        for f in batches:
            res = exe.run(main, feed=f, fetch_list=fetch, scope=sc)
        ptr = sc.find_var(stat).data_ptr()
        exe.run(main, feed=batches[0], fetch_list=fetch, scope=sc)
        if donate:
            assert sc.find_var(stat).data_ptr() == ptr  # written in place
        finals[donate] = (res, sc.get_numpy(stat))
    for a, b in zip(finals[True][0], finals[False][0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(finals[True][1], finals[False][1])


# ---------------------------------------------------------------------------
# metrics.py and average.py
# ---------------------------------------------------------------------------

def test_metric_classes_and_weighted_average_match_jax():
    rng = np.random.RandomState(0)
    preds = [rng.rand(16, 1).astype(np.float32) for _ in range(3)]
    labels = [(rng.rand(16, 1) > 0.5).astype(np.int64) for _ in range(3)]
    res = []
    for pkg in (pt, ptt):
        m = pkg.metrics
        acc, prec, rec = m.Accuracy(), m.Precision(), m.Recall()
        auc = m.Auc("auc", num_thresholds=63)
        comp = m.CompositeMetric()
        comp.add_metric(m.Precision())
        comp.add_metric(m.Recall())
        chunk, ed = m.ChunkEvaluator(), m.EditDistance("ed")
        wa = pkg.average.WeightedAverage()
        for i, (p, y) in enumerate(zip(preds, labels)):
            acc.update(float((p.round() == y).mean()), 16)
            prec.update(p, y)
            rec.update(p, y)
            auc.update(np.concatenate([1 - p, p], 1), y)
            comp.update(p, y)
            chunk.update(5 + i, 6, 4 + i)
            ed.update(np.array([[1.0], [0.0], [2.0]]), 3)
            wa.add(float(p.mean()), weight=i + 1)
        res.append([acc.eval(), prec.eval(), rec.eval(), auc.eval(),
                    comp.eval(), chunk.eval(), ed.eval(), wa.eval()])
    for j, t in zip(*res):
        np.testing.assert_allclose(np.asarray(t, np.float64),
                                   np.asarray(j, np.float64), rtol=1e-12)
    with pytest.raises(NotImplementedError, match="A.7"):
        ptt.metrics.DetectionMAP(None, None, None, class_num=3)


def test_loss_and_metric_slice_imports_neither_jax_nor_paddle_tpu():
    code = (
        "import sys, numpy as np, torch\n"
        "import paddle_tpu_torch as ptt\n"
        "from paddle_tpu_torch.framework import fluid_interop\n"
        "from paddle_tpu_torch.ops import (reader_ops, loss_ops,\n"
        "    metrics_ops, io_dist_ops)\n"
        "from paddle_tpu_torch.reader import py_reader, decorator\n"
        "from paddle_tpu_torch import (data_feeder, metrics, average,\n"
        "    io)\n"
        "out = loss_ops._warpctc(None, {\n"
        "    'Logits': [torch.randn(2, 5, 4)],\n"
        "    'Label': [torch.ones(2, 2, dtype=torch.long)],\n"
        "    'LogitsLength': [torch.tensor([5, 4])],\n"
        "    'LabelLength': [torch.tensor([2, 1])]}, {})['Loss'][0]\n"
        "assert out.shape == (2, 1)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'paddle_tpu'\n"
        "             or m.startswith('paddle_tpu.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
