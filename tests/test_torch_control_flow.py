"""Control flow of the PyTorch port against the JAX package, on the CPU.

The programs of tests/test_control_flow.py and
tests/test_control_flow_grad.py (While, while_loop, cond, Switch,
StaticRNN, DynamicRNN, IfElse, nested and stop-gradient loops) are built
by both DSLs and run through both executors on the same feeds, with the
JAX startup values carried by name: outputs within 1e-5, gradients within
5e-3 (tests/op_test.py's tolerances). Besides:

  * the grad makers raise as JAX's do: a While without a static trip
    bound on a loss path, and a bound-less While nested inside a
    differentiated construct;
  * write_to_array / read_from_array with a static index, and
    get_places;
  * dropout (p = 0.5) inside a StaticRNN step and inside a bounded While
    body: the grad replay draws the forward's masks (its step outputs are
    bitwise the forward's), and the run's generator ends where a run
    without the grad ops ends.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.tools.control_flow_cases import (
    PROGRAMS, doubling, dynamic_rnn, f32, nested_whiles,
    static_rnn_trains, while_sums_to_ten)
from torch_port_common import one_torch_thread  # noqa: F401


TOL = 1e-5          # op_test's output tolerance
GRAD_TOL = 5e-3     # op_test's gradient tolerance


def _build(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        fetch, n_out = build(pkg)
    return main, startup, [v.name for v in fetch], n_out


def run_both(build, feeds):
    """Build with both DSLs, run the JAX startup, carry its persistables to
    the port by name, then run every feed in turn through both executors
    (one scope each, so training steps chain). Returns [(jax fetches,
    port fetches)] per feed and the number of leading output fetches."""
    jm, js, jf, n_out = _build(pt, build)
    tm, _, tf, _ = _build(ptt, build)
    assert tf == jf
    jscope, tscope = pt.Scope(), ptt.Scope()
    jexe, texe = pt.Executor(), ptt.Executor(ptt.CPUPlace())
    jexe.run(js, scope=jscope)
    init = {v.name: np.asarray(jscope.find_var(v.name))
            for v in jm.list_vars()
            if v.persistable and jscope.find_var(v.name) is not None}
    ptt.io.set_params_from_numpy(tscope, init, "cpu")
    res = []
    for feed in feeds:
        j = jexe.run(jm, feed=feed, fetch_list=jf, scope=jscope)
        t = texe.run(tm, feed=feed, fetch_list=tf, scope=tscope)
        res.append(([np.asarray(v) for v in j], [np.asarray(v) for v in t]))
    return res, n_out


def check_both(build, feeds):
    res, n_out = run_both(build, feeds)
    for j, t in res:
        for k, (a, b) in enumerate(zip(j, t)):
            assert b.shape == a.shape, k
            tol = TOL if k < n_out else GRAD_TOL
            np.testing.assert_allclose(b, a, atol=tol, rtol=tol,
                                       err_msg=str(k))
    return res


_R = np.random.RandomState(11)


@pytest.mark.parametrize("build,feeds", [p[1:] for p in PROGRAMS],
                         ids=[p[0] for p in PROGRAMS])
def test_control_flow_program_matches_jax(build, feeds):
    check_both(build, feeds)


def test_expected_values():
    """The JAX tests' own expectations hold for the port's results."""
    (_, t), = run_both(while_sums_to_ten, [{}])[0]
    assert float(t[0][0]) == 45.0 and int(t[1][0]) == 10
    (_, t), = run_both(lambda pkg: doubling(pkg, 16, grad=True),
                       [{"x": f32(1.5)}])[0]
    assert float(t[0][0]) == 192.0 and abs(float(t[1][0]) - 128.0) < 1e-3
    (_, t), = run_both(nested_whiles, [{"x": f32(1.0)}])[0]
    assert abs(float(t[0][0]) - 54.0) < 1e-3
    assert abs(float(t[1][0]) - 54.0) < 1e-2
    (_, t), = run_both(dynamic_rnn, [{
        "x": _R.randn(3, 5, 4).astype(np.float32),
        "lens": np.array([5, 2, 3], np.int32)}])[0]
    o, g = t
    assert np.all(o[1, 2:] == 0) and np.all(o[2, 3:] == 0)
    assert np.any(o[0, 4] != 0)
    assert np.all(g[1, 2:] == 0) and np.any(g[1, :2] != 0)


def test_static_rnn_sgd_trajectory_falls():
    res, _ = run_both(static_rnn_trains, [
        {"x": np.random.RandomState(0).randn(4, 3, 5).astype(np.float32)}]
        * 4)
    losses = [float(t[0][0]) for _, t in res]
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# what raises, as in JAX
# ---------------------------------------------------------------------------

def test_while_without_bound_raises():
    for pkg in (pt, ptt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data("x", [1], append_batch_size=False)
            x.stop_gradient = False
            out, = pkg.layers.while_loop(
                lambda v: pkg.layers.less_than(
                    v, pkg.layers.fill_constant([1], "float32", 10.0)),
                lambda v: pkg.layers.scale(v, scale=2.0), [x])
            loss = pkg.layers.reduce_sum(out)
            with pytest.raises(RuntimeError,
                               match="without a static trip bound"):
                pkg.gradients([loss], [x])


def test_boundless_while_nested_in_differentiated_loop_raises():
    """The outer loop is bounded and differentiable; the inner one has no
    bound. Building passes; the grad replay raises in both packages."""
    def build(pkg):
        L = pkg.layers
        x = L.data("x", [1], append_batch_size=False)
        x.stop_gradient = False

        def outer_body(v):
            u_out, = L.while_loop(
                lambda u: L.less_than(u, L.fill_constant([1], "float32",
                                                         10.0)),
                lambda u: L.scale(u, scale=2.0), [v])
            return L.scale(u_out, scale=1.5)

        out, = L.while_loop(
            lambda v: L.less_than(v, L.fill_constant([1], "float32", 50.0)),
            outer_body, [x], max_trip_count=4)
        gx, = pkg.gradients([L.reduce_sum(out)], [x])
        return [out, gx], 1

    for pkg, exe in ((pt, pt.Executor()), (ptt, ptt.Executor(ptt.CPUPlace()))):
        main, _, fetch, _ = _build(pkg, build)
        with pytest.raises(Exception, match="nested inside a differentiated"):
            exe.run(main, feed={"x": f32(1.0)}, fetch_list=fetch,
                    scope=pkg.Scope())


# ---------------------------------------------------------------------------
# tensor arrays, get_places
# ---------------------------------------------------------------------------

def array_program(pkg):
    """x0, x1 written at folded indices 0 and 1, read back at 1; the array
    stacked by tensor_array_to_tensor and its length."""
    blk = pkg.default_main_program().global_block
    L = pkg.layers
    x = L.data("x", [2, 3], append_batch_size=False)
    i0 = L.fill_constant([1], "int64", 0)
    i1 = L.increment(L.fill_constant([1], "int64", 0), in_place=False)
    blk.create_var(name="arr", dtype="float32")
    for i, v in ((i0, x), (i1, L.scale(x, scale=2.0))):
        blk.append_op("write_to_array", {"X": [v.name], "I": [i.name]},
                      {"Out": ["arr"]}, {}, infer_shape=False)
    r = blk.create_var(name="read", shape=(2, 3), dtype="float32")
    blk.append_op("read_from_array", {"X": ["arr"], "I": [i1.name]},
                  {"Out": ["read"]}, {}, infer_shape=False)
    st = blk.create_var(name="stacked", dtype="float32")
    idx = blk.create_var(name="stack_idx", dtype="int32")
    blk.append_op("tensor_array_to_tensor", {"X": ["arr"]},
                  {"Out": ["stacked"], "OutIndex": ["stack_idx"]},
                  {"axis": 0, "use_stack": True}, infer_shape=False)
    n = blk.create_var(name="arr_len", dtype="int64")
    blk.append_op("lod_array_length", {"X": ["arr"]}, {"Out": ["arr_len"]},
                  {}, infer_shape=False)
    return [r, st, n], 3


def test_tensor_array_static_index_matches_jax():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    (j, t), = check_both(array_program, [{"x": x}])
    np.testing.assert_array_equal(t[0], 2 * x)
    np.testing.assert_array_equal(t[1], np.stack([x, 2 * x]))
    assert int(t[2][0]) == 2
    # the port fetches the array itself stacked, as numpy stacks JAX's tuple
    main, startup, _, _ = _build(ptt, array_program)
    arr, = ptt.Executor(ptt.CPUPlace()).run(main, feed={"x": x},
                                            fetch_list=["arr"])
    np.testing.assert_array_equal(arr, np.stack([x, 2 * x]))


def test_get_places_counts_the_cpu():
    main = ptt.Program()
    blk = main.global_block
    blk.create_var(name="places", dtype="int32")
    blk.append_op("get_places", {}, {"Out": ["places"]}, {},
                  infer_shape=False)
    p, = ptt.Executor(ptt.CPUPlace()).run(main, fetch_list=["places"])
    np.testing.assert_array_equal(p, [0])


# ---------------------------------------------------------------------------
# dropout inside a replayed body: the replay draws the forward's masks
# ---------------------------------------------------------------------------

def _dropout_rnn(pkg, with_grad=True):
    L = pkg.layers
    x = L.data("x", [4, 3, 8], append_batch_size=False)
    x.stop_gradient = False
    boot = L.fill_constant([3, 8], "float32", 0.0)
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        prev = rnn.memory(init=boot)
        h = L.elementwise_add(
            L.dropout(xt, 0.5, dropout_implementation="upscale_in_train"),
            L.scale(prev, scale=0.5))
        rnn.update_memory(prev, h)
        rnn.step_output(h)
    out = rnn()
    fetch = [out]
    if with_grad:
        fetch.append(pkg.gradients([L.reduce_sum(out)], [x])[0])
    return fetch


def _dropout_while(pkg, with_grad=True):
    L = pkg.layers
    x = L.data("x", [16], append_batch_size=False)
    x.stop_gradient = False
    i = L.fill_constant([1], "int32", 0)
    i.stop_gradient = True
    n = L.fill_constant([1], "int32", 3)
    state = L.assign(x)
    state.stop_gradient = False
    cv = L.less_than(i, n)
    w = L.While(cv, max_trip_count=5)
    with w.block():
        L.assign(L.dropout(L.scale(state, scale=1.1), 0.5,
                           dropout_implementation="upscale_in_train"),
                 output=state)
        L.assign(L.elementwise_add(i, L.fill_constant([1], "int32", 1)),
                 output=i)
        L.assign(L.less_than(i, n), output=cv)
    fetch = [state]
    if with_grad:
        fetch.append(pkg.gradients([L.reduce_sum(state)], [x])[0])
    return fetch


@pytest.mark.parametrize("build,x", [
    (_dropout_rnn, np.random.RandomState(2).randn(4, 3, 8)
     .astype(np.float32) + 3.0),
    (_dropout_while, np.random.RandomState(3).rand(16)
     .astype(np.float32) + 1.0)], ids=["static_rnn", "bounded_while"])
def test_dropout_replay_draws_the_forward_masks(build, x, monkeypatch):
    replayed = []
    vjp = torch.func.vjp

    def recording_vjp(f, *primals):
        out, fn = vjp(f, *primals)
        if f.__module__.endswith("control_flow_ops"):  # a macro's replay
            replayed.append([o.detach().clone() for o in out])
        return out, fn
    monkeypatch.setattr(torch.func, "vjp", recording_vjp)

    tails = []
    for with_grad in (True, False):
        main, startup = ptt.Program(), ptt.Program()
        with ptt.unique_name_guard(), ptt.program_guard(main, startup):
            fetch = build(ptt, with_grad)
            # a draw after the block reads where the run's generator is
            tail = ptt.layers.dropout(
                ptt.layers.fill_constant([64], "float32", 1.0), 0.5)
        main.random_seed = 5
        vals = ptt.Executor(ptt.CPUPlace()).run(
            main, feed={"x": x}, fetch_list=fetch + [tail],
            return_numpy=False, scope=ptt.Scope())
        tails.append(vals[-1])
        if with_grad:
            out, gx = vals[0], vals[1]
    # the replay's outputs are the forward's, bit for bit
    assert len(replayed) == 1
    assert torch.equal(replayed[0][-1], out)
    # every element's gradient is nonzero exactly where its path kept
    # every mask, as in the forward
    if build is _dropout_while:
        kept = out != 0
        assert torch.equal(gx != 0, kept)
        assert kept.any() and not kept.all()
    else:
        assert (gx != 0).any() and (gx == 0).any()
    # the replay drew from its own generator: the run's stream is where a
    # run without the grad ops leaves it
    assert torch.equal(tails[0], tails[1])


# ---------------------------------------------------------------------------
# donation around macros
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("macro_grad_after_update", [False, True],
                         ids=["plain", "macro_grad_after_update"])
def test_no_donation_before_a_macro_grad_op(macro_grad_after_update):
    """An SGD update of `w` is donated (written in place from the second
    run) unless a macro grad op comes after it in the block: such an op
    reads the values its forward stashed, which an update before it must
    not overwrite."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name_guard(), ptt.program_guard(main, startup):
        L = ptt.layers
        x = L.data("x", [3, 4, 4], append_batch_size=False)
        w = ptt.ParamAttr(name="w")
        loss = L.mean(L.fc(L.reshape(x, [12, 4]), 4, param_attr=w,
                           bias_attr=False))
        ptt.optimizer.SGD(0.1).minimize(loss)
        if macro_grad_after_update:
            x.stop_gradient = False
            rnn = L.StaticRNN()
            with rnn.step():
                h = L.fc(rnn.step_input(x), 4, bias_attr=False)
                rnn.step_output(h)
            ptt.gradients([L.mean(rnn())], [x])
    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((3, 4, 4), np.float32)}
    ptrs = []
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        ptrs.append(scope.find_var("w").data_ptr())
    assert (ptrs[1] == ptrs[2]) != macro_grad_after_update
