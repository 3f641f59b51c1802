"""The port's Executor compile surface against the JAX package's, on the CPU.

* The compile cache: the same sequence of runs through both executors
  gives the same `compile_count`, cache hit/miss/eviction counters, cache
  size, and recompile causes and details in the same order (a feed-shape
  change, a fetch-list change, a program version bump, eviction churn at
  `cache_capacity=2`, an evicted program at capacity 1); mirrors
  tests/test_train_stats.py's cache cases.
* Donation: `donate=True` updates the parameters and the Adam state in
  place (stable `data_ptr`) and gives bitwise the values of
  `donate=False` after 3 Adam steps of a small GPT (2 layers, hidden 32);
  a tensor the user or io put in the scope is never written in place.
* The nan/inf sanitizer (FLAGS_check_nan_inf=1): both packages raise the
  same FloatingPointError, naming the same op index, type and var.
* CompiledProgram on one device, and the parts that still raise.
"""

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import observability as jobs
from paddle_tpu_torch import observability as tobs
from torch_port_common import one_torch_thread  # noqa: F401


R = np.random.RandomState(0)
X0 = R.randn(8, 4).astype("f")
L0 = R.randint(0, 3, (8, 1)).astype("int64")


@pytest.fixture(autouse=True)
def _fresh_registries():
    jobs.get_registry().reset()
    tobs.get_registry().reset()
    yield
    jobs.get_registry().reset()
    tobs.get_registry().reset()


def _classifier(pkg):
    """4 -> 8 (relu) -> 3 softmax cross-entropy + Adam, in either
    package: (main, startup, loss)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4])
        y = pkg.layers.data("y", [1], dtype="int64")
        h = pkg.layers.fc(x, 8, act="relu")
        logits = pkg.layers.fc(h, 3)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        pkg.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _exe(pkg, **kw):
    return pkg.Executor(**kw) if pkg is pt \
        else pkg.Executor(ptt.CPUPlace(), **kw)


def _feed(b):
    reps = b // 8 + 1
    return {"x": np.tile(X0, (reps, 1))[:b], "y": np.tile(L0, (reps, 1))[:b]}


def _counters(pkg):
    snap = (jobs if pkg is pt else tobs).get_registry().snapshot()

    def total(name):
        return sum(s["value"] for s in snap.get(name, {}).get("series", []))

    return {k: total(k) for k in (
        "executor_cache_hits_total", "executor_cache_misses_total",
        "executor_cache_evictions_total", "executor_cache_size",
        "executor_runs_total")}


def _drive(pkg, sequence, capacity=None):
    """Run `sequence(pkg, exe, scope)` and return everything the cache
    surface reports."""
    exe = _exe(pkg, cache_capacity=capacity)
    scope = pkg.Scope()
    sequence(pkg, exe, scope)
    return {"compile_count": exe.compile_count,
            "counters": _counters(pkg),
            "recompiles": [(r["cause"], r["detail"])
                           for r in exe.recompile_log]}


def _shape_fetch_version(pkg, exe, scope):
    main, startup, loss = _classifier(pkg)
    gname = main.all_parameters()[0].name + "@GRAD"
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(8), fetch_list=[loss], scope=scope)
    exe.run(main, feed=_feed(8), fetch_list=[loss], scope=scope)   # hit
    exe.run(main, feed=_feed(16), fetch_list=[loss], scope=scope)  # shape
    exe.run(main, feed=_feed(16), fetch_list=[loss, gname],
            scope=scope)                                           # fetch
    main._bump_version()
    exe.run(main, feed=_feed(16), fetch_list=[loss], scope=scope)  # version
    exe.run(main, feed=_feed(16), fetch_list=[loss], scope=scope)  # hit


def _churn(pkg, exe, scope):
    main, startup, loss = _classifier(pkg)
    exe.run(startup, scope=scope)
    for b in (4, 8, 12, 4, 8):     # 3 shapes through 2 slots
        exe.run(main, feed=_feed(b), fetch_list=[loss], scope=scope)


def _evicted(pkg, exe, scope):
    main_a, startup_a, loss_a = _classifier(pkg)
    main_b, startup_b, loss_b = _classifier(pkg)
    exe.run(startup_a, scope=scope)
    exe.run(startup_b, scope=scope)
    exe.run(main_a, feed=_feed(8), fetch_list=[loss_a], scope=scope)
    exe.run(main_b, feed=_feed(8), fetch_list=[loss_b], scope=scope)
    exe.run(main_a, feed=_feed(8), fetch_list=[loss_a], scope=scope)


@pytest.mark.parametrize("sequence,capacity", [
    (_shape_fetch_version, None), (_churn, 2), (_evicted, 1)],
    ids=["shape_fetch_version", "churn_capacity2", "evicted_capacity1"])
def test_cache_counts_and_causes_match_jax(sequence, capacity):
    j = _drive(pt, sequence, capacity)
    t = _drive(ptt, sequence, capacity)
    assert t == j
    assert j["recompiles"]   # every sequence recompiles at least once


def test_recompile_detail_and_log():
    t = _drive(ptt, _shape_fetch_version)
    causes = [c for c, _ in t["recompiles"]]
    assert causes == ["feed_shape", "fetch_list", "program_version"]
    assert t["recompiles"][0][1] == {"var": "x", "from": [8, 4],
                                     "to": [16, 4]}
    from paddle_tpu_torch.observability import train_stats
    assert train_stats.recompile_log()[-1]["cause"] == "program_version"
    rc = tobs.get_registry().snapshot()["executor_recompiles_total"]
    assert sorted((s["labels"]["cause"], s["value"])
                  for s in rc["series"]) == [
        ("feed_shape", 1.0), ("fetch_list", 1.0), ("program_version", 1.0)]


def test_cache_capacity_flag(monkeypatch):
    monkeypatch.setenv("FLAGS_executor_cache_capacity", "3")
    assert ptt.Executor(ptt.CPUPlace())._cache_capacity == 3
    assert ptt.Executor(ptt.CPUPlace(), cache_capacity=5)._cache_capacity \
        == 5


# ---------------------------------------------------------------------------
# donation
# ---------------------------------------------------------------------------

def _tiny_gpt():
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_lm_program
    cfg = GPTConfig(vocab_size=97, hidden=32, layers=2, heads=4,
                    max_pos=64, dropout=0.0, attn_impl="xla")
    with ptt.unique_name_guard():
        return gpt_lm_program(cfg, 16, learning_rate=1e-2)


_IDS = np.random.RandomState(1).randint(0, 97, (2, 16)).astype("int64")


def _state(scope):
    return [n for n in scope.var_names() if n != "@RNG@"]


def test_donation_is_bitwise_and_in_place():
    finals, ptrs_stable = {}, {}
    for donate in (True, False):
        main, startup, f = _tiny_gpt()
        exe = ptt.Executor(ptt.CPUPlace(), donate=donate)
        scope = ptt.Scope()
        exe.run(startup, scope=scope)
        names = _state(scope)
        objs = {n: scope.find_var(n) for n in names}
        ptrs = {n: t.data_ptr() for n, t in objs.items()}
        losses = [exe.run(main, feed={"tokens": _IDS},
                          fetch_list=[f["loss"]], scope=scope)[0]
                  for _ in range(3)]
        finals[donate] = ({n: scope.get_numpy(n) for n in names}, losses)
        written = [n for n in names if n in set(
            op.output_names()[0] for op in main.global_block.ops
            if op.type == "adam")] + [
            n for n in names if "moment" in n or "beta" in n]
        assert written
        ptrs_stable[donate] = [scope.find_var(n).data_ptr() == ptrs[n]
                               for n in written]
    assert all(ptrs_stable[True])          # updated in the same storage
    assert not any(ptrs_stable[False])     # a new tensor every write
    (on, l_on), (off, l_off) = finals[True], finals[False]
    assert set(on) == set(off)
    for n in on:
        np.testing.assert_array_equal(on[n], off[n], err_msg=n)
    np.testing.assert_array_equal(np.array(l_on), np.array(l_off))


def test_user_tensors_are_never_written_in_place():
    """A tensor the user (or io.set_params_from_numpy) put in the scope
    keeps its values; the first run binds a new tensor to the name, and
    later runs update that one in place."""
    main, startup, f = _tiny_gpt()
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    pname = "gpt/wte"
    user = scope.find_var(pname).clone()
    scope.set_var(pname, user)
    moment = next(n for n in _state(scope) if "moment1" in n)
    ptt.io.set_params_from_numpy(scope, {moment: scope.get_numpy(moment)},
                                 "cpu")
    held = {pname: user, moment: scope.find_var(moment)}
    before = {n: t.clone() for n, t in held.items()}
    exe.run(main, feed={"tokens": _IDS}, fetch_list=[f["loss"]],
            scope=scope)
    for n, t in held.items():
        assert torch_equal(t, before[n]), n        # untouched
        assert scope.find_var(n) is not t          # re-bound
    bound = {n: scope.find_var(n) for n in held}
    ptr = {n: t.data_ptr() for n, t in bound.items()}
    exe.run(main, feed={"tokens": _IDS}, fetch_list=[f["loss"]],
            scope=scope)
    for n in held:
        assert scope.find_var(n) is bound[n]       # now donated in place
        assert scope.find_var(n).data_ptr() == ptr[n]


def torch_equal(a, b):
    return bool((a == b).all())


def test_fetched_numpy_is_a_copy():
    """A fetched parameter is a host copy, not a view a later in-place
    step could change."""
    main, startup, f = _tiny_gpt()
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    w, = exe.run(main, feed={"tokens": _IDS}, fetch_list=["gpt/wte"],
                 scope=scope)
    snap = scope.get_numpy("gpt/wte")
    keep = w.copy(), snap.copy()
    exe.run(main, feed={"tokens": _IDS}, fetch_list=[f["loss"]],
            scope=scope)
    np.testing.assert_array_equal(w, keep[0])
    np.testing.assert_array_equal(snap, keep[1])
    assert not np.array_equal(scope.get_numpy("gpt/wte"), keep[1])


# ---------------------------------------------------------------------------
# the nan/inf sanitizer
# ---------------------------------------------------------------------------

def _div_program(pkg):
    main = pkg.Program()
    blk = main.global_block
    blk.create_var(name="x", shape=(4,), dtype="float32", is_data=True)
    blk.create_var(name="y", shape=(4,), dtype="float32", is_data=True)
    blk.append_op("scale", {"X": ["x"]}, {"Out": ["s"]}, {"scale": 2.0})
    blk.append_op("elementwise_div", {"X": ["s"], "Y": ["y"]},
                  {"Out": ["q"]}, {"axis": -1})
    blk.append_op("mean", {"X": ["q"]}, {"Out": ["m"]})
    return main


def test_nan_inf_sanitizer_matches_jax(monkeypatch):
    monkeypatch.setenv("FLAGS_check_nan_inf", "1")
    feed = {"x": np.ones(4, np.float32),
            "y": np.array([1.0, 0.0, 2.0, 4.0], np.float32)}
    msgs = []
    for pkg in (pt, ptt):
        with pytest.raises(FloatingPointError) as ei:
            _exe(pkg).run(_div_program(pkg), feed=feed, fetch_list=["m"],
                          scope=pkg.Scope())
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "'q'" in msgs[1] and "#1" in msgs[1] and "elementwise_div" \
        in msgs[1]
    # finite inputs pass; without the flag nothing is checked
    ok = dict(feed, y=np.full(4, 2.0, np.float32))
    m, = _exe(ptt).run(_div_program(ptt), feed=ok, fetch_list=["m"],
                       scope=ptt.Scope())
    assert m[0] == 1.0
    monkeypatch.setenv("FLAGS_check_nan_inf", "0")
    m, = _exe(ptt).run(_div_program(ptt), feed=feed, fetch_list=["m"],
                       scope=ptt.Scope())
    assert np.isinf(m[0])


# ---------------------------------------------------------------------------
# CompiledProgram and the unported parts
# ---------------------------------------------------------------------------

def test_compiled_program_runs_its_program_on_one_device():
    main, startup, loss = _classifier(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(8), fetch_list=[loss], scope=scope)
    compiled = ptt.CompiledProgram(main)
    exe.run(compiled, feed=_feed(8), fetch_list=[loss], scope=scope)
    assert exe.compile_count == 2          # startup, main: then a hit
    assert not exe.recompile_log
    for meth, item in (("with_data_parallel", "A.8"),
                       ("with_sharding", "A.8"),
                       ("with_collective", "A.8"),
                       ("with_recompute", "A.9")):
        with pytest.raises(NotImplementedError, match=item):
            getattr(compiled, meth)(*(({},) if meth == "with_sharding"
                                      else ()))


def test_unported_executor_paths_raise_naming_their_items():
    exe = ptt.Executor(ptt.CPUPlace())
    with pytest.raises(NotImplementedError, match="A.12"):
        exe.train_from_dataset(ptt.Program(), dataset=None)
    # the PS path and the RPC ops are ported (a send with nothing to push
    # runs); capture_hlo is what still raises here
    p = ptt.Program()
    p.global_block.append_op("send", {"X": []}, {}, {"epmap": ["e:1"]},
                             infer_shape=False)
    exe.run(p)
    exe.capture_hlo = True
    with pytest.raises(NotImplementedError, match="A.8"):
        exe.run(p)


def test_host_save_program_runs_in_the_prefix(tmp_path):
    """A save op, which raised before the host ops were ported, runs as a
    host-only program: the file holds the scope's value, and no step is
    compiled."""
    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    ptt.io.set_params_from_numpy(scope, {"w": w}, "cpu")
    p = ptt.Program()
    p.global_block.create_var(name="w", shape=[2, 3], dtype="float32",
                              persistable=True)
    path = str(tmp_path / "w.npy")
    p.global_block.append_op("save", {"X": ["w"]}, {}, {"file_path": path},
                             infer_shape=False)
    exe.run(p, scope=scope)
    np.testing.assert_array_equal(np.load(path), w)
    assert exe.compile_count == 0


@pytest.mark.parametrize("opt", ["sgd", "momentum", "momentum_nesterov"])
def test_in_place_sgd_and_momentum_are_bitwise(opt):
    """The sgd and momentum rules' in-place forms against their
    out-of-place ones, 3 steps of the classifier."""
    finals = {}
    for donate in (True, False):
        main, startup = ptt.Program(), ptt.Program()
        with ptt.unique_name_guard(), ptt.program_guard(main, startup):
            x = ptt.layers.data("x", [4])
            y = ptt.layers.data("y", [1], dtype="int64")
            logits = ptt.layers.fc(ptt.layers.fc(x, 8, act="relu"), 3)
            loss = ptt.layers.mean(
                ptt.layers.softmax_with_cross_entropy(logits, y))
            o = (ptt.optimizer.SGD(0.1) if opt == "sgd" else
                 ptt.optimizer.Momentum(0.1, 0.9, use_nesterov=(
                     opt == "momentum_nesterov")))
            o.minimize(loss)
        exe = ptt.Executor(ptt.CPUPlace(), donate=donate)
        scope = ptt.Scope()
        exe.run(startup, scope=scope)
        w = main.all_parameters()[0].name
        for i in range(3):
            exe.run(main, feed=_feed(8), fetch_list=[loss], scope=scope)
            if i == 0:
                first = scope.find_var(w)
        assert (scope.find_var(w) is first) == donate
        finals[donate] = {n: scope.get_numpy(n) for n in _state(scope)}
    for n, v in finals[True].items():
        np.testing.assert_array_equal(v, finals[False][n], err_msg=n)


def test_fetched_tensors_are_this_steps_values():
    """With return_numpy=False a fetched parameter is a copy: a later
    in-place step does not reach it."""
    main, startup, f = _tiny_gpt()
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):    # the second step updates in place
        w, = exe.run(main, feed={"tokens": _IDS}, fetch_list=["gpt/wte"],
                     scope=scope, return_numpy=False)
    assert w is not scope.find_var("gpt/wte")
    keep = w.clone()
    exe.run(main, feed={"tokens": _IDS}, fetch_list=[f["loss"]],
            scope=scope)
    assert torch_equal(w, keep)
    assert not torch_equal(scope.find_var("gpt/wte"), keep)
