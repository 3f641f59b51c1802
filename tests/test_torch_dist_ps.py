"""The port's parameter-server trainer path on the CPU, against local runs
and against the JAX package's PS runs (mirrors tests/test_dist_ps.py:
pservers and trainers on loopback, trainers on threads, each with its own
Executor and Scope).

  * dense PS (sgd, adagrad, adam) with two trainers on identical feeds,
    and a sparse embedding PS, equal a local run (rtol 2e-3, atol 1e-4,
    test_dist_ps.py's: the server's optimizer is C++ f32);
  * the port's PS losses equal the JAX package's PS run step for step on
    the same program, startup weights and feeds (rtol 1e-5);
  * two trainers on different data converge; an LR schedule reaches the
    server; the fleet API; async mode, bare and through the Communicator;
  * the checkpoint round trip, restore_notify refreshing the scope, four
    sharded servers equal one server and the local run, a sharded
    checkpoint;
  * the prefetch's padded widths (`scatter_widths`) equal JAX's on
    tests/test_bucketing.py's stream and the written rows are bitwise
    JAX's; the scope's tensors keep their storage (written in place); the
    sparse gradients reach the plan as raw SelectedRows;
  * one job of real processes through `distributed.launch`
    (tools/dist_ps_runner.py): the two workers agree with each other and
    with a local run.
Every test stops the servers it started and closes its clients.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.transpiler import (DistributeTranspiler as JDistTranspiler,
                                   start_pserver as j_start_pserver)
from paddle_tpu_torch.framework.selected_rows import SelectedRows
from paddle_tpu_torch.tools import dist_ps_runner
from paddle_tpu_torch.transpiler import (DistributeTranspiler,
                                         start_pserver)
from test_dist_ps import _feeds, _free_port
from test_dist_ps import _run_ps as _jax_run_ps
from torch_port_common import one_torch_thread  # noqa: F401


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-3, 1e-4      # PS vs local (tests/test_dist_ps.py)
XRTOL = 1e-5                 # the port's PS run vs JAX's PS run

# id -> pkg -> optimizer factory
OPTS = {
    "sgd": lambda pkg: lambda: pkg.optimizer.SGD(learning_rate=0.05),
    "adam": lambda pkg: lambda: pkg.optimizer.Adam(learning_rate=0.05),
    "adagrad": lambda pkg: lambda: pkg.optimizer.Adagrad(learning_rate=0.1),
}


def _cpu():
    return ptt.Executor(ptt.CPUPlace())


def _build(pkg, make_opt, sparse=False, seed=7):
    """tests/test_dist_ps.py's model in either package's DSL."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        if sparse:
            ids = pkg.layers.data("ids", [1], dtype="int64")
            x = pkg.layers.embedding(ids, size=[50, 8], is_sparse=True)
        else:
            x = pkg.layers.data("x", [8], dtype="float32")
        h = pkg.layers.fc(x, size=16, act="relu")
        y = pkg.layers.fc(h, size=1)
        label = pkg.layers.data("label", [1], dtype="float32")
        loss = pkg.layers.mean(pkg.layers.square(y - label))
        make_opt().minimize(loss)
    main.random_seed = startup.random_seed = seed
    return main, startup, loss


def _jax_startup(sparse):
    """The JAX package's startup values of _build's program (seed 7)."""
    main, startup, _ = _build(pt, OPTS["sgd"](pt), sparse)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor().run(startup)
    return {p.name: np.asarray(scope.find_var(p.name))
            for p in main.all_parameters()}


def _run_local(make_opt, feeds, sparse, init=None):
    main, startup, loss = _build(ptt, make_opt, sparse)
    exe, scope = _cpu(), ptt.Scope()
    exe.run(startup, scope=scope)
    if init:
        ptt.io.set_params_from_numpy(scope, init, "cpu")
    return [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                   scope=scope)[0])[0]) for f in feeds]


def _transpile(make_opt, sparse, endpoints, tid=0, trainers=1, sync=True):
    main, startup, loss = _build(ptt, make_opt, sparse)
    t = DistributeTranspiler()
    t.transpile(tid, program=main, pservers=endpoints, trainers=trainers,
                sync_mode=sync, startup_program=startup)
    return main, startup, loss, t


def _run_ps(make_opt, feeds_per_trainer, sparse, trainers, n_servers=2,
            init=None):
    """Port PS run: `n_servers` pservers, one thread a trainer, each with
    its own Executor and Scope. Returns the trainers' losses and their
    executors."""
    endpoints = ",".join(f"127.0.0.1:{_free_port()}"
                         for _ in range(n_servers))
    progs = [_transpile(make_opt, sparse, endpoints, tid, trainers)
             for tid in range(trainers)]
    servers = [start_pserver(progs[0][3].get_pserver_program(ep))
               for ep in endpoints.split(",")]
    results, exes, errors = [None] * trainers, [None] * trainers, []

    def trainer(tid):
        main, startup, loss, _ = progs[tid]
        try:
            exe, scope = _cpu(), ptt.Scope()
            exes[tid] = exe
            exe.run(startup, scope=scope)
            if init:
                ptt.io.set_params_from_numpy(scope, init, "cpu")
            results[tid] = [float(np.ravel(exe.run(
                main, feed=f, fetch_list=[loss], scope=scope)[0])[0])
                for f in feeds_per_trainer[tid]]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            main._ps_plan.shutdown()

    threads = [threading.Thread(target=trainer, args=(tid,))
               for tid in range(trainers)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        for srv in servers:
            srv.stop()
    assert not any(th.is_alive() for th in threads), "trainer timed out"
    assert not errors, errors[0]
    return results, exes


@pytest.mark.parametrize("opt_name", sorted(OPTS))
def test_ps_dense_equals_local(opt_name):
    """2 trainers, identical feeds: the sync-PS mean grad is each
    trainer's grad, so the trajectory is the local run's."""
    feeds = _feeds(5, sparse=False)
    local = _run_local(OPTS[opt_name](ptt), feeds, sparse=False)
    res, exes = _run_ps(OPTS[opt_name](ptt), [feeds, feeds], sparse=False,
                        trainers=2)
    for tid in range(2):
        np.testing.assert_allclose(res[tid], local, rtol=RTOL, atol=ATOL,
                                   err_msg=f"trainer {tid} ({opt_name})")
    # each trainer's executor compiled its own startup and step, once
    assert [e.compile_count for e in exes] == [2, 2]


def test_ps_sparse_embedding_equals_local():
    feeds = _feeds(5, sparse=True)
    local = _run_local(OPTS["sgd"](ptt), feeds, sparse=True)
    res, _ = _run_ps(OPTS["sgd"](ptt), [feeds, feeds], sparse=True,
                     trainers=2)
    for tid in range(2):
        np.testing.assert_allclose(res[tid], local, rtol=RTOL, atol=ATOL,
                                   err_msg=f"trainer {tid}")


@pytest.mark.parametrize("sparse,opt_name", [(False, "adam"),
                                             (True, "adam")])
def test_ps_losses_equal_jax_ps_run(sparse, opt_name):
    """The same program, startup weights and feeds through both packages'
    PS paths (each against its own server): the losses agree step for
    step."""
    feeds = _feeds(5, sparse=sparse)
    jres = _jax_run_ps(OPTS[opt_name](pt), [feeds], sparse=sparse,
                       trainers=1, n_servers=1)
    res, _ = _run_ps(OPTS[opt_name](ptt), [feeds], sparse=sparse,
                     trainers=1, n_servers=1, init=_jax_startup(sparse))
    np.testing.assert_allclose(res[0], jres[0], rtol=XRTOL, atol=1e-7)


def test_ps_two_trainers_different_data_converge():
    f0 = _feeds(12, sparse=False, rng_seed=1)
    f1 = _feeds(12, sparse=False, rng_seed=2)
    res, _ = _run_ps(OPTS["sgd"](ptt), [f0, f1], sparse=False, trainers=2)
    for tid in range(2):
        assert np.mean(res[tid][-3:]) < np.mean(res[tid][:3]), res[tid]


def test_ps_lr_schedule_pushed_to_server():
    """LR decay computed on the trainer reaches the server tables."""
    def opt():
        return ptt.optimizer.SGD(
            learning_rate=ptt.layers.exponential_decay(
                learning_rate=0.1, decay_steps=1, decay_rate=0.5,
                staircase=True))

    feeds = _feeds(4, sparse=False)
    local = _run_local(opt, feeds, sparse=False)
    res, _ = _run_ps(opt, [feeds], sparse=False, trainers=1, n_servers=1)
    np.testing.assert_allclose(res[0], local, rtol=RTOL, atol=ATOL)


def test_fleet_ps_api():
    """fleet facade: the server role runs the KV service, the worker
    trains (tests/test_dist_ps.py::test_fleet_ps_api)."""
    from paddle_tpu_torch.incubate.fleet.base.role_maker import (
        UserDefinedRoleMaker, Role)
    from paddle_tpu_torch.incubate.fleet.parameter_server import PSFleet

    eps = [f"127.0.0.1:{_free_port()}"]

    def build_and_minimize(f):
        main, startup = ptt.Program(), ptt.Program()
        with ptt.unique_name_guard(), ptt.program_guard(main, startup):
            x = ptt.layers.data("x", [4], dtype="float32")
            y = ptt.layers.fc(x, size=1)
            label = ptt.layers.data("label", [1], dtype="float32")
            loss = ptt.layers.mean(ptt.layers.square(y - label))
            f.distributed_optimizer(ptt.optimizer.SGD(
                learning_rate=0.1)).minimize(loss, startup_program=startup)
        return main, startup, loss

    fsrv = PSFleet()
    fsrv.init(UserDefinedRoleMaker(current_id=0, role=Role.SERVER,
                                   worker_num=1, server_endpoints=eps))
    build_and_minimize(fsrv)
    fsrv.run_server(blocking=False)
    fwk = PSFleet()
    try:
        fwk.init(UserDefinedRoleMaker(current_id=0, role=Role.WORKER,
                                      worker_num=1, server_endpoints=eps))
        main, startup, loss = build_and_minimize(fwk)
        fwk.init_worker()
        exe, scope = _cpu(), ptt.Scope()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(0)
        losses = []
        for _ in range(8):
            x = rng.randn(8, 4).astype(np.float32)
            (lv,) = exe.run(fwk.main_program,
                            feed={"x": x, "label": x.sum(1, keepdims=True)},
                            fetch_list=[loss], scope=scope)
            losses.append(float(np.ravel(lv)[0]))
    finally:
        fwk.stop_worker()
        fsrv.stop_server()
    assert losses[-1] < losses[0]


def _one_server(make_opt, sparse=False, sync=True):
    ep = f"127.0.0.1:{_free_port()}"
    main, startup, loss, t = _transpile(make_opt, sparse, ep, sync=sync)
    return main, startup, loss, start_pserver(t.get_pserver_program(ep))


def test_ps_async_mode_converges():
    """Async PS without a Communicator: pushes apply at once, no
    aggregation round."""
    main, startup, loss, srv = _one_server(OPTS["sgd"](ptt), sync=False)
    try:
        exe, scope = _cpu(), ptt.Scope()
        exe.run(startup, scope=scope)
        losses = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0])[0])
                  for f in _feeds(10, sparse=False)]
    finally:
        main._ps_plan.shutdown()
        srv.stop()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_ps_async_communicator_converges():
    """The background Communicator (merge queues, send and recv threads):
    steps never block on the network and training still converges. The
    producer is paced against the recv interval, as in
    tests/test_dist_ps.py; the recv thread rebinds the scope's params."""
    import time
    main, startup, loss, srv = _one_server(
        lambda: ptt.optimizer.SGD(learning_rate=0.02), sync=False)
    plan = main._ps_plan
    try:
        exe, scope = _cpu(), ptt.Scope()
        exe.run(startup, scope=scope)
        comm = plan.start_communicator(scope, recv_interval_ms=5)
        losses = []
        for f in _feeds(40, sparse=False):
            (lv,) = exe.run(main, feed=f, fetch_list=[loss], scope=scope)
            losses.append(float(np.ravel(lv)[0]))
            time.sleep(0.01)
        assert comm.sent_batches > 0
    finally:
        plan.shutdown()
        srv.stop()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.5, (
        losses[:5], losses[-5:])


def test_ps_checkpoint_roundtrip(tmp_path):
    """checkpoint_notify mid-training, a fresh server restored with
    restore_notify: training resumes from the same state."""
    feeds = _feeds(8, sparse=False)
    main, startup, loss, srv = _one_server(OPTS["adam"](ptt))
    plan = main._ps_plan
    try:
        exe, scope = _cpu(), ptt.Scope()
        exe.run(startup, scope=scope)
        for f in feeds[:4]:
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        plan.checkpoint_notify(str(tmp_path))
        after = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                        scope=scope)[0])[0])
                 for f in feeds[4:]]
    finally:
        plan.shutdown()
        srv.stop()
    main2, startup2, loss2, srv2 = _one_server(OPTS["adam"](ptt))
    plan2 = main2._ps_plan
    try:
        exe2, scope2 = _cpu(), ptt.Scope()
        exe2.run(startup2, scope=scope2)
        plan2.ensure_init(scope2)                    # creates the tables
        plan2.restore_notify(str(tmp_path), scope=scope2)
        resumed = [float(np.ravel(exe2.run(main2, feed=f,
                                           fetch_list=[loss2],
                                           scope=scope2)[0])[0])
                   for f in feeds[4:]]
    finally:
        plan2.shutdown()
        srv2.stop()
    np.testing.assert_array_equal(resumed, after)


def test_restore_notify_refreshes_scope(tmp_path):
    main, startup, loss, srv = _one_server(OPTS["sgd"](ptt))
    plan = main._ps_plan
    try:
        exe, scope = _cpu(), ptt.Scope()
        exe.run(startup, scope=scope)
        for f in _feeds(3, sparse=False):
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        plan.checkpoint_notify(str(tmp_path))
        wname = plan.specs[0].name
        trained = scope.get_numpy(wname)
        scope.find_var(wname).zero_()     # clobber the local params
        plan.restore_notify(str(tmp_path), scope=scope)
        np.testing.assert_array_equal(scope.get_numpy(wname), trained)
    finally:
        plan.shutdown()
        srv.stop()


def test_ps_sparse_4_servers_equal_one_server_and_local():
    """Sparse tables shard rows by id hash over every pserver: four
    servers give one server's trajectory and the local one."""
    feeds = _feeds(6, sparse=True)
    local = _run_local(OPTS["adam"](ptt), feeds, sparse=True)
    one, _ = _run_ps(OPTS["adam"](ptt), [feeds, feeds], sparse=True,
                     trainers=2, n_servers=1)
    four, _ = _run_ps(OPTS["adam"](ptt), [feeds, feeds], sparse=True,
                      trainers=2, n_servers=4)
    for tid in range(2):
        np.testing.assert_array_equal(four[tid], one[tid])
        np.testing.assert_allclose(four[tid], local, rtol=RTOL, atol=ATOL)


def test_ps_sharded_checkpoint_roundtrip_4_servers(tmp_path):
    """Each of 4 servers snapshots its own id-hash shard; a restore gives
    back every row."""
    endpoints = ",".join(f"127.0.0.1:{_free_port()}" for _ in range(4))
    main, startup, loss, t = _transpile(OPTS["sgd"](ptt), True, endpoints)
    servers = [start_pserver(t.get_pserver_program(ep))
               for ep in endpoints.split(",")]
    plan = main._ps_plan
    try:
        exe, scope = _cpu(), ptt.Scope()
        exe.run(startup, scope=scope)
        for f in _feeds(3, sparse=True):
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        spec = next(s for s in plan.specs if s.sparse)
        ids = np.arange(spec.shape[0])
        before = plan.pull_sparse_sharded(spec, ids)
        plan.checkpoint_notify(str(tmp_path))
        plan.push_sparse_sharded(spec, ids, np.ones_like(before) * 7.0)
        plan.restore_notify(str(tmp_path))
        np.testing.assert_array_equal(plan.pull_sparse_sharded(spec, ids),
                                      before)
    finally:
        plan.shutdown()
        for srv in servers:
            srv.stop()


def _bucketing_program(pkg):
    """tests/test_bucketing.py:56's program."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        ids = pkg.layers.data("ids", [6], dtype="int64")
        y = pkg.layers.data("y", [1])
        emb = pkg.layers.embedding(ids, size=[5000, 8], is_sparse=True)
        pred = pkg.layers.fc(pkg.layers.reduce_sum(emb, dim=1), 1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup


def _prefetch_stream(plan_of, scope, run_before):
    """Ten before_steps over tests/test_bucketing.py:56's feeds; the table
    after each."""
    rng = np.random.RandomState(0)
    tables = []
    for _ in range(10):
        b = rng.randint(2, 40)
        feed = {"ids": rng.randint(0, 5000, (b, 6)).astype(np.int64)}
        run_before(feed)
        tables.append(np.asarray(plan_of.table()).copy())
    return tables


def test_prefetch_scatter_widths_and_rows_equal_jax():
    """The padded unique-id widths of the sparse prefetch are JAX's, and
    the table after each prefetch is bitwise JAX's (each package against
    its own server, seeded from the same startup table)."""
    from paddle_tpu.reader.bucketing import pow2_boundaries
    results = {}
    for name, pkg, transpiler, starter in (
            ("jax", pt, JDistTranspiler, j_start_pserver),
            ("port", ptt, DistributeTranspiler, start_pserver)):
        main, startup = _bucketing_program(pkg)
        ep = f"127.0.0.1:{_free_port()}"
        t = transpiler()
        t.transpile(0, program=main, pservers=ep, trainers=1,
                    sync_mode=True, startup_program=startup)
        srv = starter(t.get_pserver_program(ep))
        plan = main._ps_plan
        spec = next(s for s in plan.specs if s.sparse)
        try:
            if name == "jax":
                scope = pt.Scope()
                with pt.scope_guard(scope):
                    pt.Executor().run(startup)
                table0 = np.asarray(scope.find_var(spec.name)).copy()
            else:
                scope = ptt.Scope()
                _cpu().run(startup, scope=scope)
                ptt.io.set_params_from_numpy(scope, {spec.name: table0},
                                             "cpu")
            plan.ensure_init(scope)

            class View:
                @staticmethod
                def table():
                    v = scope.find_var(spec.name)
                    return v.numpy() if isinstance(v, torch.Tensor) else v

            ptr = None if name == "jax" else \
                scope.find_var(spec.name).data_ptr()
            tables = _prefetch_stream(
                View, scope, lambda feed: plan.before_step(scope, feed))
            if ptr is not None:       # written in place
                assert scope.find_var(spec.name).data_ptr() == ptr
            results[name] = (list(plan.scatter_widths), tables)
        finally:
            plan.shutdown()
            srv.stop()
    jw, jt = results["jax"]
    tw, tt = results["port"]
    assert tw == jw
    assert set(tw) <= set(pow2_boundaries(64, 5000)) and len(set(tw)) <= 3
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a, b)


def test_ps_step_keeps_storage_and_fetches_sparse_grads_raw():
    """The PS step writes the pulled values into the scope's tensors in
    place (the table by index_copy_, the dense params by copy_), and the
    sparse gradient reaches the plan as a raw SelectedRows while the user
    fetch of the same name is densified."""
    main, startup, loss, srv = _one_server(OPTS["sgd"](ptt), sparse=True)
    plan = main._ps_plan
    seen = []
    orig = plan.after_step
    plan.after_step = lambda scope, fetched: (
        seen.append(fetched[spec.grad_name]), orig(scope, fetched))
    spec = next(s for s in plan.specs if s.sparse)
    try:
        exe, scope = _cpu(), ptt.Scope()
        exe.run(startup, scope=scope)
        names = [s.name for s in plan.specs]
        feeds = _feeds(3, sparse=True)
        exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
        ptrs = {n: scope.find_var(n).data_ptr() for n in names}
        for f in feeds[1:]:
            _, g = exe.run(main, feed=f, fetch_list=[loss, spec.grad_name],
                           scope=scope)
        assert {n: scope.find_var(n).data_ptr() for n in names} == ptrs
    finally:
        plan.shutdown()
        srv.stop()
    assert all(isinstance(v, SelectedRows) for v in seen)
    assert g.shape == tuple(spec.shape)
    np.testing.assert_allclose(g, seen[-1].to_dense().numpy(), rtol=0)


def test_launch_ps_job_of_processes_sparse(tmp_path):
    """One pserver and two trainers as real processes through the launcher
    (`distributed/launch.py` run as a script, the same `launch()` that
    `python -m paddle_tpu_torch.distributed.launch` runs; as a script it
    imports no torch, so only the job's three processes pay for that
    import; the runner in tools/dist_ps_runner.py, on the CPU): the
    workers' losses agree with each other and with a local run of the
    same model and feeds."""
    env = dict(os.environ, DIST_PS_OUT=str(tmp_path), DIST_PS_MODE="sparse",
               DIST_PS_DEVICE="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    cmd = [sys.executable,
           os.path.join(ROOT, "paddle_tpu_torch", "distributed", "launch.py"),
           "--server_num=1", "--worker_num=2",
           f"--started_port={_free_port()}", f"--log_dir={tmp_path}",
           os.path.join(ROOT, "paddle_tpu_torch", "tools",
                        "dist_ps_runner.py")]
    proc = subprocess.run(cmd, env=env, timeout=240, capture_output=True,
                          text=True)
    logs = "".join(f"\n== {f.name} ==\n" + f.read_text()[-2000:]
                   for f in tmp_path.iterdir() if f.suffix == ".log")
    assert proc.returncode == 0, proc.stderr + logs
    w0 = json.load(open(tmp_path / "worker.0.json"))
    w1 = json.load(open(tmp_path / "worker.1.json"))

    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name_guard(), ptt.program_guard(main, startup):
        loss = dist_ps_runner.build_model(ptt, True)
        ptt.optimizer.SGD(learning_rate=0.05).minimize(loss)
    main.random_seed = startup.random_seed = dist_ps_runner.SEED
    exe, scope = _cpu(), ptt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    local = [float(np.ravel(exe.run(
        main, feed=dist_ps_runner.make_feed(rng, True), fetch_list=[loss],
        scope=scope)[0])[0]) for _ in range(dist_ps_runner.STEPS)]
    np.testing.assert_allclose(w0, w1, rtol=1e-6)
    np.testing.assert_allclose(w0, local, rtol=RTOL, atol=ATOL)


def test_ps_step_records_a_span_for_each_part():
    """One PS step under the tracer: a ps/* span for each part of the
    exchange (chip_smoke.py's phase 4l reads them as host time)."""
    from paddle_tpu_torch.observability import tracer
    main, startup, loss, srv = _one_server(OPTS["sgd"](ptt), sparse=True)
    was = tracer.tracing_enabled()
    t = tracer.enable_tracing()
    try:
        exe, scope = _cpu(), ptt.Scope()
        exe.run(startup, scope=scope)
        t.clear()
        exe.run(main, feed=_feeds(1, sparse=True)[0], fetch_list=[loss],
                scope=scope)
        names = {s.name for s in t.snapshot() if s.cat == "ps"}
    finally:
        t.clear()
        if not was:
            tracer.disable_tracing()
        main._ps_plan.shutdown()
        srv.stop()
    assert names == {"ps/ensure_init", "ps/pull_sparse", "ps/scatter",
                     "ps/step", "ps/fetch", "ps/push_sparse",
                     "ps/push_dense", "ps/pull_dense"}
