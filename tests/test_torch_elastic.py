"""Elastic membership of the PyTorch port (distributed/elastic.py, a copy
of the JAX package's), on the CPU (mirrors tests/test_elastic.py):

  * join, heartbeat and leave; a crash detected by the heartbeat timeout,
    with on_change seeing both the join and the departure;
  * an async PS world that a second trainer joins mid-training: its
    bootstrap pull sees the current params and both trainers' pushes
    land;
  * SyncElasticTrainer over a world stub on a plain one-device Program:
    a world change saves, rebuilds, reruns the startup and reloads, and
    the losses equal an uninterrupted run's, bitwise;
  * the Communicator of an async PS plan survives a 60 %-drop transport
    (FLAGS_pskv_fault_inject): every batch is delivered in the end.
"""

import time

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu_torch.distributed.elastic import (ElasticAgent,
                                                  ElasticController,
                                                  SyncElasticTrainer)
from paddle_tpu_torch.distributed.pskv import KVClient, KVServer
from torch_port_common import one_torch_thread  # noqa: F401


def _wait_for(pred, timeout=5.0):
    t0 = time.time()
    while not pred() and time.time() - t0 < timeout:
        time.sleep(0.02)
    return pred()


def test_join_beat_leave():
    ctrl = ElasticController(heartbeat_timeout=1.0)
    try:
        a = ElasticAgent("127.0.0.1", ctrl.port, "t0",
                         beat_interval=0.05).start()
        assert a.world_size() == 1
        b = ElasticAgent("127.0.0.1", ctrl.port, "t1",
                         beat_interval=0.05).start()
        assert _wait_for(lambda: a.world_size() == 2)
        v, n, members = a.world()
        assert (n, members) == (2, ["t0", "t1"])
        b.stop(leave=True)
        assert _wait_for(lambda: a.world_size() == 1)
        a.stop()
    finally:
        ctrl.close()


def test_crash_detected_by_timeout():
    ctrl = ElasticController(heartbeat_timeout=0.4)
    try:
        changes = []
        a = ElasticAgent("127.0.0.1", ctrl.port, "t0", beat_interval=0.05,
                         on_change=lambda o, n: changes.append((o, n))
                         ).start()
        b = ElasticAgent("127.0.0.1", ctrl.port, "t1",
                         beat_interval=0.05).start()
        assert _wait_for(lambda: (1, 2) in changes)
        b.stop(leave=False)          # a crash: the heartbeats just stop
        assert _wait_for(lambda: a.world_size() == 1)
        assert (2, 1) in changes
        a.stop()
    finally:
        ctrl.close()


def test_second_trainer_joins_async_ps():
    server = KVServer(port=0, trainers=1, sync=False)
    ctrl = ElasticController(heartbeat_timeout=2.0)
    clients, agents = [], []
    try:
        boot = KVClient("127.0.0.1", server.port)
        clients.append(boot)
        boot.create_dense("ew", 4, opt="sgd", lr=0.5)
        boot.init_dense("ew", np.zeros(4, np.float32))
        sizes = []
        agents.append(ElasticAgent(
            "127.0.0.1", ctrl.port, "t0", beat_interval=0.05,
            on_change=lambda o, n: sizes.append(n)).start())
        c1 = KVClient("127.0.0.1", server.port, trainer_id=0)
        clients.append(c1)
        g1 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        c1.push_dense("ew", g1)
        agents.append(ElasticAgent("127.0.0.1", ctrl.port, "t1",
                                   beat_interval=0.05).start())
        c2 = KVClient("127.0.0.1", server.port, trainer_id=1)
        clients.append(c2)
        np.testing.assert_array_equal(c2.pull_dense("ew", 4), -0.5 * g1)
        g2 = np.array([0.0, 2.0, 0.0, 0.0], np.float32)
        c2.push_dense("ew", g2)
        np.testing.assert_array_equal(c1.pull_dense("ew", 4),
                                      -0.5 * (g1 + g2))
        assert _wait_for(lambda: agents[0].world_size() == 2)
        assert 2 in sizes
    finally:
        for a in agents:
            a.stop()
        for c in clients:
            c.close()
        ctrl.close()
        server.stop()


def _plain_program(world_size):
    """A one-device fc regression, the same whatever the world size."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [4], dtype="float32")
        y = ptt.layers.data("y", [1], dtype="float32")
        pred = ptt.layers.fc(ptt.layers.fc(x, 8, act="tanh"), 1)
        loss = ptt.layers.mean(ptt.layers.square_error_cost(pred, y))
        ptt.optimizer.Adam(0.05).minimize(loss)
    main.random_seed = startup.random_seed = 3
    return main, main, startup, [loss]


def test_sync_elastic_trainer_keeps_state_across_rebuild(tmp_path):
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(6):
        x = rng.randn(8, 4).astype(np.float32)
        feeds.append({"x": x, "y": x.sum(1, keepdims=True)})

    def run(world):
        tr = SyncElasticTrainer(_plain_program, world,
                                str(tmp_path / f"ck{len(runs)}"),
                                executor=ptt.Executor(ptt.CPUPlace()))
        losses = [float(np.ravel(tr.step(f)[0])[0]) for f in feeds]
        return tr, losses

    runs = []
    steps = iter(range(100))
    # the world grows from 1 to 2 trainers before step 3
    runs.append(run(lambda: (0, 1) if next(steps) < 3 else (1, 2)))
    runs.append(run(lambda: (0, 1)))
    (resized, a), (steady, b) = runs
    assert resized.resizes == 1 and resized.world_size == 2
    assert steady.resizes == 0
    assert a == b


def test_async_communicator_survives_drops(monkeypatch):
    """Async PS with a 60 %-drop push transport: the Communicator's retry
    loop delivers every batch (tests/test_elastic.py's chaos case)."""
    from paddle_tpu_torch.transpiler import DistributeTranspiler
    srv = KVServer(port=0, trainers=1, sync=False)
    plan = None
    try:
        main, startup = ptt.Program(), ptt.Program()
        with ptt.unique_name_guard(), ptt.program_guard(main, startup):
            x = ptt.layers.data("fx", [4], dtype="float32")
            y = ptt.layers.data("fy", [1], dtype="float32")
            pred = ptt.layers.fc(x, 1, bias_attr=False)
            loss = ptt.layers.mean(ptt.layers.square(pred - y))
            ptt.optimizer.SGD(0.1).minimize(loss)
        DistributeTranspiler().transpile(
            trainer_id=0, trainers=1, pservers=f"127.0.0.1:{srv.port}",
            sync_mode=False, program=main)
        plan = main._ps_plan
        monkeypatch.setenv("FLAGS_pskv_fault_inject", "drop=0.6,seed=3,"
                           "ops=push")
        exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
        rng = np.random.RandomState(0)
        exe.run(startup, scope=scope)
        comm = plan.start_communicator(scope, send_wait_ms=2,
                                       recv_interval_ms=5)
        for step in range(6):
            xv = rng.randn(8, 4).astype(np.float32)
            exe.run(main, feed={"fx": xv, "fy": xv.sum(1, keepdims=True)},
                    fetch_list=[loss], scope=scope)
            # each step's batch through the send thread's retry loop (a
            # fast step would otherwise leave every batch to stop()'s
            # flush, whose retries record no error)
            assert _wait_for(lambda: comm.sent_batches > step)
        comm.stop()             # flushes what is still queued
        assert comm.sent_batches > 0 and comm.last_error is not None
        probe = KVClient("127.0.0.1", srv.port)
        spec = plan.specs[0]
        assert float(np.abs(probe.pull_dense(spec.name,
                                             spec.size)).sum()) > 0
        probe.close()
    finally:
        if plan is not None:
            plan._communicator = None
            plan.shutdown()
        srv.stop()
