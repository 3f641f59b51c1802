"""The port's pskv service (paddle_tpu_torch/distributed/pskv.py over its
own copy of the C++ server) against the JAX package's, on loopback.

  * the same op sequence (create, init, pushes, set_lr, pulls; dense and
    sparse; sgd, adagrad and adam; rows materialized from init_scale and
    seed) gives bitwise the same pulls for every pairing of client and
    server package: port/port, port client on a JAX server, JAX client on
    a port server, and JAX/JAX;
  * a checkpoint the port's server writes loads into the JAX server and
    the other way round; a truncated file is rejected and leaves the live
    tables untouched; the server survives it;
  * the fault injector (FLAGS_pskv_fault_inject) drops and rejects bad
    specs; a sync round times out on a dead trainer and rolls back;
    stop() with an open connection returns; run_pserver exits on shutdown;
  * the library is built into paddle_tpu_torch/ops/_build/, named by a hash
    of its source, and PADDLE_TPU_SANITIZE picks the sanitizer flags.
Every test stops its servers and closes its clients.
"""

import os
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import pskv as jpskv
from paddle_tpu_torch import native_loader
from paddle_tpu_torch.distributed import pskv as tpskv
from torch_port_common import one_torch_thread  # noqa: F401


PKGS = {"port": tpskv, "jax": jpskv}


def _op_sequence(client_pkg, server_pkg, opt, sparse):
    """One op sequence on a fresh server; returns every pull."""
    srv = PKGS[server_pkg].KVServer(port=0, trainers=1, sync=True)
    c = PKGS[client_pkg].KVClient("127.0.0.1", srv.port)
    rng = np.random.RandomState(3)
    pulls = []
    try:
        if sparse:
            c.create_sparse("emb", 4, opt=opt, lr=0.1, init_scale=0.05,
                            seed=11)
            c.init_sparse("emb", np.array([1, 5, 9]),
                          rng.randn(3, 4).astype(np.float32))
            for step in range(3):
                ids = np.array([1, 2, 5, 5, 40 + step], np.int64)
                c.push_sparse("emb", ids, rng.randn(5, 4).astype(np.float32))
                if step == 1:
                    c.set_lr("emb", 0.03)
                pulls.append(c.pull_sparse("emb", np.arange(50), 4))
        else:
            c.create_dense("w", 6, opt=opt, lr=0.1)
            c.init_dense("w", rng.randn(6).astype(np.float32))
            for step in range(3):
                c.push_dense("w", rng.randn(6).astype(np.float32))
                if step == 1:
                    c.set_lr("w", 0.03)
                pulls.append(c.pull_dense("w", 6))
    finally:
        c.close()
        srv.stop()
    return np.stack(pulls)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_round_trip_bitwise_across_packages(opt, sparse):
    ref = _op_sequence("jax", "jax", opt, sparse)
    assert np.isfinite(ref).all() and not (ref[0] == ref[-1]).all()
    for client, server in (("port", "port"), ("port", "jax"),
                           ("jax", "port")):
        np.testing.assert_array_equal(
            _op_sequence(client, server, opt, sparse), ref,
            err_msg=f"{client} client, {server} server")


def test_pull_into_caller_buffer():
    srv = tpskv.KVServer(port=0, trainers=1, sync=True)
    c = tpskv.KVClient("127.0.0.1", srv.port)
    try:
        c.create_dense("w", 4, opt="sgd", lr=1.0)
        c.init_dense("w", np.arange(4, dtype=np.float32))
        out = np.zeros(4, np.float32)
        assert c.pull_dense("w", 4, out=out) is out
        np.testing.assert_array_equal(out, np.arange(4))
        c.create_sparse("e", 2, opt="sgd", lr=1.0)
        c.init_sparse("e", np.array([3]), np.array([[1.0, 2.0]]))
        rows = np.zeros((1, 2), np.float32)
        c.pull_sparse("e", np.array([3]), 2, out=rows)
        np.testing.assert_array_equal(rows, [[1.0, 2.0]])
        with pytest.raises(ValueError, match="C-contiguous float32"):
            c.pull_dense("w", 4, out=np.zeros(4, np.float64))
    finally:
        c.close()
        srv.stop()


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_checkpoint_crosses_packages(tmp_path, writer, reader):
    """A shard checkpoint (tables and optimizer state) written by one
    package's server restores in the other's: the next adam step is
    bitwise the writer's."""
    path = str(tmp_path / "shard-0.pskv")
    results = []
    for pkg, load in ((writer, False), (reader, True)):
        srv = PKGS[pkg].KVServer(port=0, trainers=1, sync=True)
        c = PKGS[pkg].KVClient("127.0.0.1", srv.port)
        try:
            c.create_dense("w", 8, opt="adam", lr=0.1)
            c.create_sparse("e", 3, opt="adam", lr=0.1)
            if load:
                c.load_checkpoint(path)
            else:
                c.init_dense("w", np.arange(8, dtype=np.float32))
                c.init_sparse("e", np.arange(4),
                              np.ones((4, 3), np.float32))
                c.push_dense("w", np.ones(8, np.float32))
                c.push_sparse("e", np.array([0, 2]),
                              np.ones((2, 3), np.float32))
                c.save_checkpoint(path)
            c.push_dense("w", np.full(8, 0.5, np.float32))
            c.push_sparse("e", np.array([2, 3]),
                          np.full((2, 3), 0.5, np.float32))
            results.append((c.pull_dense("w", 8),
                            c.pull_sparse("e", np.arange(4), 3)))
        finally:
            c.close()
            srv.stop()
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)


def test_truncated_checkpoint_rejected_tables_untouched(tmp_path):
    srv = tpskv.KVServer(port=0, trainers=1, sync=True)
    c = tpskv.KVClient("127.0.0.1", srv.port)
    try:
        c.create_dense("a", 4, opt="adam", lr=0.1)
        c.create_dense("b", 4, opt="sgd", lr=0.1)
        c.init_dense("a", np.ones(4, np.float32))
        c.init_dense("b", 2 * np.ones(4, np.float32))
        path = str(tmp_path / "ck.pskv")
        c.save_checkpoint(path)
        c.load_checkpoint(path)          # an intact file loads
        c.init_dense("a", 5 * np.ones(4, np.float32))
        c.init_dense("b", 6 * np.ones(4, np.float32))
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(blob[: len(blob) // 2])
        with pytest.raises(RuntimeError, match="load_checkpoint"):
            c.load_checkpoint(path)
        np.testing.assert_array_equal(c.pull_dense("a", 4), 5.0)
        np.testing.assert_array_equal(c.pull_dense("b", 4), 6.0)
    finally:
        c.close()
        srv.stop()


def test_fault_injector(monkeypatch):
    srv = tpskv.KVServer(port=0, trainers=1, sync=False)
    boot = tpskv.KVClient("127.0.0.1", srv.port)
    faulty = None
    try:
        boot.create_dense("fw", 2, opt="sgd", lr=1.0)
        boot.init_dense("fw", np.zeros(2, np.float32))
        monkeypatch.setenv("FLAGS_pskv_fault_inject", "drop=1.0,seed=0")
        faulty = tpskv.KVClient("127.0.0.1", srv.port)
        with pytest.raises(ConnectionError, match="fault injection"):
            faulty.push_dense("fw", np.ones(2, np.float32))
        with pytest.raises(ConnectionError):
            faulty.pull_dense("fw", 2)
        np.testing.assert_array_equal(boot.pull_dense("fw", 2), 0.0)
        monkeypatch.setenv("FLAGS_pskv_fault_inject", "drop=0.5,seed=4,"
                           "ops=push")
        # the same seeded stream of drops as the JAX package's injector
        for pkg in (tpskv, jpskv):
            pkg._FaultInjector._streams.pop(4, None)
        draws = []
        for pkg in (tpskv, jpskv):
            inj = pkg._FaultInjector()
            got = []
            for _ in range(16):
                try:
                    inj.maybe_fault("push_dense")
                    got.append(0)
                except ConnectionError:
                    got.append(1)
            inj.maybe_fault("pull_dense")   # filtered out by ops=push
            draws.append(got)
        assert draws[0] == draws[1] and 0 < sum(draws[0]) < 16
        monkeypatch.setenv("FLAGS_pskv_fault_inject", "chaos=1")
        with pytest.raises(ValueError, match="unknown key"):
            tpskv._FaultInjector()
    finally:
        for pkg in (tpskv, jpskv):      # the seeded streams are per process
            pkg._FaultInjector._streams.pop(4, None)
        for c in (boot, faulty):
            if c is not None:
                c.close()
        srv.stop()


def test_sync_round_timeout_detects_dead_trainer():
    """A crashed trainer does not hang the sync round: the waiting push
    fails after sync_timeout_ms and is rolled back."""
    srv = tpskv.KVServer(port=0, trainers=2, sync=True, sync_timeout_ms=300)
    c0 = tpskv.KVClient("127.0.0.1", srv.port, trainer_id=0)
    c1 = tpskv.KVClient("127.0.0.1", srv.port, trainer_id=1)
    try:
        c0.create_dense("w", 4, opt="sgd", lr=1.0)
        c0.init_dense("w", np.zeros(4, np.float32))
        t0 = time.time()
        with pytest.raises(RuntimeError, match="push_dense"):
            c0.push_dense("w", np.ones(4, np.float32))
        assert 0.2 < time.time() - t0 < 5
        th = threading.Thread(
            target=lambda: c1.push_dense("w", 3 * np.ones(4, np.float32)))
        th.start()
        c0.push_dense("w", np.ones(4, np.float32))
        th.join(timeout=10)
        assert not th.is_alive()
        np.testing.assert_array_equal(c0.pull_dense("w", 4), -2.0)
    finally:
        c0.close()
        c1.close()
        srv.stop()


def test_stop_with_open_connection_and_run_pserver_shutdown():
    from paddle_tpu_torch.transpiler.distribute_transpiler import (
        PServerSpec, run_pserver)
    srv = tpskv.KVServer(port=0, trainers=1, sync=True)
    c = tpskv.KVClient("127.0.0.1", srv.port)
    c.create_dense("w", 2, opt="sgd", lr=0.1)
    t0 = time.time()
    srv.stop()      # the handler of the open connection is unblocked
    assert time.time() - t0 < 5 and srv.stopped()
    c.close()

    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    th = threading.Thread(target=run_pserver, args=(PServerSpec(
        endpoint=f"127.0.0.1:{port}", trainers=1, sync_mode=True),))
    th.start()
    for _ in range(50):
        try:
            c = tpskv.KVClient("127.0.0.1", port)
            break
        except ConnectionError:
            time.sleep(0.05)
    c.shutdown_server()
    c.close()
    th.join(timeout=10)
    assert not th.is_alive()


def test_library_built_into_ops_build_by_source_hash(monkeypatch):
    lib = tpskv.load_lib()
    path = tpskv.library_path()
    assert lib._name == path
    assert os.path.dirname(path).endswith(os.path.join(
        "paddle_tpu_torch", "ops", "_build"))
    assert os.path.basename(path).startswith("pskv-")
    monkeypatch.setenv("PADDLE_TPU_SANITIZE", "address,undefined")
    flags, suffix = native_loader._sanitize_flags()
    assert "-fsanitize=address" in flags and suffix == ".address_undefined"
    for bad in ("memory", "address,thread"):
        monkeypatch.setenv("PADDLE_TPU_SANITIZE", bad)
        with pytest.raises(ValueError, match="PADDLE_TPU_SANITIZE"):
            native_loader._sanitize_flags()
