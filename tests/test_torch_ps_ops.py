"""The parameter-server op types of the PyTorch port against the JAX
package's, on the CPU (mirrors tests/test_io_dist_reader_ops.py):

  * the six PS device ops (fake_init, split_byref, split_ids, merge_ids,
    ref_by_trainer_id, lookup_sparse_table) on the same inputs: outputs
    equal; merge_ids', ref_by_trainer_id's and lookup_sparse_table's
    gradients within 5e-3 relative L2 (op_test's);
  * the RPC host ops over a loopback server of each package: send (dense
    and SelectedRows), send_barrier, recv and prefetch pull the same
    values; recv and prefetch put them on the executor's device;
    checkpoint_notify writes the shard; gen_nccl_id / c_gen_nccl_id write
    an int32 zero; fl_listen_and_serv and listen_and_serv serve pushes
    until a client sends shutdown;
  * create_ctr_reader's batches equal JAX's for svm, csv and gzip files;
    the port's reader keeps its place across runs and starts a new epoch
    after the EOFError.
Every test stops its servers and closes the RPC ops' clients.
"""

import gzip
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.distributed.pskv import KVServer as JKVServer
from paddle_tpu.ops import io_dist_ops as jio
from paddle_tpu.ops import reader_ops as jreader
from paddle_tpu_torch.distributed.pskv import KVClient, KVServer
from paddle_tpu_torch.framework.selected_rows import SelectedRows
from paddle_tpu_torch.ops import io_dist_ops as tio
from test_dist_ps import _free_port
from test_torch_loss_metrics import _rel_l2
from torch_port_common import one_torch_thread  # noqa: F401


GRAD_L2 = 5e-3


@pytest.fixture(autouse=True)
def _close_rpc_clients():
    """The RPC ops cache a client an endpoint in each package's module:
    close them so no socket outlives its test."""
    yield
    tio.close_clients()
    for c in jio._CLIENTS.values():
        c.close()
    jio._CLIENTS.clear()


def _op_run(pkg, op_type, ins, n_out, attrs, grad_wrt=()):
    """One op over fed inputs (a list input is duplicable), its outputs
    fetched; with `grad_wrt`, the gradients of mean(sum of outputs) with
    respect to those input slots' first vars after them."""
    main, startup = pkg.Program(), pkg.Program()
    feed, in_map = {}, {}
    with pkg.program_guard(main, startup):
        blk = main.global_block
        for slot, arr in ins.items():
            arrs = arr if isinstance(arr, list) else [arr]
            names = []
            for i, a in enumerate(arrs):
                nm = f"{op_type}_{slot}{i}"
                v = blk.create_var(name=nm, shape=list(a.shape),
                                   dtype=str(a.dtype))
                v.stop_gradient = slot not in grad_wrt
                feed[nm] = a
                names.append(nm)
            in_map[slot] = names
        outs = [blk.create_var(name=f"{op_type}_Out{i}", dtype="float32")
                for i in range(n_out)]
        blk.append_op(op_type, in_map, {"Out": [o.name for o in outs]},
                      attrs, infer_shape=bool(grad_wrt))
        fetch = [o.name for o in outs]
        if grad_wrt:
            loss = pkg.layers.mean(outs[0])
            pkg.append_backward(loss)
            fetch += [in_map[s][0] + "@GRAD" for s in grad_wrt]
    if pkg is pt:
        with pt.scope_guard(pt.Scope()):
            return [np.asarray(r) for r in pt.Executor().run(
                main, feed=feed, fetch_list=fetch)]
    return ptt.Executor(ptt.CPUPlace()).run(main, feed=feed,
                                            fetch_list=fetch,
                                            scope=ptt.Scope())


CASES = {
    "fake_init": ({}, 1, {"shape": [2, 3], "dtype": "float32"}, ()),
    "split_byref": ({"X": np.arange(10, dtype=np.float32).reshape(5, 2)},
                    2, {"sections": [2, 3]}, ()),
    "split_byref_num": ({"X": np.arange(12, dtype=np.float32)
                         .reshape(6, 2)}, 3, {"num": 3}, ()),
    "split_ids": ({"Ids": np.array([4, 1, 6, 3, 9], np.int64)}, 3,
                  {"num": 3}, ()),
    "merge_ids": ({"Ids": np.array([4, 1, 6, 3], np.int64),
                   "Rows": [np.array([4, -1, 6, -1], np.int64),
                            np.array([-1, 1, -1, 3], np.int64)],
                   "X": [np.random.RandomState(0).randn(4, 3)
                         .astype(np.float32),
                         np.random.RandomState(1).randn(4, 3)
                         .astype(np.float32)]}, 1, {}, ("X",)),
    "ref_by_trainer_id": ({"X": [np.full((2,), float(i), np.float32) + i
                                 for i in range(3)],
                           "TrainerId": np.array([2], np.int64)}, 1, {},
                          ("X",)),
    "lookup_sparse_table": ({"W": np.arange(20, dtype=np.float32)
                             .reshape(5, 4),
                             "Ids": np.array([[1], [3], [7], [0]],
                                             np.int64)}, 1,
                            {"padding_idx": 0}, ("W",)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ps_device_op_equals_jax(case):
    ins, n_out, attrs, wrt = CASES[case]
    op_type = case.replace("_num", "")
    jres = _op_run(pt, op_type, ins, n_out, attrs, wrt)
    tres = _op_run(ptt, op_type, ins, n_out, attrs, wrt)
    for i in range(n_out):
        np.testing.assert_array_equal(tres[i], jres[i], err_msg=case)
    for i in range(n_out, len(jres)):
        assert _rel_l2(tres[i], jres[i]) <= GRAD_L2, case


def _rpc_program(pkg, op_type, ins, outs, attrs, shapes):
    p = pkg.Program()
    blk = p.global_block
    for n, s in shapes.items():
        blk.create_var(name=n, shape=s, dtype="float32", persistable=True)
    blk.append_op(op_type, ins, outs, attrs, infer_shape=False)
    return p


def _rpc_round(pkg, server_cls):
    """send (dense, then SelectedRows), send_barrier, recv and prefetch
    against a fresh async server of `server_cls`; returns the pulled
    values as numpy, and the places recv and prefetch put them on."""
    srv = server_cls(port=0, trainers=1, sync=False)
    ep = f"127.0.0.1:{srv.port}"
    boot = KVClient("127.0.0.1", srv.port)
    try:
        boot.create_dense("psw", 4, opt="sgd", lr=1.0)
        boot.init_dense("psw", np.zeros(4, np.float32))
        boot.create_sparse("emb", 3, opt="sgd", lr=0.5)
        boot.init_sparse("emb", np.arange(6), np.ones((6, 3), np.float32))
        grad = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
        rows = np.array([1, 4, 1], np.int64)
        vals = np.arange(9, dtype=np.float32).reshape(3, 3)
        ids = np.array([[1], [4], [5]], np.int64)
        send = _rpc_program(pkg, "send", {"X": ["psw"]}, {},
                            {"epmap": [ep]}, {"psw": [4]})
        send_sr = _rpc_program(pkg, "send", {"X": ["emb"]}, {},
                               {"epmap": [ep]}, {"emb": [6, 3]})
        barrier = _rpc_program(pkg, "send_barrier", {}, {},
                               {"endpoints": [ep]}, {})
        recv = _rpc_program(pkg, "recv", {}, {"Out": ["psw"]},
                            {"epmap": [ep]}, {"psw": [4]})
        prefetch = _rpc_program(pkg, "prefetch", {"X": ["ids"]},
                                {"Out": ["rows"]},
                                {"epmap": [ep], "table_names": ["emb"]},
                                {"rows": [-1, 3]})
        if pkg is pt:
            exe, scope = pt.Executor(), pt.Scope()
            with pt.scope_guard(scope):
                scope.set_var("psw", grad)
                exe.run(send)
                scope.set_var("emb", pt.framework.selected_rows
                              .SelectedRows(rows, vals, 6))
                exe.run(send_sr)
                exe.run(barrier)
                exe.run(recv)
                exe.run(prefetch, feed={"ids": ids})
                got = [np.asarray(scope.find_var(n))
                       for n in ("psw", "rows")]
            places = None
        else:
            exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
            scope.set_var("psw", torch.from_numpy(grad))
            exe.run(send, scope=scope)
            scope.set_var("emb", SelectedRows(torch.from_numpy(rows),
                                              torch.from_numpy(vals), 6))
            exe.run(send_sr, scope=scope)
            exe.run(barrier, scope=scope)
            exe.run(recv, scope=scope)
            exe.run(prefetch, feed={"ids": ids}, scope=scope)
            got = [scope.get_numpy(n) for n in ("psw", "rows")]
            places = {scope.find_var(n).device.type for n in ("psw", "rows")}
        return got, places
    finally:
        boot.close()
        srv.stop()


def test_rpc_ops_pull_the_jax_ops_values():
    jgot, _ = _rpc_round(pt, JKVServer)
    tgot, places = _rpc_round(ptt, KVServer)
    np.testing.assert_array_equal(jgot[0], -np.array([1.0, -2.0, 3.0, 0.5]))
    for a, b in zip(tgot, jgot):
        np.testing.assert_array_equal(a, b)
    assert places == {"cpu"}


def test_checkpoint_notify_and_gen_nccl_id(tmp_path):
    srv = KVServer(port=0, trainers=1, sync=True)
    boot = KVClient("127.0.0.1", srv.port)
    try:
        boot.create_dense("w", 2, opt="sgd", lr=0.1)
        path = str(tmp_path / "shard.pskv")
        p = _rpc_program(ptt, "checkpoint_notify", {}, {},
                         {"epmap": [f"127.0.0.1:{srv.port}"], "dir": path},
                         {})
        ptt.Executor(ptt.CPUPlace()).run(p, scope=ptt.Scope())
        boot.load_checkpoint(path)
    finally:
        boot.close()
        srv.stop()
    for op_type in ("gen_nccl_id", "c_gen_nccl_id"):
        p = ptt.Program()
        p.global_block.create_var(name="nccl_id", shape=[1], dtype="int32",
                                  persistable=True)
        p.global_block.append_op(op_type, {}, {"Out": ["nccl_id"]}, {},
                                 infer_shape=False)
        scope = ptt.Scope()
        ptt.Executor(ptt.CPUPlace()).run(p, scope=scope)
        v = scope.find_var("nccl_id")
        assert v.dtype == torch.int32 and v.tolist() == [0]


@pytest.mark.parametrize("op_type", ["fl_listen_and_serv",
                                     "listen_and_serv"])
def test_listen_op_serves_pushes_until_shutdown(op_type):
    """The serving op blocks in Executor.run, serving pushes from two
    clients (async for fl_listen_and_serv, tests/
    test_io_dist_reader_ops.py's; sync_mode False for listen_and_serv),
    and returns on shutdown."""
    port = _free_port()
    prog = ptt.Program()
    attrs = {"endpoint": f"127.0.0.1:{port}", "Fanin": 2}
    if op_type == "listen_and_serv":
        attrs["sync_mode"] = False
    prog.global_block.append_op(op_type, {}, {}, attrs, infer_shape=False)
    exe = ptt.Executor(ptt.CPUPlace())
    th = threading.Thread(target=lambda: exe.run(prog, scope=ptt.Scope()),
                          daemon=True)
    th.start()
    c1 = None
    for _ in range(100):
        try:
            c1 = KVClient("127.0.0.1", port, trainer_id=0)
            break
        except ConnectionError:
            time.sleep(0.05)
    assert c1 is not None, "the server did not come up"
    c2 = KVClient("127.0.0.1", port, trainer_id=1)
    try:
        c1.create_dense("flw", 3, opt="sgd", lr=1.0)
        c1.init_dense("flw", np.zeros(3, np.float32))
        c1.push_dense("flw", np.array([1.0, 0, 0], np.float32))
        c2.push_dense("flw", np.array([0, 2.0, 0], np.float32))
        np.testing.assert_array_equal(c1.pull_dense("flw", 3),
                                      [-1.0, -2.0, 0.0])
        c1.shutdown_server()
        th.join(timeout=10)
        assert not th.is_alive(), f"{op_type} did not exit"
    finally:
        c1.close()
        c2.close()


def _write_ctr(path, fmt, gz, n=7):
    rng = np.random.RandomState(5)
    lines = []
    for i in range(n):
        if fmt == "svm":
            toks = [f"{rng.choice(['101', '102', '103'])}:"
                    f"{rng.randint(1, 99)}" for _ in range(rng.randint(1, 5))]
            lines.append(f"{i % 2} " + " ".join(toks))
        else:
            ids = rng.randint(1, 99, rng.randint(2, 7))
            lines.append(",".join([str(i % 2)] + [str(v) for v in ids]))
    data = "\n".join(lines) + "\n"
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        with open(path, "w") as f:
            f.write(data)


def _ctr_op(pkg, path, fmt, gz):
    p = pkg.Program()
    blk = p.global_block
    blk.create_var(name="ctr_reader", shape=None, dtype="float32")
    blk.append_op("create_ctr_reader", {}, {"Out": ["ctr_reader"]},
                  {"file_list": [path], "sparse_slots": ["101", "102"],
                   "batch_size": 3, "file_format": fmt,
                   "file_type": "gzip" if gz else "plain",
                   "out_names": ["lbl", "s101", "s102"]},
                  infer_shape=False)
    return p, blk.ops[0]


@pytest.mark.parametrize("fmt,gz", [("svm", False), ("csv", False),
                                    ("svm", True)])
def test_ctr_reader_batches_equal_jax(tmp_path, fmt, gz):
    path = str(tmp_path / ("ctr.txt.gz" if gz else "ctr.txt"))
    _write_ctr(path, fmt, gz)
    # JAX: the reader its create op puts into the scope, drained
    jp, jop = _ctr_op(pt, path, fmt, gz)
    jscope = pt.Scope()
    jreader._create_ctr_reader(jop, jscope, {})
    want = []
    while True:
        b = jscope.find_var("ctr_reader").pop()
        if b is None:
            break
        want.append([np.asarray(b[n]) for n in ("lbl", "s101", "s102")])
    assert len(want) == 3           # 7 lines in batches of 3
    # the port: a program whose prefix is create_ctr_reader -> read, one
    # batch a run; the EOFError ends the epoch and the next run starts
    # the next one
    tp, _ = _ctr_op(ptt, path, fmt, gz)
    blk = tp.global_block
    for n in ("lbl", "s101", "s102"):
        blk.create_var(name=n, shape=[-1, -1], dtype="int64")
    blk.append_op("read", {"Reader": ["ctr_reader"]},
                  {"Out": ["lbl", "s101", "s102"]}, {}, infer_shape=False)
    blk.create_var(name="lblf", shape=[-1, -1], dtype="float32")
    blk.append_op("cast", {"X": ["lbl"]}, {"Out": ["lblf"]},
                  {"in_dtype": "int64", "out_dtype": "float32"},
                  infer_shape=False)
    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    for epoch in range(2):
        got = []
        for _ in range(len(want)):
            got.append(exe.run(tp, fetch_list=["lblf", "s101", "s102"],
                               scope=scope))
        with pytest.raises(EOFError):
            exe.run(tp, fetch_list=["lblf"], scope=scope)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0].astype(np.float32))
            np.testing.assert_array_equal(g[1], w[1])
            np.testing.assert_array_equal(g[2], w[2])
