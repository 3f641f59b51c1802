"""Host-boundary ops and IO of the PyTorch port against the JAX package's,
on the CPU.

  * `register_host_op` and the executor's host prefix and suffix: a load
    in the prefix feeds the step, a save in the suffix reads the updated
    (donated) values, a host op between compute ops raises JAX's message,
    a host-only program runs its host ops alone, each under a
    `host/<type>` span; the scope split (`classify_persistables`) equals
    JAX's; every JAX host op type is a port host op;
  * the save/load ops (save, load, save_combine, load_combine and
    `layers.load`): files written by either package load in the other,
    bitwise, fp16 saves included;
  * `framework/fluid_interop.py`: the cases of tests/test_fluid_interop.py
    through the port (the independent protobuf decoder, golden tensor
    streams) and the same bytes as JAX's for the same program and arrays;
  * `io.py`'s whole surface in both formats: inference models, per-var and
    combined files, `save_params`/`load_params`, the async save (step
    consistent under donation, atomic, ordered, failures surfaced), the
    feed/fetch wrappers and the parameter getters; a directory either
    package saves loads in the other with bitwise equal values, and the
    Fluid files and native program bytes are equal to the byte.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import fluid_interop as jfi
from paddle_tpu_torch.framework import fluid_interop as tfi
from test_fluid_interop import ProgramDescM, TensorDescM
from test_torch_gpt_inference import _program_dict
from torch_port_common import one_torch_thread  # noqa: F401


def _texe():
    return ptt.Executor(ptt.CPUPlace())


def _toy(pkg, optimizer=False):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4])
        h = pkg.layers.fc(x, 8, act="relu")
        out = pkg.layers.fc(h, 3, act="softmax")
        loss = None
        if optimizer:
            y = pkg.layers.data("y", [3])
            loss = pkg.layers.mean(pkg.layers.square_error_cost(out, y))
            pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, out, loss


def _jax_values(main, startup):
    exe = pt.Executor()
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        sc = pt.global_scope()
        return {v.name: np.asarray(sc.find_var(v.name))
                for v in main.list_vars() if v.persistable
                and sc.find_var(v.name) is not None}


def _x(seed=0, b=5):
    return np.random.RandomState(seed).rand(b, 4).astype(np.float32)


# ---------------------------------------------------------------------------
# the executor's host prefix and suffix
# ---------------------------------------------------------------------------

def test_register_host_op_signature_and_registry():
    from paddle_tpu.framework import registry as jreg
    from paddle_tpu_torch.framework import registry as treg
    for name in ("save", "load", "save_combine", "load_combine",
                 "create_py_reader", "create_double_buffer_reader",
                 "create_custom_reader", "read"):
        assert name in treg._HOST_OPS and name in jreg._HOST_OPS
        d = treg.get_op_def(name)
        assert d.not_differentiable and d.grad_free and d.lower is None
    calls = []

    @treg.register_host_op("_test_host_op", aliases=("_test_host_alias",))
    def _fn(op, scope, feed, device):
        calls.append((op.type, device))
    try:
        p = ptt.Program()
        p.global_block.append_op("_test_host_alias", {}, {}, {},
                                 infer_shape=False)
        _texe().run(p)
        assert calls == [("_test_host_alias", ptt.CPUPlace.device)]
    finally:
        for n in ("_test_host_op", "_test_host_alias"):
            treg._HOST_OPS.pop(n)
            treg._REGISTRY.pop(n)


def _load_then_fc(pkg, path):
    """A program whose prefix loads a weight that the step then reads."""
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        blk = main.global_block
        w = blk.create_var(name="lw", shape=[4, 3], dtype="float32",
                           persistable=True)
        pkg.layers.load(w, path)
        x = pkg.layers.data("x", [4])
        out = pkg.layers.matmul(x, w)
    return main, out


def test_load_prefix_feeds_the_step_in_both_packages(tmp_path):
    w = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    path = str(tmp_path / "lw.npy")
    np.save(path, w)
    x = _x()
    outs = []
    main, out = _load_then_fc(pt, path)
    with pt.scope_guard(pt.Scope()):
        outs.append(np.asarray(pt.Executor().run(main, feed={"x": x},
                                                 fetch_list=[out])[0]))
    main, out = _load_then_fc(ptt, path)
    sc = ptt.Scope()
    outs.append(_texe().run(main, feed={"x": x}, fetch_list=[out],
                            scope=sc)[0])
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(sc.get_numpy("lw"), w)


def _train_with_suffix_save(pkg, path):
    main, startup, out, loss = _toy(pkg, optimizer=True)
    blk = main.global_block
    names = sorted(p.name for p in main.all_parameters())
    blk.append_op("save_combine", {"X": names}, {}, {"file_path": path},
                  infer_shape=False)
    return main, startup, loss, names


def test_suffix_save_reads_post_update_values_under_donation(tmp_path):
    """A save_combine after the last compute op writes the values after
    this step's in-place (donated) updates, equal to JAX's suffix save."""
    rng = np.random.RandomState(2)
    feeds = [{"x": rng.rand(6, 4).astype(np.float32),
              "y": rng.rand(6, 3).astype(np.float32)} for _ in range(3)]
    saved = {}
    for pkg in (pt, ptt):
        path = str(tmp_path / f"{pkg.__name__}.npz")
        main, startup, loss, names = _train_with_suffix_save(pkg, path)
        init = _jax_values(*_toy(pt, optimizer=True)[:2])
        if pkg is pt:
            exe = pt.Executor()
            with pt.scope_guard(pt.Scope()):
                for k, v in init.items():
                    pt.global_scope().set_var(k, v)
                for f in feeds:
                    exe.run(main, feed=f, fetch_list=[loss])
                after = {n: np.asarray(pt.global_scope().find_var(n))
                         for n in names}
        else:
            exe, sc = ptt.Executor(ptt.CPUPlace(), donate=True), ptt.Scope()
            ptt.io.set_params_from_numpy(sc, init, "cpu")
            for i, f in enumerate(feeds):
                exe.run(main, feed=f, fetch_list=[loss], scope=sc)
                if i == 1:
                    ptrs = {n: sc.find_var(n).data_ptr() for n in names}
            # the step wrote in place, and the save still read the update
            assert all(sc.find_var(n).data_ptr() == ptrs[n] for n in names)
            after = {n: sc.get_numpy(n) for n in names}
        with np.load(path) as z:
            saved[pkg.__name__] = {n: z[n] for n in names}
        for n in names:
            np.testing.assert_array_equal(saved[pkg.__name__][n], after[n])
    for n in saved["paddle_tpu"]:
        np.testing.assert_allclose(saved["paddle_tpu_torch"][n],
                                   saved["paddle_tpu"][n], rtol=1e-5,
                                   atol=1e-6)


def test_host_op_between_compute_ops_raises_as_jax():
    msgs = []
    for pkg, exe in ((pt, pt.Executor()), (ptt, _texe())):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            x = pkg.layers.data("x", [4])
            y = pkg.layers.scale(x, 2.0)
            main.global_block.append_op("save", {"X": [y.name]}, {},
                                        {"file_path": "/dev/null"},
                                        infer_shape=False)
            pkg.layers.scale(y, 3.0)
        with pytest.raises(RuntimeError) as e:
            exe.run(main, feed={"x": _x()}, scope=pkg.Scope())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "between compute ops" in msgs[1]


def test_host_only_programs_save_and_load(tmp_path):
    """A save program and a load program (no compute op) run their host
    ops and nothing else; no compile-cache entry is made."""
    val = np.arange(12, dtype=np.float32).reshape(3, 4)
    path = str(tmp_path / "w.bin")
    save_p, load_p = ptt.Program(), ptt.Program()
    save_p.global_block.create_var(name="w", shape=[3, 4], dtype="float32",
                                   persistable=True)
    save_p.global_block.append_op("save", {"X": ["w"]}, {},
                                  {"file_path": path}, infer_shape=False)
    load_p.global_block.create_var(name="w2", shape=[3, 4],
                                   dtype="float32", persistable=True)
    load_p.global_block.append_op("load", {}, {"Out": ["w2"]},
                                  {"file_path": path}, infer_shape=False)
    exe, sc = _texe(), ptt.Scope()
    sc.set_var("w", torch.from_numpy(val))
    exe.run(save_p, scope=sc)
    got, = exe.run(load_p, fetch_list=["w2"], scope=sc)
    np.testing.assert_array_equal(got, val)
    assert exe.compile_count == 0
    assert os.path.exists(path + ".npy")     # np.save's suffix, as JAX


def test_host_spans_and_classification_match_jax(tmp_path):
    from paddle_tpu.framework.executor import classify_persistables as jcls
    from paddle_tpu_torch.framework.executor import (
        classify_persistables as tcls)
    from paddle_tpu_torch.observability import tracer
    path = str(tmp_path / "s.npz")
    jm = _train_with_suffix_save(pt, path)[0]
    tm, tstart, loss, _ = _train_with_suffix_save(ptt, path)
    feeds = {"x", "y"}
    assert jcls(jm, feeds, [loss.name]) == tcls(tm, feeds, [loss.name])
    exe, sc = _texe(), ptt.Scope()
    exe.run(tstart, scope=sc)
    was = tracer.tracing_enabled()
    t = tracer.enable_tracing()
    try:
        t.clear()
        exe.run(tm, feed={"x": _x(b=2), "y": _x(b=2)[:, :3]},
                fetch_list=[loss], scope=sc)
        spans = [s for s in t.snapshot() if s.name == "host/save_combine"]
    finally:
        t.clear()
        if not was:
            tracer.disable_tracing()
    assert len(spans) == 1 and spans[0].cat == "host"


def test_unported_host_ops_raise_naming_a9():
    """Checks that every host op type of the JAX package is a host op of
    the port, and that gen_nccl_id runs and writes an int32 zero. The name
    is the one this test had when it held the NotImplementedError naming
    A.9 that the RPC ops and create_ctr_reader raised before the parameter
    server came; it is kept so the test's history stays one line."""
    from paddle_tpu.framework.registry import _HOST_OPS as jhost
    from paddle_tpu_torch.framework.registry import _HOST_OPS as thost
    assert set(jhost) <= set(thost)
    p = ptt.Program()
    p.global_block.append_op("gen_nccl_id", {}, {"Out": ["nid"]}, {},
                             infer_shape=False)
    sc = ptt.Scope()
    _texe().run(p, scope=sc)
    assert sc.find_var("nid").tolist() == [0]


# ---------------------------------------------------------------------------
# the save/load ops, across packages
# ---------------------------------------------------------------------------

def _save_prog(pkg, op_type, names, shapes, path, **attrs):
    p = pkg.Program()
    blk = p.global_block
    for n, s in zip(names, shapes):
        blk.create_var(name=n, shape=list(s), dtype="float32",
                       persistable=True)
    blk.append_op(op_type, {"X": list(names)}, {},
                  {"file_path": path, **attrs}, infer_shape=False)
    return p


def _load_prog(pkg, op_type, names, shapes, path, **attrs):
    p = pkg.Program()
    blk = p.global_block
    for n, s in zip(names, shapes):
        blk.create_var(name=n, shape=list(s), dtype="float32",
                       persistable=True)
    blk.append_op(op_type, {}, {"Out": list(names)},
                  {"file_path": path, **attrs}, infer_shape=False)
    return p


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("combine,fp16", [(False, False), (True, False),
                                          (True, True)])
def test_save_load_ops_cross_packages(tmp_path, writer, combine, fp16):
    rng = np.random.RandomState(3)
    vals = {"pa": rng.randn(4).astype(np.float32),
            "pb": rng.randn(2, 3).astype(np.float32)}
    names = list(vals) if combine else ["pa"]
    shapes = [vals[n].shape for n in names]
    path = str(tmp_path / ("all.npz" if combine else "w.bin"))
    save_t, load_t = (("save_combine", "load_combine") if combine
                      else ("save", "load"))
    attrs = {"save_as_fp16": True} if fp16 else {}
    if writer == "jax":
        with pt.scope_guard(pt.Scope()):
            for n in names:
                pt.global_scope().set_var(n, vals[n])
            pt.Executor().run(_save_prog(pt, save_t, names, shapes, path,
                                         **attrs))
        sc = ptt.Scope()
        _texe().run(_load_prog(ptt, load_t, names, shapes, path), scope=sc)
        got = {n: sc.get_numpy(n) for n in names}
    else:
        sc = ptt.Scope()
        ptt.io.set_params_from_numpy(sc, vals, "cpu")
        _texe().run(_save_prog(ptt, save_t, names, shapes, path, **attrs),
                    scope=sc)
        with pt.scope_guard(pt.Scope()):
            pt.Executor().run(_load_prog(pt, load_t, names, shapes, path))
            got = {n: np.asarray(pt.global_scope().find_var(n))
                   for n in names}
    for n in names:
        want = vals[n].astype(np.float16).astype(np.float32) if fp16 \
            else vals[n]
        assert got[n].dtype == np.float32          # upcast on load
        np.testing.assert_array_equal(got[n], want)


# ---------------------------------------------------------------------------
# fluid_interop: the JAX file's cases through the port
# ---------------------------------------------------------------------------

def test_program_desc_bytes_equal_jax_and_parse_independently():
    jm, _, _, _ = _toy(pt)
    tm, _, _, _ = _toy(ptt)
    data = tfi.program_to_fluid_bytes(tm)
    assert data == jfi.program_to_fluid_bytes(jm)
    desc = ProgramDescM.FromString(data)
    assert desc.version.version == 0
    blk = desc.blocks[0]
    assert (blk.idx, blk.parent_idx) == (0, -1)
    assert [o.type for o in blk.ops] == [o.type for o in
                                         tm.global_block.ops]
    by_name = {v.name: v for v in blk.vars}
    assert set(by_name) == set(tm.global_block.vars)
    w = by_name["fc_0.w_0"]
    assert w.type.lod_tensor.tensor.data_type == 5 and w.persistable
    back = tfi.program_from_fluid_bytes(data)
    assert _program_dict(back) == _program_dict(
        jfi.program_from_fluid_bytes(data))


def test_attr_types_on_wire_equal_jax():
    attrs = {"i": 3, "f": 0.5, "s": "hi", "ints": [1, 2],
             "floats": [1.5, 2.5], "strings": ["p", "q"], "b": True,
             "bools": [True, False], "l": 1 << 40, "longs": [1 << 40, -5],
             "sub_block": 0, "neg": -7}
    blobs = []
    for pkg in (pt, ptt):
        main = pkg.Program()
        blk = main.global_block
        blk.create_var(name="a", shape=[2], dtype="float32")
        blk.ops.append(pkg.Operator(blk, "fake_op", {}, {"Out": ["a"]},
                                    dict(attrs)))
        blobs.append((pkg, pkg.framework.fluid_interop
                      .program_to_fluid_bytes(main)))
    assert blobs[0][1] == blobs[1][1]
    got = {a.name: a for a in
           ProgramDescM.FromString(blobs[1][1]).blocks[0].ops[0].attrs}
    assert got["i"].type == tfi.ATTR_INT and got["neg"].i == -7
    assert got["l"].type == tfi.ATTR_LONG and got["l"].l == 1 << 40
    assert list(got["longs"].longs) == [1 << 40, -5]
    assert got["sub_block"].type == tfi.ATTR_BLOCK


def test_import_from_independent_encoder():
    desc = ProgramDescM()
    desc.version.version = 0
    blk = desc.blocks.add()
    blk.idx, blk.parent_idx = 0, -1
    for name, dims, persistable in (("x", [-1, 4], False),
                                    ("w", [4, 3], True),
                                    ("y", [-1, 3], False)):
        v = blk.vars.add()
        v.name, v.persistable = name, persistable
        v.type.type = 7
        v.type.lod_tensor.tensor.data_type = 5
        v.type.lod_tensor.tensor.dims.extend(dims)
    op = blk.ops.add()
    op.type = "mul"
    for slot, arg, io in (("X", "x", op.inputs), ("Y", "w", op.inputs),
                          ("Out", "y", op.outputs)):
        iv = io.add()
        iv.parameter = slot
        iv.arguments.append(arg)
    for name in ("x_num_col_dims", "y_num_col_dims"):
        a = op.attrs.add()
        a.name, a.type, a.i = name, tfi.ATTR_INT, 1
    program = tfi.program_from_fluid_bytes(desc.SerializeToString())
    b0 = program.global_block
    assert [o.type for o in b0.ops] == ["mul"]
    assert b0.var("w").shape == (4, 3) and b0.var("w").persistable
    assert isinstance(b0.var("w"), ptt.Parameter)
    w = np.random.RandomState(0).rand(4, 3).astype(np.float32)
    sc = ptt.Scope()
    ptt.io.set_params_from_numpy(sc, {"w": w}, "cpu")
    got, = _texe().run(program, feed={"x": _x()}, fetch_list=["y"],
                       scope=sc)
    np.testing.assert_allclose(got, _x() @ w, rtol=1e-5)


ARRAYS = [np.arange(6, dtype=np.float32).reshape(2, 3),
          np.array([1, 2, 3], dtype=np.int64)] + [
    (np.random.RandomState(i).rand(3, 2) * 4).astype(dt)
    for i, dt in enumerate(("float64", "float16", "int32", "int16", "int8",
                            "uint8", "bool"))]


@pytest.mark.parametrize("i", range(len(ARRAYS)))
def test_tensor_streams_equal_jax_and_golden(i):
    arr = ARRAYS[i]
    lod = [[0, 2, 3]] if i == 1 else None
    got = tfi.lod_tensor_to_bytes(arr, lod)
    assert got == jfi.lod_tensor_to_bytes(arr, lod)
    back, back_lod = tfi.lod_tensor_from_bytes(got)
    np.testing.assert_array_equal(back, arr)
    assert back_lod == (lod or [])
    if i == 0:      # hand-assembled per lod_tensor.cc:219 + tensor_util.cc
        td = TensorDescM()
        td.data_type = 5
        td.dims.extend([2, 3])
        tdb = td.SerializeToString()
        want = (struct.pack("<I", 0) + struct.pack("<Q", 0)
                + struct.pack("<I", 0) + struct.pack("<i", len(tdb)) + tdb
                + arr.tobytes())
        assert got == want


def test_combine_stream_equals_jax():
    data = tfi.save_combine_bytes(ARRAYS[:4])
    assert data == jfi.save_combine_bytes(ARRAYS[:4])
    for a, b in zip(ARRAYS[:4], tfi.load_combine_bytes(data)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# io.py: inference models and checkpoints across packages
# ---------------------------------------------------------------------------

def _save_model(pkg, d, fmt, params_filename):
    main, startup, out, _ = _toy(pkg)
    vals = _jax_values(*_toy(pt)[:2])
    if pkg is pt:
        exe = pt.Executor()
        with pt.scope_guard(pt.Scope()):
            for k, v in vals.items():
                pt.global_scope().set_var(k, v)
            pt.io.save_inference_model(d, ["x"], [out], exe,
                                       main_program=main, format=fmt,
                                       params_filename=params_filename)
    else:
        sc = ptt.Scope()
        ptt.io.set_params_from_numpy(sc, vals, "cpu")
        ptt.io.save_inference_model(d, ["x"], [out], _texe(),
                                    main_program=main, scope=sc,
                                    format=fmt,
                                    params_filename=params_filename)
    return vals


def _files(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                out[os.path.relpath(os.path.join(root, f), d)] = fh.read()
    return out


@pytest.mark.parametrize("fmt,params_filename", [
    ("native", None), ("native", "weights"), ("fluid", None),
    ("fluid", "params")])
def test_inference_model_dirs_interchange_with_jax(tmp_path, fmt,
                                                   params_filename):
    """Each package saves the same model; the fluid files and both
    programs are equal byte for byte (an npz carries its write time, so
    its arrays are compared); each directory loads and runs in the other
    package to the same outputs."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    _save_model(pt, jd, fmt, params_filename)
    _save_model(ptt, td, fmt, params_filename)
    jf, tf = _files(jd), _files(td)
    assert sorted(jf) == sorted(tf)
    for name in jf:
        if name.endswith(".npz") or name == (params_filename or "") and \
                fmt == "native":
            with np.load(os.path.join(jd, name)) as a, \
                    np.load(os.path.join(td, name)) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k])
        else:
            assert jf[name] == tf[name], name
    x = _x(4)
    for d in (jd, td):
        with pt.scope_guard(pt.Scope()):
            exe = pt.Executor()
            prog, feeds, fetches = pt.io.load_inference_model(
                d, exe, params_filename=params_filename)
            want, = exe.run(prog, feed={"x": x}, fetch_list=fetches)
        sc = ptt.Scope()
        prog, feeds, fetches = ptt.io.load_inference_model(
            d, _texe(), scope=sc, params_filename=params_filename)
        assert feeds == ["x"]
        got, = _texe().run(prog, feed={"x": x}, fetch_list=fetches,
                           scope=sc)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_per_var_scoped_names_make_subdirs_and_load_in_jax(tmp_path):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [4])
        ptt.layers.fc(x, 3, param_attr=ptt.ParamAttr(name="blk/fc.w"),
                      bias_attr=False)
    exe, sc = _texe(), ptt.Scope()
    exe.run(startup, scope=sc)
    w = sc.get_numpy("blk/fc.w")
    d = str(tmp_path)
    ptt.io.save_vars(exe, d, main, vars=main.all_parameters(), scope=sc,
                     format="fluid")
    assert os.path.isfile(os.path.join(d, "blk", "fc.w"))
    sc2 = ptt.Scope()
    ptt.io.load_vars(exe, d, main, vars=main.all_parameters(), scope=sc2)
    np.testing.assert_array_equal(sc2.get_numpy("blk/fc.w"), w)
    jm = pt.Program()
    jm.global_block.create_parameter(name="blk/fc.w", shape=[4, 3],
                                     dtype="float32")
    with pt.scope_guard(pt.Scope()):
        pt.io.load_vars(pt.Executor(), d, jm, vars=jm.all_parameters())
        np.testing.assert_array_equal(
            np.asarray(pt.global_scope().find_var("blk/fc.w")), w)
    with pytest.raises(ValueError, match="collide"):
        sc.set_var("blk", torch.zeros(1))
        main.global_block.create_var(name="blk", shape=[1],
                                     dtype="float32", persistable=True)
        ptt.io.save_vars(exe, d, main, predicate=lambda v: v.persistable,
                         scope=sc, format="fluid")


def test_load_reference_built_directory(tmp_path):
    """A model dir assembled with the independent encoder (feed/fetch ops,
    hand-packed tensor streams) loads and runs in the port."""
    rng = np.random.RandomState(7)
    w, b = rng.rand(4, 3).astype(np.float32), rng.rand(3).astype(np.float32)
    x = rng.rand(6, 4).astype(np.float32)
    desc = ProgramDescM()
    desc.version.version = 0
    blk = desc.blocks.add()
    blk.idx, blk.parent_idx = 0, -1
    for name, dims, vt, pers in (("feed", [], 9, True),
                                 ("fetch", [], 10, True),
                                 ("x", [-1, 4], 7, False),
                                 ("w0", [4, 3], 7, True),
                                 ("b0", [3], 7, True),
                                 ("xw", [-1, 3], 7, False),
                                 ("pre", [-1, 3], 7, False),
                                 ("prob", [-1, 3], 7, False)):
        v = blk.vars.add()
        v.name, v.persistable, v.type.type = name, pers, vt
        if vt == 7:
            v.type.lod_tensor.tensor.data_type = 5
            v.type.lod_tensor.tensor.dims.extend(dims)
    for tp, ins, outs, attrs in (
            ("feed", [("X", ["feed"])], [("Out", ["x"])], [("col", 0)]),
            ("mul", [("X", ["x"]), ("Y", ["w0"])], [("Out", ["xw"])],
             [("x_num_col_dims", 1), ("y_num_col_dims", 1)]),
            ("elementwise_add", [("X", ["xw"]), ("Y", ["b0"])],
             [("Out", ["pre"])], [("axis", -1)]),
            ("softmax", [("X", ["pre"])], [("Out", ["prob"])], []),
            ("fetch", [("X", ["prob"])], [("Out", ["fetch"])],
             [("col", 0)])):
        op = blk.ops.add()
        op.type = tp
        for io, lst in ((op.inputs, ins), (op.outputs, outs)):
            for slot, args in lst:
                v = io.add()
                v.parameter = slot
                v.arguments.extend(args)
        for name, val in attrs:
            a = op.attrs.add()
            a.name, a.type, a.i = name, tfi.ATTR_INT, val
    with open(tmp_path / "__model__", "wb") as f:
        f.write(desc.SerializeToString())
    for name, arr in (("w0", w), ("b0", b)):
        td = TensorDescM()
        td.data_type = 5
        td.dims.extend(arr.shape)
        tdb = td.SerializeToString()
        with open(tmp_path / name, "wb") as f:
            f.write(struct.pack("<I", 0) + struct.pack("<Q", 0)
                    + struct.pack("<I", 0) + struct.pack("<i", len(tdb))
                    + tdb + arr.tobytes())
    sc = ptt.Scope()
    prog, feeds, fetches = ptt.io.load_inference_model(str(tmp_path),
                                                       _texe(), scope=sc)
    assert feeds == ["x"]
    got, = _texe().run(prog, feed={"x": x}, fetch_list=fetches, scope=sc)
    logits = x @ w + b
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    np.testing.assert_allclose(got, e / e.sum(axis=1, keepdims=True),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["cond", "while"])
def test_control_flow_programs_roundtrip_the_fluid_wire(case):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        if case == "cond":
            x = ptt.layers.data("x", [4])
            flag = ptt.layers.data("flag", [], dtype="bool")
            out = ptt.layers.cond(flag, lambda: ptt.layers.scale(x, 2.0),
                                  lambda: ptt.layers.scale(x, -1.0))
        else:
            i = ptt.layers.fill_constant([1], "int64", 0)
            limit = ptt.layers.fill_constant([1], "int64", 5)
            out = ptt.layers.fill_constant([1], "float32", 0.0)
            c = ptt.layers.less_than(i, limit)
            w = ptt.layers.While(c)
            with w.block():
                ptt.layers.assign(out + 2.0, output=out)
                ptt.layers.increment(i)
                ptt.layers.assign(ptt.layers.less_than(i, limit), output=c)
    data = tfi.program_to_fluid_bytes(main)
    back = tfi.program_from_fluid_bytes(data)
    assert len(back.blocks) == len(main.blocks)
    feeds = ([{"x": np.ones((2, 4), "f"), "flag": np.array([v])}
              for v in (True, False)] if case == "cond" else [{}])
    for f in feeds:
        r1, = _texe().run(main, feed=f, fetch_list=[out], scope=ptt.Scope())
        r2, = _texe().run(back, feed=f, fetch_list=[out.name],
                          scope=ptt.Scope())
        np.testing.assert_array_equal(r1, r2)
    if case == "while":
        np.testing.assert_array_equal(r2, [10.0])


def test_params_and_persistables_both_formats_and_getters(tmp_path):
    """save_params/load_params and save/load_persistables in both formats
    cross to JAX bitwise; is_parameter, is_persistable and the parameter
    getters as JAX's; prepend_feed_ops/append_fetch_ops build JAX's
    program."""
    tm, ts, _, _ = _toy(ptt, optimizer=True)
    jm = _toy(pt, optimizer=True)[0]
    exe, sc = _texe(), ptt.Scope()
    exe.run(ts, scope=sc)
    for fmt, fn in (("native", None), ("fluid", None), ("fluid", "all")):
        for what in ("params", "persistables"):
            d = str(tmp_path / f"{fmt}_{fn}_{what}")
            getattr(ptt.io, f"save_{what}")(exe, d, tm, scope=sc,
                                            format=fmt, filename=fn)
            with pt.scope_guard(pt.Scope()):
                getattr(pt.io, f"load_{what}")(pt.Executor(), d, jm,
                                               filename=fn)
                jsc = pt.global_scope()
                names = [n for n in jsc.var_names() if not n.startswith("@")]
                got = {n: np.asarray(jsc.find_var(n)) for n in names}
            pred = (ptt.io.is_parameter if what == "params"
                    else ptt.io.is_persistable)
            assert sorted(got) == sorted(v.name for v in tm.list_vars()
                                         if pred(v))
            for n, v in got.items():
                np.testing.assert_array_equal(v, sc.get_numpy(n))
            sc2 = ptt.Scope()
            getattr(ptt.io, f"load_{what}")(exe, d, tm, filename=fn,
                                            scope=sc2)
            for n in got:
                np.testing.assert_array_equal(sc2.get_numpy(n),
                                              sc.get_numpy(n))
    w = tm.global_block.var("fc_0.w_0")
    np.testing.assert_array_equal(ptt.io.get_parameter_value(w, scope=sc),
                                  sc.get_numpy("fc_0.w_0"))
    np.testing.assert_array_equal(
        ptt.io.get_parameter_value_by_name("fc_0.w_0", program=tm,
                                           scope=sc),
        sc.get_numpy("fc_0.w_0"))
    lr = next(v for v in tm.list_vars() if "learning_rate" in v.name)
    assert not ptt.io.is_parameter(lr) and ptt.io.is_persistable(lr)
    with pytest.raises(TypeError, match="not a Parameter"):
        ptt.io.get_parameter_value_by_name(lr.name, program=tm, scope=sc)
    progs = []
    for pkg in (pt, ptt):
        p = _toy(pkg)[0]
        pkg.io.prepend_feed_ops(p, ["x"])
        pkg.io.append_fetch_ops(p, ["fc_1.tmp_2"])
        progs.append(_program_dict(p))
    assert progs[0] == progs[1]


# ---------------------------------------------------------------------------
# async checkpointing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["native", "fluid"])
def test_async_snapshot_is_step_consistent_under_donation(tmp_path, fmt):
    """The values at save time reach the file, though the donated steps
    after it overwrite the same tensors in place before the write runs."""
    main, startup, _, loss = _toy(ptt, optimizer=True)
    feed = {"x": np.ones((4, 4), "f"), "y": np.full((4, 3), 0.5, "f")}
    exe, sc = ptt.Executor(ptt.CPUPlace(), donate=True), ptt.Scope()
    exe.run(startup, scope=sc)
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=sc)
    names = [v.name for v in main.list_vars() if v.persistable]
    at_save = {n: sc.get_numpy(n) for n in names}
    ptrs = {n: sc.find_var(n).data_ptr() for n in names}
    fn = "all" if fmt == "fluid" else None
    ptt.io.save_persistables(exe, str(tmp_path), main, scope=sc,
                             format=fmt, filename=fn, sync=False)
    for _ in range(5):
        exe.run(main, feed=feed, fetch_list=[loss], scope=sc)
    assert sc.find_var("fc_0.w_0").data_ptr() == ptrs["fc_0.w_0"]
    assert not np.array_equal(sc.get_numpy("fc_0.w_0"), at_save["fc_0.w_0"])
    ptt.io.wait_for_saves()
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".tmp")]
    sc2 = ptt.Scope()
    ptt.io.load_persistables(exe, str(tmp_path), main, filename=fn,
                             scope=sc2)
    for n in names:
        np.testing.assert_array_equal(sc2.get_numpy(n), at_save[n])


def test_atomic_writes_order_and_surfaced_failures(tmp_path):
    import threading
    import time
    from paddle_tpu_torch.io import (_atomic_write, _submit_write,
                                     wait_for_saves)
    dest = str(tmp_path / "ckpt.bin")
    with open(dest, "wb") as f:
        f.write(b"GOOD CHECKPOINT")

    def bad(f):
        f.write(b"partial garbage")
        raise IOError("disk died mid-write")
    with pytest.raises(IOError):
        _atomic_write(dest, bad)
    with open(dest, "rb") as f:
        assert f.read() == b"GOOD CHECKPOINT"
    assert os.listdir(tmp_path) == ["ckpt.bin"]
    wait_for_saves()
    _submit_write(str(tmp_path / "x.bin"), bad, sync=False)
    with pytest.raises(IOError, match="disk died"):
        wait_for_saves()
    assert os.listdir(tmp_path) == ["ckpt.bin"]
    wait_for_saves()                              # error queue drained
    started = threading.Event()

    def slow(f):
        started.set()
        time.sleep(0.2)
        f.write(b"old snapshot")
    _submit_write(dest, slow, sync=False)
    _submit_write(dest, lambda f: f.write(b"new snapshot"), sync=False)
    assert started.wait(timeout=10)
    wait_for_saves()
    with open(dest, "rb") as f:
        assert f.read() == b"new snapshot"   # the newest survives


def test_native_program_bytes_and_meta_equal_jax(tmp_path):
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    _save_model(pt, jd, "native", None)
    _save_model(ptt, td, "native", None)
    with open(os.path.join(jd, "__meta__")) as a, \
            open(os.path.join(td, "__meta__")) as b:
        assert json.load(a) == json.load(b)
    with open(os.path.join(jd, "__model__"), "rb") as a, \
            open(os.path.join(td, "__model__"), "rb") as b:
        assert a.read() == b.read()
