"""Checkpoint / model export (reference: python/paddle/fluid/io.py
save_persistables:487 / load_persistables:726 / save_inference_model:933 /
load_inference_model:1113).

Port of `paddle_tpu/io.py`, both on-disk formats, byte for byte:
  * "native" (default): the JSON IR program (`__model__`, byte-compatible
    with the JAX package's `Program.serialize_to_string`), `__meta__` (feed
    and fetch names) and one `params.npz` archive with '/' in var names
    mangled to '%2F';
  * "fluid": the reference's ProgramDesc protobuf and save_op tensor
    streams, one file a var or one save_combine file in sorted-name order
    (framework/fluid_interop.py, a copy of the JAX package's codec).
A file or directory that either package saved loads in the other, in both
formats. Loading auto-detects the format from the bytes (JSON IR starts
with '{', a ProgramDesc with the tag 0x0A, .npz is a zip 'PK', a fluid
tensor file starts with uint32 version 0).

The tensors live on the executor's device. A save copies them to the host
once, in one synchronised batch (`_host_arrays`: every card tensor into one
pinned buffer, then one synchronise), before it returns: a later in-place
update of a parameter (donation) cannot reach a snapshot. A load places
each tensor on the executor's device (the CPU when no executor is given),
cast to its var's declared dtype.

Async checkpointing: save_persistables(..., sync=False) takes that host
snapshot on the calling thread and writes the file on a background thread
with write-to-temp + fsync + atomic rename, as the JAX package does;
`wait_for_saves()` joins the writers and re-raises the first failure.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .framework.core import Program, Variable, default_main_program
from .framework.executor import Executor, Scope, _to_numpy, global_scope
from .framework.registry import torch_dtype
from .framework import fluid_interop

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "wait_for_saves", "is_parameter",
           "is_persistable", "get_parameter_value",
           "get_parameter_value_by_name", "prepend_feed_ops",
           "append_fetch_ops", "set_params_from_numpy"]

_PARAMS_FILE = "params.npz"
_PROGRAM_FILE = "__model__"


def _mangle(name: str) -> str:
    return name.replace("/", "%2F")


def _unmangle(name: str) -> str:
    return name.replace("%2F", "/")


def set_params_from_numpy(scope: Scope, arrays: Dict[str, np.ndarray],
                          device) -> None:
    """Put `{name: ndarray}` into `scope` as tensors on `device`, under the
    same names, dtypes and layouts (a `mul` weight is (in, out) in both
    packages). Carries the JAX package's parameters into the port."""
    device = torch.device(device)
    for name, arr in arrays.items():
        scope.set_var(name, torch.from_numpy(np.array(arr, order="C"))
                      .to(device))


# --------------------------------------------------------------------------
# host snapshots and device placement
# --------------------------------------------------------------------------

def _host_arrays(vals: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """{name: value} -> {name: host ndarray}, copies that no later in-place
    update reaches. Card tensors go into one pinned buffer by non-blocking
    copies and one synchronise, not a blocking copy each (bf16 widens to
    f32, as a fetch does)."""
    out: Dict[str, Any] = {}
    cards = []
    for k, v in vals.items():
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            t = v.detach()
            cards.append((k, t.float() if t.dtype == torch.bfloat16 else t))
        else:
            out[k] = _to_numpy(v)
    if cards:
        offs, total = [], 0
        for _, t in cards:
            offs.append(total)
            total += -(-t.numel() * t.element_size() // 64) * 64
        buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        for (k, t), off in zip(cards, offs):
            n = t.numel() * t.element_size()
            host = buf[off:off + n].view(t.dtype).view(t.shape)
            host.copy_(t, non_blocking=True)
            out[k] = host
        for dev in {t.device for _, t in cards}:
            torch.cuda.synchronize(dev)
        for k, _ in cards:
            out[k] = out[k].numpy()
    return {k: out[k] for k in vals}   # the caller's order (npz entries)


def _place(arr: np.ndarray, var: Optional[Variable], device) -> torch.Tensor:
    """A loaded array as a tensor on `device`, in its var's declared dtype
    where the var declares one the port knows."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    dtype = getattr(var, "dtype", None)
    try:
        want = torch_dtype(dtype) if dtype else None
    except KeyError:
        want = None
    return t.to(device=device, dtype=want)


# --------------------------------------------------------------------------
# Background writer (async checkpointing)
# --------------------------------------------------------------------------

_pending_saves: List[threading.Thread] = []
_pending_lock = threading.Lock()
_save_errors: List[BaseException] = []
_last_writer_for_path: dict = {}


def _atomic_write(path: str, write_fn) -> None:
    """Write via temp file in the same directory + fsync + rename, so a
    crash mid-save never corrupts the previous checkpoint."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_save_")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _submit_write(path: str, write_fn, sync: bool) -> None:
    """Write `path` now (sync) or on a background thread. `write_fn` must
    hold only host data: the snapshot is taken before this is called."""
    if sync:
        _atomic_write(path, write_fn)
        return
    path = os.path.abspath(path)

    def _run(predecessor):
        try:
            # writes to the same path complete in submission order, so the
            # newest snapshot is always the one that survives
            if predecessor is not None:
                predecessor.join()
            _atomic_write(path, write_fn)
        except BaseException as exc:  # surfaced by wait_for_saves
            with _pending_lock:
                _save_errors.append(exc)

    with _pending_lock:
        # read-predecessor + register + start are one critical section: a
        # thread published as predecessor is already started, and two
        # concurrent submitters never chain off the same predecessor
        t = threading.Thread(target=_run,
                             args=(_last_writer_for_path.get(path),),
                             daemon=True, name="io.save")
        _last_writer_for_path[path] = t
        _pending_saves.append(t)
        _pending_saves[:] = [p for p in _pending_saves
                             if p.is_alive() or p is t]
        t.start()


def wait_for_saves() -> None:
    """Block until all background checkpoint writes complete; re-raise the
    first failure (a returned wait means the checkpoints are on disk)."""
    with _pending_lock:
        pending = list(_pending_saves)
        _pending_saves.clear()
    for t in pending:
        t.join()
    with _pending_lock:
        # only drop registrations whose writer was joined (or has since
        # finished): a save submitted between the two critical sections
        # keeps its predecessor chain
        joined = set(map(id, pending))
        for path in list(_last_writer_for_path):
            w = _last_writer_for_path[path]
            if id(w) in joined or not w.is_alive():
                del _last_writer_for_path[path]
        errors = list(_save_errors)
        _save_errors.clear()
    if errors:
        raise errors[0]


# --------------------------------------------------------------------------
# save/load vars
# --------------------------------------------------------------------------

def _collect(scope: Scope, vars: Sequence[Variable]) -> dict:
    """Snapshot var values to host numpy: the step-consistent copy point,
    one batched copy for all vars."""
    vals = {}
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError(f"var {v.name!r} not found in scope")
        vals[v.name] = val
    return _host_arrays(vals)


def save_vars(executor: Optional[Executor], dirname: str,
              main_program: Optional[Program] = None,
              vars: Optional[Sequence[Variable]] = None,
              predicate=None, filename: Optional[str] = None,
              scope: Optional[Scope] = None, format: str = "native",
              sync: bool = True) -> None:
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = [v for v in program.list_vars()
                if (predicate(v) if predicate else True)]
    os.makedirs(dirname, exist_ok=True)
    arrays = _collect(scope, vars)
    if format == "fluid":
        if filename is None:
            # one save_op stream per var, file named by var (fluid io.py:200);
            # fluid's load_op resolves dirname/<literal var name>, so scoped
            # names like "gpt/l0/q.w" become real subdirectories
            root = os.path.abspath(dirname)
            # a var named "blk" colliding with a scope "blk/..." cannot be
            # both a file and a directory: fail up front with the names
            prefixes = set()
            for name in arrays:
                parts = name.split("/")
                prefixes.update("/".join(parts[:i])
                                for i in range(1, len(parts)))
            clash = sorted(n for n in arrays if n in prefixes)
            if clash:
                raise ValueError(
                    f"fluid per-var save: var names {clash} collide with "
                    f"scope prefixes of other vars (file vs directory); "
                    "use a combined file (filename=...) for this program")
            for name, arr in arrays.items():
                payload = fluid_interop.lod_tensor_to_bytes(arr)
                target = os.path.join(dirname, name)
                # containment: a var name from an untrusted ProgramDesc
                # ("../x", "/tmp/x") must not escape the checkpoint dir
                if not os.path.abspath(target).startswith(root + os.sep):
                    raise ValueError(
                        f"var name {name!r} escapes save dir {dirname!r}")
                os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
                _submit_write(target,
                              lambda f, p=payload: f.write(p), sync)
        else:
            # save_combine file, sorted-name order (fluid io.py:242)
            names = sorted(arrays)
            payload = fluid_interop.save_combine_bytes(
                [arrays[n] for n in names])
            _submit_write(os.path.join(dirname, filename),
                          lambda f, p=payload: f.write(p), sync)
        return
    mangled = {_mangle(k): v for k, v in arrays.items()}
    _submit_write(os.path.join(dirname, filename or _PARAMS_FILE),
                  lambda f: np.savez(f, **mangled), sync)


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None, format="native", sync=True):
    return save_vars(executor, dirname, main_program,
                     predicate=is_parameter, filename=filename, scope=scope,
                     format=format, sync=sync)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None, format="native", sync=True):
    return save_vars(executor, dirname, main_program,
                     predicate=lambda v: v.persistable, filename=filename,
                     scope=scope, format=format, sync=sync)


def _is_fluid_tensor_file(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(4)
    return head == b"\x00\x00\x00\x00"


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = [v for v in program.list_vars()
                if (predicate(v) if predicate else True)]
    vars = list(vars)
    device = executor.device if executor is not None else "cpu"
    if filename is None and not os.path.exists(
            os.path.join(dirname, _PARAMS_FILE)):
        # per-var fluid tensor files named by var name; every requested var
        # must be present (reference load_vars errors per missing file)
        missing = []
        for v in vars:
            # literal-name layout (what save_vars writes, and what fluid's
            # load_op expects) wins over the legacy mangled flat file
            path = os.path.join(dirname, v.name)
            if not os.path.isfile(path):
                # not a file (absent, or a directory when another var's
                # scoped name shares this prefix): try the legacy mangled
                # flat layout before reporting missing
                path = os.path.join(dirname, _mangle(v.name))
            if os.path.isfile(path) and _is_fluid_tensor_file(path):
                with open(path, "rb") as f:
                    arr, _lod = fluid_interop.lod_tensor_from_bytes(f.read())
                scope.set_var(v.name, _place(arr, v, device))
            else:
                missing.append(v.name)
        if not missing:
            return
        if len(missing) == len(vars):
            raise FileNotFoundError(
                f"no {_PARAMS_FILE} and no per-var tensor files in {dirname}")
        raise FileNotFoundError(
            f"per-var tensor files missing in {dirname}: {missing}")
    path = os.path.join(dirname, filename or _PARAMS_FILE)
    with open(path, "rb") as f:
        head = f.read(2)
    if head != b"PK":  # not a zip: fluid save_combine stream, sorted names
        with open(path, "rb") as f:
            data = f.read()
        arrays = fluid_interop.load_combine_bytes(data)
        names = sorted(v.name for v in vars)
        if len(arrays) != len(names):
            raise ValueError(
                f"combined file has {len(arrays)} tensors, expected "
                f"{len(names)} ({names[:4]}...)")
        by_name = dict(zip(names, arrays))
        for v in vars:
            scope.set_var(v.name, _place(by_name[v.name], v, device))
        return
    with np.load(path) as data:
        names = {_unmangle(k): k for k in data.files}
        for v in vars:
            if v.name in names:
                scope.set_var(v.name, _place(data[names[v.name]], v, device))


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    return load_vars(executor, dirname, main_program, predicate=is_parameter,
                     filename=filename, scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return load_vars(executor, dirname, main_program,
                     predicate=lambda v: v.persistable, filename=filename,
                     scope=scope)


# --------------------------------------------------------------------------
# inference model
# --------------------------------------------------------------------------

def _append_feed_fetch_ops(program: Program, feed_names: Sequence[str],
                           fetch_names: Sequence[str]) -> None:
    """Wrap the program with feed/fetch ops the way the reference does
    (fluid io.py:893 prepend_feed_ops / io.py:915 append_fetch_ops), so the
    exported ProgramDesc is runnable by Fluid's executor."""
    blk = program.global_block
    blk.create_var(name="feed", type="feed_minibatch", persistable=True)
    blk.create_var(name="fetch", type="fetch_list", persistable=True)
    for i, name in enumerate(feed_names):
        blk.insert_op(i, type="feed", inputs={"X": ["feed"]},
                      outputs={"Out": [name]}, attrs={"col": i})
    for i, name in enumerate(fetch_names):
        blk.append_op(type="fetch", inputs={"X": [name]},
                      outputs={"Out": ["fetch"]}, attrs={"col": i})


def _strip_feed_fetch_ops(program: Program):
    """Extract feed/fetch targets from a Fluid-style wrapped program and
    remove the wrapper ops (the executor feeds/fetches by name)."""
    blk = program.global_block
    feeds, fetches = {}, {}
    kept = []
    for op in blk.ops:
        if op.type == "feed":
            feeds[int(op.attrs.get("col", len(feeds)))] = op.output("Out")[0]
        elif op.type == "fetch":
            fetches[int(op.attrs.get("col", len(fetches)))] = op.input("X")[0]
        else:
            kept.append(op)
    blk.ops = kept
    for holder in ("feed", "fetch"):
        v = blk.vars.get(holder)
        if v is not None and v.type in ("feed_minibatch", "fetch_list"):
            del blk.vars[holder]
    feed_names = [feeds[i] for i in sorted(feeds)]
    fetch_names = [fetches[i] for i in sorted(fetches)]
    return feed_names, fetch_names


def save_inference_model(dirname: str, feeded_var_names: List[str],
                         target_vars: List[Variable], executor=None,
                         main_program: Optional[Program] = None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None,
                         scope=None, format: str = "native") -> None:
    """Prune to the inference subgraph + save program & params
    (reference: io.py:933)."""
    program = main_program or default_main_program()
    inference_program = program.clone(for_test=True)
    targets = [v.name for v in target_vars]
    inference_program = inference_program._prune(targets)
    os.makedirs(dirname, exist_ok=True)
    model_path = os.path.join(dirname, model_filename or _PROGRAM_FILE)
    if format == "fluid":
        _append_feed_fetch_ops(inference_program, feeded_var_names, targets)
        data = fluid_interop.program_to_fluid_bytes(inference_program)
        with open(model_path, "wb") as f:
            f.write(data)
        _strip_feed_fetch_ops(inference_program)  # restore for param listing
        save_persistables(executor, dirname, inference_program,
                          filename=params_filename, scope=scope,
                          format="fluid")
        return
    with open(model_path, "wb") as f:
        f.write(inference_program.serialize_to_string())
    with open(os.path.join(dirname, "__meta__"), "w") as f:
        json.dump({"feed": list(feeded_var_names), "fetch": targets}, f)
    save_persistables(executor, dirname, inference_program,
                      filename=params_filename, scope=scope)


def load_inference_model(dirname: str, executor=None, scope=None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None):
    """Load a native-format or reference-format inference model directory,
    the format detected from the model bytes: JSON IR begins with '{', a
    Fluid ProgramDesc with the blocks-field tag 0x0A (framework.proto:184).
    Returns (program, feed_names, fetch_vars)."""
    model_path = os.path.join(dirname, model_filename or _PROGRAM_FILE)
    with open(model_path, "rb") as f:
        raw = f.read()
    if raw[:1] == b"{":  # native JSON IR
        program = Program.parse_from_string(raw)
        with open(os.path.join(dirname, "__meta__")) as f:
            meta = json.load(f)
        feed_names, fetch_names = meta["feed"], meta["fetch"]
    else:
        program = fluid_interop.program_from_fluid_bytes(raw)
        feed_names, fetch_names = _strip_feed_fetch_ops(program)
    load_persistables(executor, dirname, program, filename=params_filename,
                      scope=scope)
    blk = program.global_block
    return program, feed_names, [blk.var(n) for n in fetch_names]


def is_parameter(var) -> bool:
    """reference: io.py is_parameter."""
    from .framework.core import Parameter
    return isinstance(var, Parameter)


def is_persistable(var) -> bool:
    """reference: io.py is_persistable."""
    return bool(getattr(var, "persistable", False))


def get_parameter_value(para, executor=None, scope=None):
    """reference: io.py get_parameter_value: a parameter's current value as
    a host numpy copy."""
    scope = scope or global_scope()
    val = scope.find_var(para.name)
    if val is None:
        raise RuntimeError(f"parameter {para.name!r} not found in scope")
    return _to_numpy(val)


def get_parameter_value_by_name(name, executor=None, program=None,
                                scope=None):
    """reference: io.py get_parameter_value_by_name."""
    program = program or default_main_program()
    var = program.global_block.var(name)
    if not is_parameter(var):
        raise TypeError(f"var {name!r} is not a Parameter")
    return get_parameter_value(var, executor, scope=scope)


def prepend_feed_ops(inference_program, feed_target_names,
                     feed_holder_name="feed"):
    """reference: io.py prepend_feed_ops (used by save_inference_model's
    fluid export)."""
    blk = inference_program.global_block
    blk.create_var(name=feed_holder_name, type="feed_minibatch",
                   persistable=True)
    for i, name in enumerate(feed_target_names):
        blk.insert_op(i, type="feed", inputs={"X": [feed_holder_name]},
                      outputs={"Out": [name]}, attrs={"col": i})


def append_fetch_ops(inference_program, fetch_target_names,
                     fetch_holder_name="fetch"):
    """reference: io.py append_fetch_ops."""
    blk = inference_program.global_block
    blk.create_var(name=fetch_holder_name, type="fetch_list",
                   persistable=True)
    for i, name in enumerate(fetch_target_names):
        blk.append_op(type="fetch", inputs={"X": [name]},
                      outputs={"Out": [fetch_holder_name]},
                      attrs={"col": i})
