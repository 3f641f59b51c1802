"""Checkpoint / model export, native format (reference:
python/paddle/fluid/io.py save_persistables:487 / load_persistables:726 /
save_inference_model:933 / load_inference_model:1113).

Port of the native half of `paddle_tpu/io.py`: a directory holds the JSON
IR program (`__model__`, byte-compatible with the JAX package's
`Program.serialize_to_string`), `__meta__` (feed and fetch names) and one
`params.npz` archive with '/' in var names mangled to '%2F'. A directory
that either package saved loads in the other.

Loaded tensors are placed on the executor's device (the CPU when no
executor is given) and cast to each var's declared dtype. Not ported yet:
the Fluid protobuf format (`fluid_interop`), per-var tensor files and
asynchronous saves.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .framework.core import Program, Variable, default_main_program
from .framework.executor import Executor, Scope, _to_numpy, global_scope
from .framework.registry import torch_dtype

__all__ = ["save_vars", "save_persistables", "load_vars",
           "load_persistables", "save_inference_model",
           "load_inference_model", "set_params_from_numpy"]

_PARAMS_FILE = "params.npz"
_PROGRAM_FILE = "__model__"


def _mangle(name: str) -> str:
    return name.replace("/", "%2F")


def _unmangle(name: str) -> str:
    return name.replace("%2F", "/")


def _check_native(format: str):
    if format != "native":
        raise NotImplementedError(
            f"format={format!r}: only the native format is ported to "
            "paddle_tpu_torch; the Fluid protobuf format comes later")


def set_params_from_numpy(scope: Scope, arrays: Dict[str, np.ndarray],
                          device) -> None:
    """Put `{name: ndarray}` into `scope` as tensors on `device`, under the
    same names, dtypes and layouts (a `mul` weight is (in, out) in both
    packages). Carries the JAX package's parameters into the port."""
    device = torch.device(device)
    for name, arr in arrays.items():
        scope.set_var(name, torch.from_numpy(np.array(arr, order="C"))
                      .to(device))


def _collect(scope: Scope, vars: Sequence[Variable]) -> dict:
    vals = {}
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError(f"var {v.name!r} not found in scope")
        vals[v.name] = _to_numpy(val)
    return vals


def save_vars(executor: Optional[Executor], dirname: str,
              main_program: Optional[Program] = None,
              vars: Optional[Sequence[Variable]] = None,
              predicate=None, filename: Optional[str] = None,
              scope: Optional[Scope] = None, format: str = "native") -> None:
    _check_native(format)
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = [v for v in program.list_vars()
                if (predicate(v) if predicate else True)]
    os.makedirs(dirname, exist_ok=True)
    arrays = {_mangle(k): a for k, a in _collect(scope, vars).items()}
    path = os.path.join(dirname, filename or _PARAMS_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None, format="native"):
    return save_vars(executor, dirname, main_program,
                     predicate=lambda v: v.persistable, filename=filename,
                     scope=scope, format=format)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = [v for v in program.list_vars()
                if (predicate(v) if predicate else True)]
    path = os.path.join(dirname, filename or _PARAMS_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no {filename or _PARAMS_FILE} in {dirname} (only the native "
            "format is ported to paddle_tpu_torch)")
    device = executor.device if executor is not None else "cpu"
    with np.load(path) as data:
        names = {_unmangle(k): k for k in data.files}
        for v in vars:
            if v.name in names:
                t = torch.from_numpy(np.ascontiguousarray(
                    data[names[v.name]]))
                scope.set_var(v.name,
                              t.to(device=device,
                                   dtype=torch_dtype(v.dtype)))


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return load_vars(executor, dirname, main_program,
                     predicate=lambda v: v.persistable, filename=filename,
                     scope=scope)


def save_inference_model(dirname: str, feeded_var_names: List[str],
                         target_vars: List[Variable], executor=None,
                         main_program: Optional[Program] = None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None,
                         scope=None, format: str = "native") -> None:
    """Prune to the inference subgraph + save program & params
    (reference: io.py:933)."""
    _check_native(format)
    program = main_program or default_main_program()
    inference_program = program.clone(for_test=True)
    targets = [v.name for v in target_vars]
    inference_program = inference_program._prune(targets)
    os.makedirs(dirname, exist_ok=True)
    model_path = os.path.join(dirname, model_filename or _PROGRAM_FILE)
    with open(model_path, "wb") as f:
        f.write(inference_program.serialize_to_string())
    with open(os.path.join(dirname, "__meta__"), "w") as f:
        json.dump({"feed": list(feeded_var_names), "fetch": targets}, f)
    save_persistables(executor, dirname, inference_program,
                      filename=params_filename, scope=scope)


def load_inference_model(dirname: str, executor=None, scope=None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None):
    """Load a native-format inference model directory. Returns (program,
    feed_names, fetch_vars)."""
    model_path = os.path.join(dirname, model_filename or _PROGRAM_FILE)
    with open(model_path, "rb") as f:
        raw = f.read()
    if raw[:1] != b"{":
        raise NotImplementedError(
            f"{model_path} is not a native JSON program (a Fluid ProgramDesc "
            "needs fluid_interop, not ported to paddle_tpu_torch yet)")
    program = Program.parse_from_string(raw)
    with open(os.path.join(dirname, "__meta__")) as f:
        meta = json.load(f)
    load_persistables(executor, dirname, program, filename=params_filename,
                      scope=scope)
    blk = program.global_block
    return program, meta["feed"], [blk.var(n) for n in meta["fetch"]]

