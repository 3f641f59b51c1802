"""Executor: runs a Program block eagerly, op by op, on torch tensors.

Port of `paddle_tpu/framework/executor.py`. The JAX executor traces a whole
block into one jitted XLA computation; here each op's torch rule runs in
turn under `torch.no_grad()` on the executor's device — the shape of the
reference's own C++ interpreter (paddle/fluid/framework/executor.cc:172
Executor::Run). Gradients are ops of the program (`*_grad`, built by
append_backward), not torch autograd, so nothing records a graph.

Scope tensors are ordinary tensors (not inference tensors) and are never
updated in place: an op that writes a var (an optimizer's ParamOut = Param,
Moment1Out = Moment1, ...) binds a new tensor to the name, and the
persistables a run wrote (startup init, optimizer state) go back into the
Scope when it ends. Tensors that io.load_* and io.set_params_from_numpy
put in a scope follow the same rule.

Places are real: `Executor()` runs on `CUDAPlace(0)`, `Executor(CPUPlace())`
on the CPU, and with no GPU and no explicit CPU place the constructor
raises — it never falls back to the CPU on its own.

Not yet ported (later slices): the compile cache and its recompile
attribution, buffer donation (in-place updates of the persistables), the
nan/inf sanitizer, host-boundary ops, training telemetry and the dataset
trainer loop.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .core import Program, Variable, default_main_program
from .registry import LowerContext, lower_op, torch_dtype
from ..observability.metrics import get_registry
from ..observability.tracer import trace_span, tracing_enabled

__all__ = ["Scope", "Executor", "global_scope", "scope_guard",
           "CPUPlace", "CUDAPlace", "classify_persistables"]


# ---------------------------------------------------------------------------
# places
# ---------------------------------------------------------------------------

class CPUPlace:
    """fluid.CPUPlace: run on the host CPU."""

    device = torch.device("cpu")

    def __repr__(self):
        return "CPUPlace()"


class CUDAPlace:
    """fluid.CUDAPlace(device_id): run on one CUDA card."""

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)
        self.device = torch.device("cuda", self.device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


def _resolve_place(place):
    if place is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "Executor(place=None) runs on CUDAPlace(0), but no CUDA "
                "device is available; pass Executor(CPUPlace()) to run on "
                "the CPU")
        return CUDAPlace(0)
    if isinstance(place, (CPUPlace, CUDAPlace)):
        if isinstance(place, CUDAPlace) and not torch.cuda.is_available():
            raise RuntimeError(
                f"{place!r} requested but no CUDA device is available; pass "
                "CPUPlace() to run on the CPU")
        return place
    raise TypeError(f"place must be CPUPlace() or CUDAPlace(i), got "
                    f"{place!r}")


# ---------------------------------------------------------------------------
# scopes
# ---------------------------------------------------------------------------

class Scope:
    """name -> torch tensor map; values persist across Executor.run calls."""

    def __init__(self):
        self._vars: Dict[str, Any] = {}

    def find_var(self, name: str):
        return self._vars.get(name)

    def set_var(self, name: str, value) -> None:
        self._vars[name] = value

    def erase(self, name: str) -> None:
        self._vars.pop(name, None)

    def var_names(self) -> List[str]:
        return list(self._vars)

    def __contains__(self, name: str) -> bool:
        return name in self._vars

    def get_numpy(self, name: str) -> np.ndarray:
        return _to_numpy(self._vars[name])


_global_scope = Scope()
_scope_stack = threading.local()


def global_scope() -> Scope:
    stack = getattr(_scope_stack, "stack", None)
    if stack:
        return stack[-1]
    return _global_scope


class scope_guard:
    def __init__(self, scope: Scope):
        self._scope = scope

    def __enter__(self):
        if not hasattr(_scope_stack, "stack"):
            _scope_stack.stack = []
        _scope_stack.stack.append(self._scope)
        return self

    def __exit__(self, *exc):
        _scope_stack.stack.pop()
        return False


# ---------------------------------------------------------------------------

def classify_persistables(program, feed_names: set, fetch_names):
    """Classify persistable vars: a var must come IN from the scope only if
    some op reads it before any op writes it; vars defined by earlier ops
    (e.g. params created by startup init ops) are internal. Returns
    (mutable, created, readonly):
      mutable  — read from and written back to the scope
      created  — produced by this program (startup init): written only
      readonly — read-only constants from the scope
    Copied from paddle_tpu's executor (the port has no macro or host ops
    yet, so there are no sub-blocks to flatten)."""
    blk = program.global_block
    written = set()
    external_reads = set()
    written_so_far = set(feed_names)
    for op in blk.ops:
        if op.type in ("feed", "fetch"):
            continue
        for n in op.input_names():
            if n not in written_so_far:
                external_reads.add(n)
        written.update(op.output_names())
        written_so_far.update(op.output_names())
    for n in fetch_names:
        if n not in written_so_far:
            external_reads.add(n)

    persist = {v.name for v in blk.vars.values() if v.persistable}
    mutable = sorted((persist & written & external_reads) - feed_names)
    created = sorted((persist & written) - set(mutable) - feed_names)
    readonly = sorted((persist & external_reads)
                      - set(mutable) - feed_names)
    return mutable, created, readonly


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _as_feed_tensor(value, var: Optional[Variable], device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        t = value
    else:
        arr = np.asarray(value)
        if var is not None and var.dtype is not None \
                and var.dtype != "bfloat16":
            arr = arr.astype(var.dtype, copy=False)
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if var is not None and var.dtype is not None:
        t = t.to(torch_dtype(var.dtype))
    return t.to(device)


class Executor:
    """fluid.Executor: `place` picks the device (see module docstring)."""

    def __init__(self, place=None):
        self.place = _resolve_place(place)
        self.device = self.place.device
        self._classify_cache: "OrderedDict[Any, Any]" = OrderedDict()
        self._cache_capacity = 64

    def _memo(self, cache, key, build):
        """LRU memoize into `cache` bounded by the shared capacity."""
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
            return hit
        val = build()
        cache[key] = val
        while len(cache) > self._cache_capacity:
            cache.popitem(last=False)
        return val

    # -- public API ---------------------------------------------------------
    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True):
        # progress heartbeat, as in paddle_tpu's executor: inflight goes up
        # while a run executes, runs_total advances when it returns
        reg = get_registry()
        runs = reg.counter("executor_runs_total",
                           "Executor.run calls completed").labels()
        inflight = reg.gauge("executor_inflight_runs",
                             "Executor.run calls currently "
                             "executing").labels()
        inflight.inc()
        try:
            with trace_span("executor/run", "executor"):
                out = self._run_impl(program, feed, fetch_list, scope,
                                     return_numpy)
            runs.inc()
            return out
        finally:
            inflight.dec()

    def _validate_preflight(self, program, feed):
        """Feed checks before any op runs: every data var the block reads
        must be fed, and a fed var's shape must match its declaration
        (-1 matches any size)."""
        blk = program.global_block
        read = {n for op in blk.ops for n in op.input_names()}
        for v in blk.vars.values():
            if v.is_data and v.name in read and v.name not in feed:
                raise ValueError(
                    f"data var {v.name!r} is read by the program but not "
                    f"fed (feed has {sorted(feed)})")
        for name, val in feed.items():
            var = blk.vars.get(name)
            if var is None or var.shape is None:
                continue
            shape = tuple(val.shape) if hasattr(val, "shape") \
                else np.shape(val)
            decl = tuple(var.shape)
            if len(shape) != len(decl) or any(
                    d != -1 and d != s for d, s in zip(decl, shape)):
                raise ValueError(
                    f"feed {name!r} has shape {list(shape)}, but the "
                    f"program declares {list(decl)}")

    def _run_impl(self, program, feed, fetch_list, scope, return_numpy):
        if program is None:
            program = default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        blk = program.global_block
        self._validate_preflight(program, feed)

        cls_key = (program._uid, program.version, frozenset(feed),
                   tuple(fetch_names))
        mutable, created, readonly = self._memo(
            self._classify_cache, cls_key,
            lambda: classify_persistables(program, set(feed), fetch_names))

        env: Dict[str, Any] = {}
        for n in list(readonly) + list(mutable):
            val = scope.find_var(n)
            if val is None:
                raise RuntimeError(
                    f"persistable var {n!r} not initialized in scope; "
                    "run the startup program first")
            if isinstance(val, torch.Tensor) and val.device != self.device:
                # a scope filled on another place: move it here once
                val = val.to(self.device)
                scope.set_var(n, val)
            env[n] = val
        for k, v in feed.items():
            env[k] = _as_feed_tensor(v, blk.vars.get(k), self.device)

        # per-run generator: seeded from the program's random_seed and a
        # run counter kept in the scope, so successive runs draw fresh
        # numbers and a fresh scope replays the same stream
        run_idx = scope.find_var("@RNG@")
        run_idx = 0 if run_idx is None else int(run_idx)
        scope.set_var("@RNG@", run_idx + 1)
        ctx = LowerContext(device=self.device,
                           seed=int(program.random_seed) * 1000003 + run_idx)

        ops = [op for op in blk.ops if op.type not in ("feed", "fetch")]
        trace_ops = tracing_enabled()
        with torch.no_grad():
            for i, op in enumerate(ops):
                if trace_ops:
                    with trace_span(op.type, "op",
                                    {"op_index": i,
                                     "inputs": ",".join(op.input_names()),
                                     "outputs": ",".join(
                                         op.output_names())}):
                        lower_op(ctx, op, env)
                else:
                    lower_op(ctx, op, env)

        for n in list(mutable) + list(created):
            scope.set_var(n, env[n])
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch target(s) {missing} are not produced by "
                           "the program, fed, or held in the scope")
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches

    def close(self):
        self._classify_cache.clear()
