"""Executor: runs a Program block eagerly, op by op, on torch tensors.

Port of `paddle_tpu/framework/executor.py`. The JAX executor traces a whole
block into one jitted XLA computation; here each op's torch rule runs in
turn under `torch.no_grad()` on the executor's device — the shape of the
reference's own C++ interpreter (paddle/fluid/framework/executor.cc:172
Executor::Run). Gradients are ops of the program (`*_grad`, built by
append_backward), not torch autograd, so nothing records a graph.

The compile cache keeps JAX's key and counters: a cache entry ("the
compiled step") is the prepared plan for one (program, version, feed
signature, fetch list, scope split) key — the op list with each op's rule
resolved, the mutable/created/read-only split, the sanitizer setting and
the output names — in an LRU of `cache_capacity` entries, with
`compile_count`, the `executor_cache_*` counters, and recompile
attribution (`executor_recompiles_total{cause}`, `recompile_log`).

Donation (`donate=True`, the default) is in-place update: a mutable
persistable that this executor bound in the scope on an earlier run is
written by the optimizer rules (the update ops of ops/optimizer_ops.py)
in the storage it already has, so a step holds no second copy of the
parameters and the optimizer state. A tensor put into the scope by anyone else (the user,
io.load_*, io.set_params_from_numpy, another executor) is never written in
place: the first run binds a new tensor to the name, and later runs update
that one. A caller that keeps a reference to a tensor this executor bound
sees it change, as a donated buffer is consumed in JAX (a fetched
persistable is a copy); `donate=False` binds a new tensor for every write.

FLAGS_check_nan_inf=1 keeps a device-side all-finite flag for every
floating output of every op and reads them once, after the block has run.
While a `train_stats.StepLogger` is installed, a program that carries the
telemetry tap fetches its loss, grad-norm, flag and lr with the user's
fetches and logs one step record.

Places are real: `Executor()` runs on `CUDAPlace(0)`, `Executor(CPUPlace())`
on the CPU, and with no GPU and no explicit CPU place the constructor
raises — it never falls back to the CPU on its own.

Control flow (while, conditional_block, recurrent) runs as macro ops
(ops/control_flow_ops.py) that loop and branch over their sub-blocks in
Python, inside the one op sequence; a sub-block's ops run without
donation, and no update op before the last macro grad op of a block is
donated, so a value a macro stashed for its grad replay is never written
in place before the replay reads it.

Host-boundary ops (`registry.register_host_op`: save/load, the readers)
run against the scope outside the op sequence, as in the JAX executor:
those before the first compute op run before the step (a load, a read
that puts its batch into the run's feed), those after the last compute op
after it, on the post-step scope (a save reads the updated values); a host
op between compute ops raises JAX's message, and a host-only program
(a save or load program) runs its host ops and nothing else. Each runs
under a `host/<type>` span on the executor's device.

A parameter-server trainer program (one that DistributeTranspiler
rewrote; it carries a `_ps_plan`) runs as in the JAX executor: the plan's
`ensure_init` and `before_step` (the sparse prefetch) on the host, the
step itself by a re-entrant `run` that also fetches the plan's gradients
and learning rates, then `after_step` (the pushes and the dense pull).
The names in the program's `_sparse_fetch_names` are fetched as raw
SelectedRows (rows and values go over the wire, not a vocabulary-sized
dense buffer); every other fetched SelectedRows is densified. The
re-entry flag is the executor instance's, so trainers on threads, each
with its own executor, run side by side.

Not yet ported: the dataset trainer loop
(`train_from_dataset`/`infer_from_dataset`, A.12) and `capture_hlo`
(A.8).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .core import Program, Variable, default_main_program
from .registry import (_HOST_OPS, _MACROS, LowerContext, dtype_name,
                       lower_op, resolve_op, torch_dtype)
from .selected_rows import SelectedRows, to_dense
from ..observability.metrics import get_registry
from ..observability.tracer import trace_span, tracing_enabled
from ..observability import train_stats as _train_stats

__all__ = ["Scope", "Executor", "global_scope", "scope_guard",
           "CPUPlace", "CUDAPlace", "classify_persistables",
           "as_torch_function"]


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
    """name -> torch tensor map; values persist across Executor.run calls.

    Each name also records which executor bound its tensor, if one did:
    `set_var` clears that, so only a tensor an executor bound itself is
    ever donated (written in place) by that executor."""

    def __init__(self):
        self._vars: Dict[str, Any] = {}
        self._bound_by: Dict[str, object] = {}

    def find_var(self, name: str):
        return self._vars.get(name)

    def set_var(self, name: str, value) -> None:
        self._vars[name] = value
        self._bound_by.pop(name, None)

    def _bind(self, name: str, value, owner: object) -> None:
        """An executor's write: the tensor is `owner`'s to donate."""
        self._vars[name] = value
        self._bound_by[name] = owner

    def erase(self, name: str) -> None:
        self._vars.pop(name, None)
        self._bound_by.pop(name, None)

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
    Copied from paddle_tpu's executor: a macro op's sub-block reads are
    reads of the macro op, its outputs are implicit reads, and sub-block
    locals are never persistables."""
    blk = program.global_block

    def _expand(ops):
        # Flatten macro ops' sub-blocks for read/write classification
        # (sub-block reads are reads of the enclosing op). The macro op
        # is yielded BEFORE its sub-block ops: its implicit reads
        # (carry-in / branch pass-through) happen before any write
        # inside it.
        for op in ops:
            yield op
            for key in ("sub_block", "sub_block_t", "sub_block_f"):
                if key in op.attrs:
                    yield from _expand(program.blocks[op.attrs[key]].ops)

    written = set()
    external_reads = set()
    written_so_far = set(feed_names)
    sub_local = set()
    for b in program.blocks[1:]:
        sub_local.update(b.vars)
    macro_attrs = ("sub_block", "sub_block_t", "sub_block_f")
    for op in _expand(blk.ops):
        if op.type in ("feed", "fetch") or op.type in _HOST_OPS:
            continue
        reads = list(op.input_names())
        if any(k in op.attrs for k in macro_attrs):
            # a macro op's outputs are also implicit reads: while carries
            # state in, conditional_block's untaken branch passes values
            # through
            reads += op.output_names()
        for n in reads:
            if n not in written_so_far and n not in sub_local:
                external_reads.add(n)
        outs = [n for n in op.output_names() if n not in sub_local]
        written.update(outs)
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
    """A host copy: never a view of a tensor the executor may later
    update in place. A tensor array (a tuple in the environment) comes
    back stacked, as numpy stacks JAX's tuple."""
    if isinstance(t, (tuple, list)):
        return np.asarray([_to_numpy(v) for v in t])
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()
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


def _split_host_ops(blk):
    """(host prefix, host suffix, any compute op) of a block, as the JAX
    executor splits it (paddle_tpu/framework/executor.py:358-369): host
    ops before the first compute op, host ops after the last; a host op
    between compute ops raises."""
    pre, post = [], []
    compute_seen = False
    for op in blk.ops:
        if op.type in _HOST_OPS:
            (post if compute_seen else pre).append(op)
        elif op.type not in ("feed", "fetch"):
            compute_seen = True
            if post:
                raise RuntimeError(
                    f"host-boundary op(s) "
                    f"{[o.type for o in post]} appear between "
                    f"compute ops; split the program (the reference "
                    f"emits separate save/load programs too)")
    return pre, post, compute_seen


def _sig(v):
    """(shape, dtype name) of a feed value, as the JAX executor keys it."""
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), dtype_name(v.dtype)
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        return tuple(v.shape), str(v.dtype)
    a = np.asarray(v)
    return tuple(a.shape), str(a.dtype)


def _nbytes(v) -> int:
    if isinstance(v, SelectedRows):
        return _nbytes(v.rows) + _nbytes(v.values)
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return int(getattr(v, "nbytes", 0) or 0)


class _Step:
    """The compiled step: one cache entry's prepared plan. `ops` pairs
    each op with its resolved OpDef; `donatable` maps an optimizer op's
    index to its (input slot, var name) pairs whose output writes the same
    name, with the dtype and shape the var declares; an update op before
    the block's last macro grad op is not donatable (the macro's stashed
    entry values must reach its grad replay unchanged). Holds nothing of
    a run's tensors."""

    def __init__(self, program, fetch_names, mutable, created, readonly):
        blk = program.global_block
        self.ops = [(op, resolve_op(op)) for op in blk.ops
                    if op.type not in ("feed", "fetch")
                    and op.type not in _HOST_OPS]
        self.fetch_names = list(fetch_names)
        self.mutable, self.created = list(mutable), list(created)
        self.readonly = list(readonly)
        self.out_names = self.mutable + self.created
        self.check_nan_inf = os.environ.get("FLAGS_check_nan_inf",
                                            "0") == "1"
        mut = set(mutable)
        last_macro_grad = max(
            (i for i, (op, _) in enumerate(self.ops)
             if op.type.endswith("_grad") and op.type in _MACROS),
            default=-1)
        self.donatable: Dict[int, List] = {}
        for i, (op, opdef) in enumerate(self.ops):
            if not opdef.is_optimizer_op or i < last_macro_grad:
                continue
            pairs = []
            for slot, names in op.inputs.items():
                outs = op.outputs.get(slot + "Out", [])
                if len(names) == 1 and outs == names and names[0] in mut:
                    var = blk.vars[names[0]]
                    pairs.append((slot, names[0], torch_dtype(var.dtype),
                                  tuple(var.shape)))
            if pairs:
                self.donatable[i] = pairs


class Executor:
    """fluid.Executor: `place` picks the device (see module docstring)."""

    def __init__(self, place=None, donate: bool = True,
                 cache_capacity: Optional[int] = None):
        """donate=False binds a new tensor for every write, leaving every
        tensor a caller may hold untouched, at the cost of a second copy
        of the parameters and optimizer state during the update.

        cache_capacity bounds the compiled-step cache (LRU). Default from
        FLAGS_executor_cache_capacity (64)."""
        self.place = _resolve_place(place)
        self.device = self.place.device
        self._donate = donate
        self._cache: "OrderedDict[Any, _Step]" = OrderedDict()
        self._classify_cache: "OrderedDict[Any, Any]" = OrderedDict()
        self._compile_stats: Dict[Any, Dict[str, Any]] = {}
        self._cache_capacity = int(
            cache_capacity if cache_capacity is not None
            else os.environ.get("FLAGS_executor_cache_capacity", "64"))
        self.compile_count = 0  # distinct compilations (tests/telemetry)
        # run(validate=True) pre-flight reports and the feed checks' read
        # sets, keyed like the compile cache; LRU via _memo
        self._validated: "OrderedDict[Any, Any]" = OrderedDict()
        self._data_reads: "OrderedDict[Any, Any]" = OrderedDict()
        # programs ever compiled, cache-residency-independent: a miss for
        # a known uid whose entries were all LRU-evicted is a recompile
        # (cause="evicted"), not a first compile
        self._compiled_uids = set()
        # structured "why" records for misses after a program's first
        # compile; also mirrored into train_stats.recompile_log()
        self.recompile_log: "deque[Dict[str, Any]]" = deque(maxlen=64)
        self.last_fetch_names: List[str] = []  # incl. telemetry extras
        self._token = object()  # marks the scope tensors this one bound
        self._ps_reentry = False  # inside _run_ps's run of the step

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
            return_numpy: bool = True,
            validate: bool = False):
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
                                     return_numpy, validate)
            runs.inc()
            return out
        finally:
            inflight.dec()

    def _validate_preflight(self, program, feed, fetch_names):
        """Opt-in static verification before any op runs: a malformed
        program raises ProgramVerificationError with the diagnostic (code
        + op + var). Memoized per (program, version, feed set, fetch
        list); verification is read-only, so the compile cache and the
        program's bytes are untouched either way."""
        from ..analysis import ProgramVerificationError, verify_program
        key = (program._uid, program.version, frozenset(feed),
               tuple(fetch_names))
        cached = self._memo(
            self._validated, key,
            lambda: verify_program(program, fetch_list=fetch_names,
                                   feed_names=set(feed)))
        if not cached.ok:
            raise ProgramVerificationError(cached, program)

    def _check_feed(self, program, feed):
        """Feed checks before any op runs: every data var the block reads
        must be fed, and a fed var's shape must match its declaration
        (-1 matches any size)."""
        blk = program.global_block
        data_read = self._memo(
            self._data_reads, (program._uid, program.version),
            lambda: sorted({n for op in blk.ops for n in op.input_names()
                            if n in blk.vars and blk.vars[n].is_data}))
        for n in data_read:
            if n not in feed:
                raise ValueError(
                    f"data var {n!r} is read by the program but not "
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

    def _run_impl(self, program, feed, fetch_list, scope, return_numpy,
                  validate=False):
        from ..compiler import CompiledProgram  # lazy import

        reg = get_registry()
        if program is None:
            program = default_main_program()
        dist_plan = None
        if isinstance(program, CompiledProgram):
            dist_plan = program._plan()
            program = program._program
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        if validate:
            self._validate_preflight(program, feed, fetch_names)
        # parameter-server trainer program: the step bracketed by host
        # push/pull through the pskv service (transpiler/
        # distribute_transpiler.py)
        ps_plan = getattr(program, "_ps_plan", None)
        if ps_plan is not None and not self._ps_reentry:
            return self._run_ps(program, feed, fetch_names, scope,
                                return_numpy, ps_plan)
        if getattr(self, "capture_hlo", False):
            raise NotImplementedError(
                "Executor.capture_hlo (the optimized HLO that "
                "tools/comm_volume.py reads) has no counterpart in the "
                "eager executor (ROADMAP A.8)")

        blk = program.global_block
        # Host-boundary ops run against the scope: the prefix now (a read
        # puts its batch into this run's feed, a copy of the caller's), the
        # suffix after the step, on the post-step scope
        host_pre, host_post, compute_seen = _split_host_ops(blk)
        if host_pre or host_post:
            feed = dict(feed)
        self._run_host_ops(host_pre, scope, feed)
        if not compute_seen:
            # host-only program (save/load programs): everything already
            # ran in the prefix; the fetches come from the scope, as the
            # JAX executor's do (no cache entry)
            return [_to_numpy(scope.find_var(f)) if return_numpy
                    else scope.find_var(f) for f in fetch_names]
        self._check_feed(program, feed)

        # Training telemetry (observability/train_stats.py): a program
        # whose minimize() attached the tap carries the loss/grad-norm/
        # sentinel-flag var names; while a StepLogger is installed those
        # ride along in the same fetch list. No logger => the fetch list
        # is exactly the user's.
        tele = getattr(program, "_train_telemetry", None)
        tele_logger = _train_stats.get_step_logger() if tele else None
        all_fetch = list(fetch_names)
        if tele_logger is not None:
            seen = set(all_fetch)
            for k in ("loss", "grad_norm", "flag", "lr"):
                n = tele.get(k)
                if n and n not in seen:
                    all_fetch.append(n)
                    seen.add(n)
        self.last_fetch_names = list(all_fetch)

        cls_key = (program._uid, program.version, frozenset(feed),
                   tuple(all_fetch))
        mutable, created, readonly = self._memo(
            self._classify_cache, cls_key,
            lambda: classify_persistables(program, set(feed), all_fetch))

        feed_sig = tuple(sorted((k,) + _sig(v) for k, v in feed.items()))
        cache_key = (program._uid, program.version, feed_sig,
                     tuple(all_fetch), tuple(mutable), tuple(readonly),
                     id(dist_plan) if dist_plan else None)

        # Compile-cache lookup with hit/miss/eviction counters and, on
        # every miss after a program's first compile, recompilation
        # attribution: which ingredient changed vs. the nearest cached
        # key. Counters are always on (StepLogger or not).
        was_miss = False
        step = self._cache.get(cache_key)
        if step is not None:
            self._cache.move_to_end(cache_key)
            reg.counter("executor_cache_hits_total",
                        "compile-cache hits").inc()
        else:
            was_miss = True
            reg.counter("executor_cache_misses_total",
                        "compile-cache misses (compilations)").inc()
            cause, detail = self._attribute_recompile(cache_key)
            if cause != "first_compile":
                reg.counter(
                    "executor_recompiles_total",
                    "compile-cache misses after a program's first "
                    "compile, by cause").labels(cause=cause).inc()
                rec = {"ts": time.time(), "cause": cause, "detail": detail,
                       "program": str(cache_key[0])[:8],
                       "compile_index": self.compile_count + 1}
                self.recompile_log.append(rec)
                _train_stats.record_recompile(rec)
            self.compile_count += 1
            with trace_span("executor/compile", "executor",
                            {"ops": len(blk.ops),
                             "fetches": len(all_fetch),
                             "cause": cause}):
                step = _Step(program, all_fetch, mutable, created,
                             readonly)
            self._cache[cache_key] = step
            self._compiled_uids.add(cache_key[0])
            while len(self._cache) > self._cache_capacity:
                old_key, _ = self._cache.popitem(last=False)
                self._compile_stats.pop(old_key, None)
                reg.counter("executor_cache_evictions_total",
                            "compile-cache LRU evictions").inc()
        reg.gauge("executor_cache_size",
                  "compiled executables cached").set(len(self._cache))

        env: Dict[str, Any] = {}
        owned = set()
        for n in step.readonly + step.mutable:
            val = scope.find_var(n)
            if val is None:
                raise RuntimeError(
                    f"persistable var {n!r} not initialized in scope; "
                    "run the startup program first")
            if isinstance(val, torch.Tensor) and val.device != self.device:
                # a scope filled on another place: move it here once
                val = val.to(self.device)
                scope._bind(n, val, self._token)
            if scope._bound_by.get(n) is self._token:
                owned.add(n)
            env[n] = val
        feed_in = {k: _as_feed_tensor(v, blk.vars.get(k), self.device)
                   for k, v in feed.items()}
        env.update(feed_in)
        scope_in = {n: env[n] for n in step.mutable} if self._donate else {}

        # per-run generator: seeded from the program's random_seed and a
        # run counter kept in the scope, so successive runs draw fresh
        # numbers and a fresh scope replays the same stream
        run_idx = scope.find_var("@RNG@")
        run_idx = 0 if run_idx is None else int(run_idx)
        scope.set_var("@RNG@", run_idx + 1)
        ctx = LowerContext(device=self.device,
                           seed=int(program.random_seed) * 1000003 + run_idx)

        analyze = tele_logger is not None and was_miss
        if analyze:
            stats, flop_mode = self._analyze_begin(env)
        t0 = time.perf_counter()
        flags = self._run_ops(step, ctx, env, scope_in, owned,
                              flop_mode if analyze else None)

        for n in step.out_names:
            scope._bind(n, env[n], self._token)
        self._run_host_ops(host_post, scope, feed)  # saves see the update
        missing = [n for n in all_fetch if n not in env]
        if missing:
            raise KeyError(f"fetch target(s) {missing} are not produced by "
                           "the program, fed, or held in the scope")
        # fetched SelectedRows densify at the boundary, as in the JAX
        # executor, except the names the PS runtime wants raw (rows and
        # values go over the wire, not a dense vocabulary-sized buffer)
        sparse_keep = getattr(program, "_sparse_fetch_names", ())
        fetches = [env[n] if n in sparse_keep else to_dense(env[n])
                   for n in all_fetch]
        if self._donate and not return_numpy:
            # a fetched persistable is this step's value: a copy, which no
            # later in-place update of the scope's tensor reaches
            outs = set(step.out_names)
            fetches = [f.clone() if n in outs and isinstance(f, torch.Tensor)
                       else f for n, f in zip(all_fetch, fetches)]

        if flags:
            # FLAGS_check_nan_inf: one host read for the whole block
            ok = torch.stack([f for _, f in flags]).cpu().tolist()
            for (tag, _), good in zip(flags, ok):
                if not good:
                    idx, op_type, var = tag.split(":", 2)
                    raise FloatingPointError(
                        f"nan/inf detected in output {var!r} of op "
                        f"#{idx} ({op_type}) — FLAGS_check_nan_inf")

        if tele_logger is not None:
            if analyze:
                self._compile_stats[cache_key] = self._analyze_end(
                    stats, flop_mode, step, env, fetches, reg)
            fetches = self._log_step_telemetry(
                tele, tele_logger, all_fetch, fetch_names, fetches,
                feed_in, scope, cache_key, was_miss, t0, reg)

        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return list(fetches)

    def _run_ps(self, program, feed, fetch_names, scope, return_numpy,
                plan):
        """The PS trainer step (JAX executor :681-700): ensure_init and the
        sparse prefetch, the step with the plan's extra fetches, then the
        pushes and the dense pull. A dense parameter fetched as a tensor is
        a copy: the pull writes the scope's tensor in place."""
        plan.ensure_init(scope)
        plan.before_step(scope, feed)
        extra = [n for n in plan.extra_fetches()
                 if n not in set(fetch_names)]
        self._ps_reentry = True
        try:
            with trace_span("ps/step", "ps"):
                raw = self.run(program, feed=feed,
                               fetch_list=fetch_names + extra, scope=scope,
                               return_numpy=False)
        finally:
            self._ps_reentry = False
        outs = raw[:len(fetch_names)]
        if not return_numpy:
            dense = {s.name for s in plan.specs if not s.sparse}
            outs = [o.clone() if n in dense and isinstance(o, torch.Tensor)
                    else o for n, o in zip(fetch_names, outs)]
        plan.after_step(scope, dict(zip(fetch_names + extra, raw)))
        if return_numpy:
            return [_to_numpy(to_dense(o)) for o in outs]
        return outs

    def _run_host_ops(self, ops, scope, feed):
        for op in ops:
            with trace_span(f"host/{op.type}", "host"):
                _HOST_OPS[op.type](op, scope, feed, self.device)

    def _run_ops(self, step, ctx, env, scope_in, owned, flop_mode):
        """Run the plan's ops on `env`. An optimizer op gets, in
        `ctx.inplace`, the slots it may write in place: a donatable var
        this executor bound in the scope, still holding the scope's tensor
        in `env`, of the declared dtype and shape. Returns the sanitizer's
        (tag, device flag) pairs."""
        trace_ops = tracing_enabled()
        flags = []
        with torch.no_grad(), (flop_mode if flop_mode is not None
                               else contextlib.nullcontext()):
            for i, (op, opdef) in enumerate(step.ops):
                pairs = step.donatable.get(i)
                if pairs and scope_in:
                    ctx.inplace = frozenset(
                        slot for slot, n, dt, shape in pairs
                        if n in owned and env[n] is scope_in.get(n)
                        and env[n].dtype == dt
                        and tuple(env[n].shape) == shape)
                if trace_ops:
                    with trace_span(op.type, "op",
                                    {"op_index": i,
                                     "inputs": ",".join(op.input_names()),
                                     "outputs": ",".join(
                                         op.output_names())}):
                        lower_op(ctx, op, env, opdef)
                else:
                    lower_op(ctx, op, env, opdef)
                ctx.inplace = frozenset()
                if step.check_nan_inf:
                    # FLAGS_check_nan_inf sanitizer (reference:
                    # operator.cc:949 CheckNanInf), read after the block
                    for n in op.output_names():
                        v = env.get(n)
                        if isinstance(v, SelectedRows):
                            v = v.values
                        if isinstance(v, torch.Tensor) and (
                                v.is_floating_point() or v.is_complex()):
                            flags.append((f"{i}:{op.type}:{n}",
                                          torch.isfinite(v).all()))
        return flags

    # -- training telemetry (observability/train_stats.py) -------------------
    def _analyze_begin(self, env):
        """Start the first run of a compiled step under a StepLogger: the
        card's peak-memory counter reset, and a FLOP counter around the
        ops (the counterpart of the JAX executor's cost and memory
        analysis of a new executable)."""
        from torch.utils.flop_counter import FlopCounterMode
        stats: Dict[str, Any] = {"flops": None, "temp_bytes": None,
                                 "argument_bytes": sum(
                                     _nbytes(v) for v in env.values()),
                                 "output_bytes": None, "peak_bytes": None}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            stats["_base"] = torch.cuda.memory_allocated(self.device)
        return stats, FlopCounterMode(display=False)

    def _analyze_end(self, stats, flop_mode, step, env, fetches, reg):
        """FLOPs torch counted (matmuls, convolutions, attention through
        torch; a hand-written kernel bound through ctypes, such as the
        flash kernels on the card, is not counted) and the card's peak
        bytes over the run; None where the place cannot say."""
        flops = float(flop_mode.get_total_flops())
        stats["flops"] = flops if flops > 0 else None
        stats["output_bytes"] = sum(
            _nbytes(env[n]) for n in step.out_names) + sum(
            _nbytes(f) for f in fetches)
        base = stats.pop("_base", None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            stats["peak_bytes"] = int(
                torch.cuda.max_memory_allocated(self.device))
            stats["temp_bytes"] = stats["peak_bytes"] - base
            reg.gauge("executor_compile_temp_bytes",
                      "device bytes allocated above the run's start, at "
                      "the peak of the last compile's first run").set(
                stats["temp_bytes"])
            reg.gauge("executor_compile_peak_bytes",
                      "peak device bytes of the last compile's first "
                      "run").set(stats["peak_bytes"])
        return stats

    def _log_step_telemetry(self, tele, logger, all_fetch, fetch_names,
                            fetches, feed_in, scope, cache_key, was_miss,
                            t0, reg):
        """Convert the telemetry fetches (the same fetch list as the
        user's) into one StepLogger record; returns the user-visible
        fetch slice. The step time ends in a synchronise on the card."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        step_time = time.perf_counter() - t0
        by_name = dict(zip(all_fetch, fetches))

        def _scalar(name):
            if name is None or name not in by_name:
                return None
            try:
                return float(_to_numpy(by_name[name]).ravel()[0])
            except (TypeError, ValueError, IndexError):
                return None

        loss = _scalar(tele.get("loss"))
        gnorm = _scalar(tele.get("grad_norm"))
        lr = _scalar(tele.get("lr"))
        flag = by_name.get(tele.get("flag"))
        finite = bool(_to_numpy(flag).ravel()[0]) if flag is not None \
            else True

        # batch size = the largest leading dim across feeds (a (1,)
        # scalar feed like an lr scale must not masquerade as the batch)
        examples = tokens = None
        dims = [int(v.shape[0]) for v in feed_in.values() if v.ndim]
        if dims:
            examples = max(dims)
        # tokens = the LARGEST integer feed (the token ids), not the sum
        # — an integer label/mask feed alongside must not double-count
        int_sizes = [v.numel() for v in feed_in.values()
                     if not v.is_floating_point() and not v.is_complex()
                     and v.dtype != torch.bool]
        if int_sizes:
            tokens = max(int_sizes)

        scope_bytes = sum(_nbytes(scope.find_var(n))
                          for n in scope.var_names())
        reg.gauge("executor_scope_live_bytes",
                  "bytes held by scope device arrays").set(scope_bytes)

        logger.log_step(
            loss=loss, grad_norm=gnorm, lr=lr, finite=finite,
            step_time_s=step_time, examples=examples, tokens=tokens,
            compiled=was_miss,
            compile_stats=self._compile_stats.get(cache_key),
            scope_bytes=scope_bytes, program=str(cache_key[0])[:8])
        return fetches[:len(fetch_names)]

    def _attribute_recompile(self, key):
        """Why did this compile-cache miss happen? Compare against the
        nearest cached key (same program preferred) and name the first
        differing ingredient. Returns (cause, detail)."""
        uid, version, feed_sig, fetch, mutable, readonly, dist = key
        same_prog = [k for k in self._cache if k[0] == uid]
        if not same_prog:
            if uid in self._compiled_uids:
                return "evicted", {"cache_capacity": self._cache_capacity}
            return "first_compile", {}

        def _score(k):
            return sum(a == b for a, b in zip(k, key))

        near = max(same_prog, key=_score)
        if near[1] != version:
            return "program_version", {"from": near[1], "to": version}
        if near[2] != feed_sig:
            old = {n: (s, d) for n, s, d in near[2]}
            new = {n: (s, d) for n, s, d in feed_sig}
            for n in sorted(set(old) & set(new)):
                if old[n][0] != new[n][0]:
                    return "feed_shape", {"var": n,
                                          "from": list(old[n][0]),
                                          "to": list(new[n][0])}
            for n in sorted(set(old) & set(new)):
                if old[n][1] != new[n][1]:
                    return "feed_dtype", {"var": n, "from": old[n][1],
                                          "to": new[n][1]}
            return "feed_set", {"added": sorted(set(new) - set(old)),
                                "removed": sorted(set(old) - set(new))}
        if near[3] != fetch:
            return "fetch_list", {"added": sorted(set(fetch) - set(near[3])),
                                  "removed": sorted(set(near[3])
                                                    - set(fetch))}
        if near[4] != mutable or near[5] != readonly:
            return "scope_classification", {}
        if near[6] != dist:
            return "dist_plan", {}
        return "unknown", {}

    # -- not ported yet ------------------------------------------------------
    def train_from_dataset(self, *args, **kwargs):
        raise NotImplementedError(
            "Executor.train_from_dataset is not ported to paddle_tpu_torch "
            "yet (ROADMAP A.12: dataset.py)")

    def infer_from_dataset(self, *args, **kwargs):
        raise NotImplementedError(
            "Executor.infer_from_dataset is not ported to paddle_tpu_torch "
            "yet (ROADMAP A.12: dataset.py)")

    # -- utilities -----------------------------------------------------------
    def close(self):
        self._cache.clear()
        self._compile_stats.clear()
        self._classify_cache.clear()


# ---------------------------------------------------------------------------
# a program block as a plain function
# ---------------------------------------------------------------------------

def as_torch_function(program: Program, fetch_list, is_test: bool = True,
                      seed: int = 0, device=None):
    """Export a program block as a function of torch tensors,
    fn(scope_vals: dict[str, Tensor], feed_vals: dict[str, Tensor]) ->
    list[Tensor]: the counterpart of the JAX package's `as_jax_function`
    (paddle_tpu/framework/executor.py:871), which the decoders' step
    functions call.

    is_test=True exports the clone(for_test=True) view (dropout and
    batch_norm in inference mode, backward and optimizer ops pruned). Each
    call lowers the ops through `lower_op` with a fresh `LowerContext`
    whose `torch.Generator` is seeded with `seed`, so a call is a pure
    function of its inputs. It runs on the device of the tensors passed in
    (numpy values become tensors there) and never moves a tensor. When no
    input is a tensor it runs on `device`, by default the CUDA card (no
    card raises: it never runs on the CPU unless asked); a `device` that
    differs from the tensors' raises. XLA
    drops the ops that no fetch reads when the JAX function is jitted; the
    eager function does not run them at all (an op that draws random
    numbers is kept, so the draws of the others stay in place).
    """
    fetch_names = [f.name if isinstance(f, Variable) else f
                   for f in fetch_list]
    if is_test:
        program = program.clone(for_test=True)
    host = [op.type for op in program.global_block.ops
            if op.type in _HOST_OPS]
    if host:
        raise ValueError(
            f"as_torch_function: program contains host-boundary op(s) "
            f"{host} (file IO / RPC / readers) that cannot lower into a "
            f"plain torch function; run it through Executor.run instead")
    needed = set(fetch_names)
    ops = []
    for op in reversed(program.global_block.ops):
        if op.type in ("feed", "fetch"):
            continue
        opdef = resolve_op(op)
        if needed & set(op.output_names()) or (
                opdef.stateful and not op.type.endswith("_grad")):
            ops.append((op, opdef))
            needed.update(op.input_names())
            for key in ("sub_block", "sub_block_t", "sub_block_f"):
                if key in op.attrs:
                    # a macro's closure: what its sub-blocks read outside
                    from ..ops.control_flow_ops import _block_outer_reads
                    needed.update(_block_outer_reads(
                        program, program.blocks[op.attrs[key]]))
    ops.reverse()
    want = None if device is None else torch.device(device)
    if want is not None and want.type == "cuda" and want.index is None:
        want = torch.device("cuda", torch.cuda.current_device())

    def fn(scope_vals, feed_vals):
        tensors = [v for v in list(scope_vals.values())
                   + list(feed_vals.values()) if isinstance(v, torch.Tensor)]
        devices = {t.device for t in tensors}
        if len(devices) > 1:
            raise ValueError(
                f"as_torch_function: inputs lie on several devices "
                f"{sorted(map(str, devices))}; pass them on one")
        if devices:
            device = devices.pop()
            if want is not None and device != want:
                raise ValueError(
                    f"as_torch_function: inputs lie on {device}, the "
                    f"function was made for {want}; it moves no tensor")
        elif want is not None:
            device = want
        elif torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            raise RuntimeError(
                "as_torch_function runs on the CUDA card when no input is a "
                "tensor and none is available; pass device='cpu' to run on "
                "the CPU")
        env = {k: v if isinstance(v, torch.Tensor)
               else torch.as_tensor(np.asarray(v), device=device)
               for d in (scope_vals, feed_vals) for k, v in d.items()}
        ctx = LowerContext(device=device, seed=seed)
        with torch.no_grad():
            for op, opdef in ops:
                lower_op(ctx, op, env, opdef)
        return [env[n] for n in fetch_names]

    return fn
