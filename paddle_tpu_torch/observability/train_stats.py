"""Training telemetry plane: per-step scalars, numerics sentinel,

A copy of `paddle_tpu/observability/train_stats.py` (pure Python): the
StepLogger, its ring and the recompile log, which the debug server's
/trainz reads, and `attach_step_telemetry`, the graph-side tap that
`Optimizer.minimize` attaches while a logger is installed. The port's
Executor feeds them (`_log_step_telemetry`, the recompile records).
recompilation attribution.

The serving path got its observability in PRs 2-3 (tracer, registry,
debug server); this module is the TRAINING analog of the reference's
profiler/model_stat territory (tools/timeline.py, contrib/model_stat.py,
contrib/op_frequence.py): per-step truth — loss, learning rate, global
grad-norm, throughput, recompiles, memory — while the job runs, not
post-hoc.

Three pieces:

* `StepLogger` — records one structured record per Executor step into
  the process-wide metrics registry (``train_*`` gauges/histograms,
  ``train_steps_total``, ``nan_steps_total{policy=}``) AND an
  append-only JSONL event log with bounded rotation
  (`tools/train_summary.py` renders it). Install with
  `install_step_logger()` (or the `step_logging()` context manager)
  BEFORE building the training program: `Optimizer.minimize` attaches
  the telemetry tap at graph-build time.

* **Numerics sentinel** — `attach_step_telemetry` builds, in-graph, a
  single scalar finiteness flag over (loss, global grad-norm). The flag
  is fetched WITH the step's existing outputs — one computation,
  no extra device->host round trip. Policy:
    - ``"warn"``      count + warn, step applies normally
    - ``"skip_step"`` params/accumulators are gated in-graph
                      (``where(finite, new, pre)``) — a NaN step leaves
                      them bit-identical to the pre-step snapshot
    - ``"halt"``      gate like skip_step, then raise
                      FloatingPointError host-side (the checkpoint is
                      never poisoned)

* **Recompile log** — the Executor reports every compile-cache miss
  after the first with a structured "why" record (which feed shape /
  dtype / program fingerprint changed vs. the nearest cached key);
  this module keeps the bounded process-wide log that `/trainz` and
  the JSONL serve.

Stdlib-only at import (framework imports are lazy): safe to import from
the executor without cycles.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional

from .metrics import get_registry

__all__ = ["StepLogger", "install_step_logger", "uninstall_step_logger",
           "get_step_logger", "step_logging", "attach_step_telemetry",
           "record_recompile", "recompile_log", "POLICIES"]

POLICIES = ("warn", "skip_step", "halt")

# -- process-wide recompile log ---------------------------------------------
# Fed by Executor on every compile-cache miss after a program's first
# compile; bounded so a shape-churning job can't grow it without limit.
_RECOMPILES: "deque[Dict[str, Any]]" = deque(maxlen=256)
_RECOMPILES_LOCK = threading.Lock()


def record_recompile(rec: Dict[str, Any]) -> None:
    """Append one recompilation "why" record (Executor calls this). The
    active StepLogger, if any, also journals it into the JSONL stream so
    `tools/train_summary.py` can annotate the step table."""
    with _RECOMPILES_LOCK:
        _RECOMPILES.append(dict(rec))
    logger = get_step_logger()
    if logger is not None:
        logger.event("recompile", **rec)


def recompile_log(limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Most recent recompilation records, oldest first."""
    with _RECOMPILES_LOCK:
        out = list(_RECOMPILES)
    if limit is not None and limit >= 0:
        out = out[-limit:] if limit else []
    return out


# -- step logger -------------------------------------------------------------


class StepLogger:
    """Per-step training scalars -> registry series + rotating JSONL.

    One record per Executor step of a telemetry-attached program:
    step id, loss, learning rate, global grad-norm, finiteness, step
    wall-time, examples/s, tokens/s, estimated MFU (cost-analysis
    flops / peak_flops), compile + device-memory accounting.

    `log_dir=None` keeps everything in memory (registry + `recent()`
    ring for `/trainz`); with a directory, records append to
    ``<log_dir>/<run_name>.jsonl`` rotated at `max_bytes` keeping
    `max_files` old generations (``.1`` newest).
    """

    def __init__(self, log_dir: Optional[str] = None,
                 run_name: str = "train", policy: str = "warn",
                 peak_flops: Optional[float] = None,
                 keep_recent: int = 256,
                 max_bytes: int = 8 << 20, max_files: int = 3,
                 registry=None):
        if policy not in POLICIES:
            raise ValueError(
                f"sentinel policy must be one of {POLICIES}, got {policy!r}")
        self.policy = policy
        self.run_name = run_name
        if peak_flops is None and os.environ.get("PEAK_TFLOPS"):
            peak_flops = float(os.environ["PEAK_TFLOPS"]) * 1e12
        self.peak_flops = peak_flops
        self._registry = registry or get_registry()
        self._lock = threading.Lock()
        self._recent: "deque[Dict[str, Any]]" = deque(maxlen=keep_recent)
        self._step = 0
        self._nan_steps = 0
        self._max_bytes = int(max_bytes)
        self._max_files = int(max_files)
        self.log_path: Optional[str] = None
        self._file = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self.log_path = os.path.join(log_dir, f"{run_name}.jsonl")
            self._file = open(self.log_path, "a", buffering=1)

    # -- properties ----------------------------------------------------------

    @property
    def step_count(self) -> int:
        return self._step

    @property
    def nan_steps(self) -> int:
        return self._nan_steps

    def recent(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """Latest step records, oldest first (`/trainz` backing store)."""
        with self._lock:
            out = list(self._recent)
        if n is not None and n >= 0:
            out = out[-n:] if n else []
        return out

    # -- JSONL ---------------------------------------------------------------

    def _rotate_locked(self) -> None:
        self._file.close()
        # null the handle FIRST: if any replace/reopen below fails
        # (disk full, log_dir deleted), the None guard in _write_locked
        # turns every later write into a no-op instead of a
        # closed-file ValueError killing the training loop
        self._file = None
        for i in range(self._max_files - 1, 0, -1):
            src = f"{self.log_path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.log_path}.{i + 1}")
        os.replace(self.log_path, f"{self.log_path}.1")
        # retention bound: drop the generation pushed past max_files
        overflow = f"{self.log_path}.{self._max_files + 1}"
        if os.path.exists(overflow):
            os.remove(overflow)
        self._file = open(self.log_path, "a", buffering=1)

    def _write_locked(self, rec: Dict[str, Any]) -> None:
        if self._file is None:
            return
        line = json.dumps(rec, default=str) + "\n"
        try:
            if (self._file.tell() + len(line) > self._max_bytes
                    and self._file.tell() > 0):
                self._rotate_locked()
            self._file.write(line)
        except OSError:
            pass  # disk-full must not kill the training loop

    def event(self, kind: str, **fields: Any) -> Dict[str, Any]:
        """Journal a non-step event (e.g. a recompile record) into the
        JSONL stream."""
        rec = {"kind": kind, "ts": time.time()}
        rec.update(fields)
        with self._lock:
            self._write_locked(rec)
        return rec

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    # -- the per-step entry point (Executor calls this) ----------------------

    def log_step(self, loss: Optional[float] = None,
                 grad_norm: Optional[float] = None,
                 lr: Optional[float] = None, finite: bool = True,
                 step_time_s: Optional[float] = None,
                 examples: Optional[int] = None,
                 tokens: Optional[int] = None, compiled: bool = False,
                 compile_stats: Optional[Dict[str, Any]] = None,
                 scope_bytes: Optional[int] = None,
                 program: Optional[str] = None) -> Dict[str, Any]:
        """Record one step. Publishes registry series, appends the ring +
        JSONL, and applies the sentinel policy to a non-finite step
        (params were already gated in-graph for skip_step/halt; the host
        side counts, journals, warns or raises)."""
        reg = self._registry
        with self._lock:
            self._step += 1
            step = self._step
        skipped = (not finite) and self.policy in ("skip_step", "halt")
        ex_s = (examples / step_time_s
                if examples and step_time_s else None)
        tok_s = (tokens / step_time_s if tokens and step_time_s else None)
        flops = (compile_stats or {}).get("flops")
        mfu = (flops / step_time_s / self.peak_flops
               if flops and step_time_s and self.peak_flops else None)
        rec: Dict[str, Any] = {
            "kind": "step", "step": step, "ts": time.time(),
            "loss": loss, "grad_norm": grad_norm, "lr": lr,
            "finite": bool(finite), "skipped": skipped,
            "step_time_s": step_time_s, "examples_per_s": ex_s,
            "tokens_per_s": tok_s, "mfu": mfu, "compiled": bool(compiled),
            "scope_bytes": scope_bytes, "program": program,
        }
        if compile_stats:
            rec["compile"] = dict(compile_stats)

        reg.counter("train_steps_total",
                    "telemetry-logged training steps").inc()
        if loss is not None:
            reg.gauge("train_loss", "last step loss").set(loss)
        if grad_norm is not None:
            reg.gauge("train_grad_norm",
                      "last step global gradient norm").set(grad_norm)
        if lr is not None:
            reg.gauge("train_learning_rate",
                      "last step learning rate").set(lr)
        if step_time_s is not None:
            reg.histogram("train_step_seconds",
                          "training step wall time (default latency "
                          "buckets, 0.5ms..10s)").observe(step_time_s)
        if ex_s is not None:
            reg.gauge("train_examples_per_s",
                      "last step examples/second").set(ex_s)
        if tok_s is not None:
            reg.gauge("train_tokens_per_s",
                      "last step tokens/second").set(tok_s)
        if mfu is not None:
            reg.gauge("train_mfu",
                      "estimated model FLOPs utilization").set(mfu)

        with self._lock:
            self._recent.append(rec)
            self._write_locked(rec)

        if not finite:
            with self._lock:
                self._nan_steps += 1
            reg.counter(
                "nan_steps_total",
                "non-finite training steps, by sentinel policy").labels(
                    policy=self.policy).inc()
            if self.policy == "halt":
                raise FloatingPointError(
                    f"non-finite loss/grad-norm at step {step} "
                    f"(loss={loss}, grad_norm={grad_norm}); params were "
                    "preserved in-graph — sentinel policy 'halt'")
            warnings.warn(
                f"non-finite loss/grad-norm at step {step} "
                f"(loss={loss}, grad_norm={grad_norm}, "
                f"policy={self.policy})", RuntimeWarning, stacklevel=3)
        return rec


# -- install / lookup --------------------------------------------------------

_ACTIVE: Optional[StepLogger] = None
_ACTIVE_LOCK = threading.Lock()


def install_step_logger(logger: StepLogger) -> StepLogger:
    """Make `logger` the process-wide step logger. Install BEFORE
    building the training program: `Optimizer.minimize` only attaches
    the telemetry tap (grad-norm + sentinel flag vars) while a logger
    is installed."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, logger
    if prev is not None and prev is not logger:
        prev.close()  # don't leak the displaced logger's JSONL handle
    return logger


def uninstall_step_logger() -> Optional[StepLogger]:
    """Remove (and return) the active logger; runs become telemetry-free
    again — zero extra fetch outputs, zero new registry series."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        logger, _ACTIVE = _ACTIVE, None
    if logger is not None:
        logger.close()
    return logger


def get_step_logger() -> Optional[StepLogger]:
    return _ACTIVE


class step_logging:
    """``with step_logging(log_dir=...) as logger: build + train`` —
    install on enter, uninstall (and close the JSONL) on exit."""

    def __init__(self, **kwargs: Any):
        self._kwargs = kwargs
        self.logger: Optional[StepLogger] = None

    def __enter__(self) -> StepLogger:
        self.logger = install_step_logger(StepLogger(**self._kwargs))
        return self.logger

    def __exit__(self, *exc) -> bool:
        uninstall_step_logger()
        return False


# -- graph-side attachment ---------------------------------------------------


def attach_step_telemetry(program, loss, params_grads, optimizer,
                          policy: str = "warn") -> Optional[Dict[str, str]]:
    """Build the in-graph telemetry tap on a training program (called by
    `Optimizer.minimize` while a StepLogger is installed).

    Adds to the global block, all tagged ``op_role="optimize"`` so
    clone(for_test=True) prunes them:

    * a global grad-norm var — reuses the one
      `GradientClipByGlobalNorm` already computed
      (``program._global_norm_var``) or builds
      sqrt(sum(squared_l2_norm(g))) over the raw gradients;
    * a scalar finiteness flag ``isfinite(loss) && isfinite(grad_norm)``
      fetched with the step's outputs (one computation, no extra sync);
    * for ``skip_step``/``halt``: pre-step snapshots of every param and
      optimizer accumulator, and ``where(flag, new, pre)`` gates after
      the update ops — a non-finite step leaves them bit-identical.

    Records the var names on ``program._train_telemetry``; the Executor
    fetches them alongside the user's fetch_list whenever a StepLogger
    is installed. Idempotent per program (second attach is a no-op).
    """
    if policy not in POLICIES:
        raise ValueError(
            f"sentinel policy must be one of {POLICIES}, got {policy!r}")
    if getattr(program, "_train_telemetry", None) is not None:
        return program._train_telemetry
    if not params_grads:
        return None
    from ..framework.core import unique_name

    blk = program.global_block
    opt_attr = {"op_role": "optimize"}

    def _append(op_type, ins, outs, attrs=None):
        a = dict(opt_attr)
        if attrs:
            a.update(attrs)
        blk.append_op(op_type, ins, outs, a, infer_shape=False)

    # -- global grad-norm tap ------------------------------------------------
    gnorm_name = getattr(program, "_global_norm_var", None)
    if gnorm_name is None or gnorm_name not in blk.vars:
        from ..clip import append_global_norm_ops
        gnorm_name = append_global_norm_ops(
            blk, params_grads, attrs=opt_attr,
            name="telemetry_grad").name

    # -- finiteness flag -----------------------------------------------------
    loss_fin = blk.create_var(name=unique_name("telemetry_loss_finite"),
                              shape=(1,), dtype="bool")
    _append("isfinite", {"X": [loss.name]}, {"Out": [loss_fin.name]})
    gn_fin = blk.create_var(name=unique_name("telemetry_gnorm_finite"),
                            shape=(1,), dtype="bool")
    _append("isfinite", {"X": [gnorm_name]}, {"Out": [gn_fin.name]})
    flag = blk.create_var(name=unique_name("telemetry_step_finite"),
                          shape=(1,), dtype="bool")
    _append("logical_and", {"X": [loss_fin.name], "Y": [gn_fin.name]},
            {"Out": [flag.name]})

    # -- skip/halt gating ----------------------------------------------------
    if policy in ("skip_step", "halt"):
        gate_names = [p.name for p, _ in params_grads]
        for by_param in getattr(optimizer, "_accumulators", {}).values():
            gate_names.extend(v.name for v in by_param.values())
        # snapshots go BEFORE the first update op (clip/reg ops don't
        # write any of these, so the head of the optimize region is a
        # correct pre-step read point)
        idx = next((i for i, op in enumerate(blk.ops)
                    if op.attrs.get("op_role") == "optimize"), len(blk.ops))
        pres = {}
        for name in gate_names:
            v = blk.vars[name]
            pre = blk.create_var(name=unique_name(name + "@PRE_STEP"),
                                 shape=v.shape, dtype=v.dtype,
                                 stop_gradient=True)
            blk.insert_op(idx, "assign", {"X": [name]},
                          {"Out": [pre.name]}, dict(opt_attr),
                          infer_shape=False)
            idx += 1
            pres[name] = pre.name
        for name in gate_names:
            _append("where",
                    {"Condition": [flag.name], "X": [name],
                     "Y": [pres[name]]},
                    {"Out": [name]})

    lr = getattr(optimizer, "_learning_rate", None)
    lr_name = getattr(lr, "name", None)
    tele = {"loss": loss.name, "grad_norm": gnorm_name, "flag": flag.name,
            "lr": lr_name, "policy": policy}
    program._train_telemetry = tele
    return tele
