"""Serving request-lifecycle event log: every transition, journaled.

A copy of `paddle_tpu/observability/request_log.py` (pure Python).

The reference framework pairs its serving surface with per-request
profiling and timeline attribution (profiler + timeline tooling next to
the executor); the registry histograms answer "how is
the fleet doing" but not "what happened to THIS request". This module
is the request-level truth: the `train_stats.StepLogger` idiom applied
to serving — an append-only JSONL event log with bounded rotation plus
an in-memory ring — capturing every lifecycle transition a request
moves through:

    submitted -> queued | shed            (engine admission door)
    quota_rejected | routed               (router front tier)
    admitted -> prefill                   (slot + pages claimed)
    decode                                (one per fused chunk dispatch
                                           that delivered this request's
                                           tokens)
    preempted -> swapped_in               (host-swap under page pressure)
    failover -> routed{rerouted_from=}    (replica death re-submission)
    migrate_out -> migrate_in{rerouted_from=}
                                          (live cross-replica migration:
                                           source/target replica labels,
                                           payload bytes, phase; the
                                           adopting engine mints a new
                                           id and rerouted_from chains
                                           the hop exactly like a
                                           failover re-submission)
    finished | cancelled | stream_closed  (terminal, with finish_reason)

Every record carries a wall stamp (`ts`), a monotonic stamp (`t_mono`,
the phase-math clock), the `request_id` the tracer spans already carry
(so `/tracez?request_id=` and this log join on the same key), and
whatever the call site knows: tenant, replica/engine label, slot,
bucket, dispatch index. `tools/serving_summary.py` renders the JSONL
into per-request phase timelines; `/requestz` serves the ring live.

Install discipline mirrors the step logger exactly: call sites guard on
`get_request_log() is not None`, so the UNINSTALLED path (the
production default) is one attribute read — zero allocations, zero
registry series, token streams and compile counts bit-identical to a
build without this module (pinned in tests/test_serving.py).

The log also tracks the set of in-flight request ids (first non-terminal
event adds, terminal event removes, a failover's `rerouted_from` retires
the superseded id) — the watchdog's flight records snapshot this set
into `meta.json` so a stall dump can be joined against the event log.

Stdlib-only at import: safe to import from the engine/scheduler/router
without cycles.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["RequestLog", "install_request_log", "uninstall_request_log",
           "get_request_log", "request_logging", "TERMINAL_KINDS"]

# kinds that end a request's in-flight life (engine-level "finished"/
# "cancelled"/"shed" and the router's "stream_closed" — a routed request
# fires both, the second discard is a no-op)
TERMINAL_KINDS = frozenset({"shed", "finished", "cancelled",
                            "stream_closed"})


class RequestLog:
    """Lifecycle transitions -> in-memory ring + rotating JSONL.

    `log_dir=None` keeps everything in memory (the `recent()` ring that
    `/requestz` serves); with a directory, records append to
    ``<log_dir>/<run_name>.jsonl`` rotated at `max_bytes` keeping
    `max_files` old generations (``.1`` newest) — the StepLogger
    rotation discipline exactly."""

    def __init__(self, log_dir: Optional[str] = None,
                 run_name: str = "serving", keep_recent: int = 1024,
                 max_bytes: int = 8 << 20, max_files: int = 3):
        self.run_name = run_name
        self._lock = threading.Lock()
        self._recent: "deque[Dict[str, Any]]" = deque(maxlen=keep_recent)
        self._events = 0
        self._inflight: Dict[str, float] = {}   # request_id -> first t_mono
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
    def event_count(self) -> int:
        return self._events

    def recent(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """Latest event records, oldest first (`/requestz` backing
        store)."""
        with self._lock:
            out = list(self._recent)
        if n is not None and n >= 0:
            out = out[-n:] if n else []
        return out

    def inflight_ids(self) -> List[str]:
        """Request ids with a non-terminal event and no terminal one
        yet, oldest-first — what a flight record snapshots so a stall
        dump joins against this log."""
        with self._lock:
            return sorted(self._inflight, key=self._inflight.get)

    # -- JSONL (StepLogger rotation discipline) ------------------------------

    def _rotate_locked(self) -> None:
        self._file.close()
        # null the handle FIRST: a failed replace/reopen (disk full,
        # log_dir deleted) must degrade every later write to a no-op,
        # not kill the serving driver with a closed-file ValueError
        self._file = None
        for i in range(self._max_files - 1, 0, -1):
            src = f"{self.log_path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.log_path}.{i + 1}")
        os.replace(self.log_path, f"{self.log_path}.1")
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
            pass  # disk-full must not kill the serving loop

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    # -- the event entry point ----------------------------------------------

    def event(self, kind: str, request_id: Optional[str] = None,
              **fields: Any) -> Dict[str, Any]:
        """Journal one lifecycle transition. `t_mono` is the monotonic
        stamp phase math runs on (wall `ts` is for humans/joins across
        processes); everything else rides through verbatim."""
        rec: Dict[str, Any] = {"kind": kind, "ts": time.time(),
                               "t_mono": time.monotonic(),
                               "request_id": request_id}
        rec.update(fields)
        with self._lock:
            self._events += 1
            if request_id is not None:
                if kind in TERMINAL_KINDS:
                    self._inflight.pop(request_id, None)
                else:
                    self._inflight.setdefault(request_id, rec["t_mono"])
            # a failover re-submission retires the superseded id (its
            # terminal event will only ever name the NEW id)
            old = fields.get("rerouted_from")
            if old is not None:
                self._inflight.pop(old, None)
            self._recent.append(rec)
            self._write_locked(rec)
        return rec


# -- install / lookup --------------------------------------------------------

_ACTIVE: Optional[RequestLog] = None
_ACTIVE_LOCK = threading.Lock()


def install_request_log(log: RequestLog) -> RequestLog:
    """Make `log` the process-wide request event log. Every engine,
    scheduler, and router call site starts journaling into it on its
    next transition — no rebuild needed (unlike the step logger, nothing
    attaches at graph-build time)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, log
    if prev is not None and prev is not log:
        prev.close()  # don't leak the displaced log's JSONL handle
    return log


def uninstall_request_log() -> Optional[RequestLog]:
    """Remove (and return) the active log; serving becomes
    journal-free again — the disabled path is one attribute read per
    transition, zero registry series, streams bit-identical."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        log, _ACTIVE = _ACTIVE, None
    if log is not None:
        log.close()
    return log


def get_request_log() -> Optional[RequestLog]:
    return _ACTIVE


class request_logging:
    """``with request_logging(log_dir=...) as log: serve`` — install on
    enter, uninstall (and close the JSONL) on exit."""

    def __init__(self, **kwargs: Any):
        self._kwargs = kwargs
        self.log: Optional[RequestLog] = None

    def __enter__(self) -> RequestLog:
        self.log = install_request_log(RequestLog(**self._kwargs))
        return self.log

    def __exit__(self, *exc) -> bool:
        uninstall_request_log()
        return False
