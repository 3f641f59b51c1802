"""Trace export: tracer spans -> chrome://tracing JSON + self-time rollup.

A copy of `paddle_tpu/observability/export.py` (pure Python).

The reference's tools/timeline.py renders its profiler proto into the
catapult trace-event format; this module is that writer for the
observability tracer. Output is the JSON *object* form

    {"traceEvents": [...], "displayTimeUnit": "ms"}

with one complete ("ph": "X") event per recorded span, "M" metadata
events naming the process and each thread track, and microsecond
timestamps — loads directly in chrome://tracing, ui.perfetto.dev, or
catapult's trace2html.

The self-time rollup (`summarize` / `summarize_chrome_events`) is the
report half of the reference's profiler output (profiler.cc PrintProfiler
sorted-by-total table): per span name, count / total / self time, where
self time subtracts the durations of directly nested child spans on the
same thread. `tools/trace_summary.py` is the CLI over it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional

from .tracer import Span, Tracer, get_tracer

__all__ = ["spans_to_events", "ticks_to_events", "export_chrome_trace",
           "self_times", "summarize", "summarize_chrome_events"]


def spans_to_events(spans: Iterable[Span], pid: int = 0) -> List[dict]:
    """Spans -> chrome trace events ("M" thread/process names + "X")."""
    events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": "paddle_tpu"}}]
    named_tids = set()
    for s in spans:
        if s.tid not in named_tids:
            named_tids.add(s.tid)
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": s.tid, "args": {"name": s.thread}})
        ev = {"name": s.name, "cat": s.cat or "span", "ph": "X",
              "ts": s.ts_us, "dur": s.dur_us, "pid": pid, "tid": s.tid}
        if s.args:
            ev["args"] = dict(s.args)
        events.append(ev)
    return events


def ticks_to_events(label: str, records: Iterable[dict],
                    pid: int = 0) -> List[dict]:
    """Tick-profiler flight-ring records -> chrome trace events: one
    track per engine label, one consecutive "X" event per non-zero
    phase of each tick (scaled to the measured phase seconds, ending at
    the record's t_mono stamp — the /tickz?chrome=1 renderer). Phase
    order inside a record follows the engine's phases dict, which the
    profiler keeps in tick execution order."""
    tid = abs(hash(("tick", label))) % (1 << 31)
    events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": "paddle_tpu"}},
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
         "args": {"name": f"engine {label} ticks"}}]
    for rec in records:
        phases = rec.get("phases") or {}
        end_us = float(rec.get("t_mono", 0.0)) * 1e6
        ts = end_us - sum(float(s) for s in phases.values()) * 1e6
        for phase, seconds in phases.items():
            dur = float(seconds) * 1e6
            if dur <= 0:
                continue
            events.append({"name": f"serving/tick/{phase}",
                           "cat": "serving", "ph": "X", "ts": ts,
                           "dur": dur, "pid": pid, "tid": tid,
                           "args": {"engine": label,
                                    "step": rec.get("step")}})
            ts += dur
    return events


def export_chrome_trace(path: str, tracer: Optional[Tracer] = None,
                        pid: int = 0) -> str:
    """Write the tracer's current spans as a chrome trace JSON; returns
    `path`. Writes via a temp file + rename so a crash mid-export never
    leaves a truncated (unloadable) trace behind."""
    tracer = tracer or get_tracer()
    payload = {"traceEvents": spans_to_events(tracer.snapshot(), pid=pid),
               "displayTimeUnit": "ms",
               "otherData": {"producer": "paddle_tpu.observability",
                             "dropped_spans": tracer.dropped}}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        # default=str: span args are caller-supplied (numpy scalars, enums)
        # and must never make a trace unwritable
        json.dump(payload, f, default=str)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# self-time rollup
# ---------------------------------------------------------------------------


def summarize_chrome_events(events: Iterable[dict],
                            top: Optional[int] = None) -> List[dict]:
    """Per-name self-time table over raw chrome trace events.

    Only complete ("X") events count. Self time = duration minus the
    durations of DIRECTLY nested events on the same (pid, tid) track —
    the stack sweep assumes proper nesting per track, which the tracer
    guarantees. Rows sort by self time descending; `top` truncates."""
    tracks: Dict[tuple, List[dict]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        tracks.setdefault((ev.get("pid", 0), ev.get("tid", 0)),
                          []).append(ev)

    rows: Dict[str, Dict[str, Any]] = {}

    def commit(name: str, dur: float, child: float) -> None:
        r = rows.setdefault(name, {"name": name, "count": 0,
                                   "total_us": 0.0, "self_us": 0.0})
        r["count"] += 1
        r["total_us"] += dur
        r["self_us"] += max(0.0, dur - child)

    for evs in tracks.values():
        evs.sort(key=lambda e: (float(e.get("ts", 0.0)),
                                -float(e.get("dur", 0.0))))
        # stack entries: [name, end_ts, dur, direct_child_dur]
        stack: List[list] = []
        for ev in evs:
            ts = float(ev.get("ts", 0.0))
            dur = float(ev.get("dur", 0.0))
            while stack and ts >= stack[-1][1] - 1e-9:
                done = stack.pop()
                commit(done[0], done[2], done[3])
            if stack:
                stack[-1][3] += dur
            stack.append([ev.get("name", "?"), ts + dur, dur, 0.0])
        while stack:
            done = stack.pop()
            commit(done[0], done[2], done[3])

    out = sorted(rows.values(), key=lambda r: -r["self_us"])
    for r in out:
        r["avg_self_us"] = r["self_us"] / r["count"] if r["count"] else 0.0
    return out[:top] if top is not None else out


def self_times(spans: Iterable[Span]) -> Dict[str, Dict[str, Any]]:
    """Per-name {count, total_us, self_us, avg_self_us} over Span objects."""
    rows = summarize_chrome_events(spans_to_events(spans))
    return {r["name"]: r for r in rows}


def summarize(tracer: Optional[Tracer] = None,
              top: Optional[int] = 20) -> List[dict]:
    """Top-N spans by self time from a tracer's current ring."""
    tracer = tracer or get_tracer()
    return summarize_chrome_events(spans_to_events(tracer.snapshot()),
                                   top=top)
