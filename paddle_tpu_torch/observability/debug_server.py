"""Live diagnostics HTTP server: scrape/inspect a *running* process.

A copy of `paddle_tpu/observability/debug_server.py` (pure Python):
the same endpoints over the port's registry, tracer, request log,
watchdog and step logger.

The reference exposed its profiler/monitor state over the pserver's RPC
surface; the serving analog (Dapper/Prometheus tradition, Go's
net/http/pprof, gRPC's channelz) is a tiny debug HTTP plane an operator
can curl while the job runs, instead of waiting for post-hoc trace
files. Stdlib-only (`http.server.ThreadingHTTPServer`): the container
has no web framework and needs none.

Endpoints:

    /          index (HTML link list)
    /metrics   Prometheus text exposition of the process registry
    /metricz   same exposition with optional label aggregation:
               ?aggregate=engine merges per-replica series into fleet
               totals so one scrape covers all replicas
    /healthz   JSON liveness: per-engine + executor heartbeats with
               last-progress ages, overall ok/stalled verdict
    /varz      JSON everything: registry snapshot + tracer stats +
               process info + watchdog status
    /tracez    recent tracer spans as JSON; ?request_id= filters to one
               request's end-to-end timeline; ?limit=N newest N;
               ?chrome=1 downloads a catapult chrome-trace instead
    /tickz     engine tick-profiler flight ring (tick_profile engines):
               per-tick phase decomposition; ?engine= one engine,
               ?limit=N newest N, ?chrome=1 chrome-trace download
    /compilez  executable cost & compile journal (tick_profile
               engines): per-family count/cost/share + compile-event
               records; ?engine= one engine, ?limit=N newest records
    /requestz  serving request-lifecycle events (the installed request
               log's ring): in-flight ids + recent transitions;
               ?request_id= one request's timeline, ?limit=N newest N
    /alertz    fleet health alert plane (FleetHealth sources): per-rule
               state + the bounded alert-transition ring;
               ?source= one plane, ?limit=N newest transitions
    /statusz   fleet health rollup: worst status + min health score
               across planes, firing rules, recent transitions,
               process block, registry snapshot; ?limit=N transitions
    /stacksz   all-thread Python stack dump (text/plain)

`start_debug_server(port=0)` binds (0 = ephemeral), serves from daemon
threads, and returns the bound port. The server holds no references
into the serving engine — everything it reports flows through the
observability registry/tracer, so it works for training jobs too, and
a wedged engine can't wedge its own diagnostics.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

from .export import spans_to_events, ticks_to_events
from .metrics import MetricsRegistry, get_registry
from .tracer import Span, Tracer, get_tracer
from . import request_log as _request_log
from . import train_stats as _train_stats
from . import watchdog as _watchdog

__all__ = ["DebugServer", "start_debug_server", "acquire_debug_server",
           "release_debug_server", "stop_debug_server",
           "get_debug_server", "registry_rollup", "ratio",
           "register_perf_source", "unregister_perf_source"]

_INDEX = """<html><head><title>paddle_tpu_torch debug</title></head><body>
<h1>paddle_tpu_torch live diagnostics</h1><ul>
<li><a href="/metrics">/metrics</a> — Prometheus text exposition</li>
<li><a href="/healthz">/healthz</a> — engine/executor liveness</li>
<li><a href="/varz">/varz</a> — registry + tracer + process snapshot</li>
<li><a href="/metricz">/metricz</a> — Prometheus exposition with
    optional aggregation (<code>?aggregate=engine</code>)</li>
<li><a href="/tracez">/tracez</a> — recent spans
    (<code>?request_id=</code>, <code>?limit=</code>,
     <code>?chrome=1</code>)</li>
<li><a href="/tickz">/tickz</a> — engine tick-profiler flight ring
    (<code>?engine=</code>, <code>?limit=</code>,
     <code>?chrome=1</code>)</li>
<li><a href="/compilez">/compilez</a> — executable cost &amp; compile
    journal (<code>?engine=</code>, <code>?limit=</code>)</li>
<li><a href="/trainz">/trainz</a> — training telemetry: latest step
    scalars + recompile log (<code>?limit=</code>)</li>
<li><a href="/requestz">/requestz</a> — serving request-lifecycle
    events: in-flight ids + recent transitions
    (<code>?request_id=</code>, <code>?limit=</code>)</li>
<li><a href="/alertz">/alertz</a> — fleet health alert plane: rule
    states + transition ring (<code>?source=</code>,
    <code>?limit=</code>)</li>
<li><a href="/statusz">/statusz</a> — fleet health score rollup
    (<code>?limit=</code>)</li>
<li><a href="/stacksz">/stacksz</a> — all-thread stack dump</li>
</ul></body></html>
"""


def _span_request_id(s: Span) -> Optional[str]:
    return s.args.get("request_id") if s.args else None


# ---------------------------------------------------------------------------
# perf-source registry: tick_profile engines register snapshot providers
# here (closures over their flight ring / compile journal) so /tickz and
# /compilez can serve them WITHOUT the server holding engine references —
# the engine owns the lifecycle (register at construction, unregister in
# close()), the server only ever iterates a copied mapping.
# ---------------------------------------------------------------------------

_PERF_SOURCES: Dict[str, Dict[str, Any]] = {"tick": {}, "compile": {},
                                            "alerts": {}}
_PERF_LOCK = threading.Lock()


def register_perf_source(kind: str, label: str, provider) -> None:
    """Install a zero-arg snapshot provider for `kind` ("tick",
    "compile", or "alerts") under a source label. The tick_profile
    engine / FleetHealth wiring; last registration per (kind, label)
    wins."""
    if kind not in _PERF_SOURCES:
        raise ValueError(f"unknown perf-source kind {kind!r}: expected "
                         f"one of {sorted(_PERF_SOURCES)}")
    with _PERF_LOCK:
        _PERF_SOURCES[kind][str(label)] = provider


def unregister_perf_source(kind: str, label: str) -> None:
    """Drop a provider (engine close(); unknown labels are a no-op —
    teardown must be idempotent)."""
    if kind not in _PERF_SOURCES:
        raise ValueError(f"unknown perf-source kind {kind!r}: expected "
                         f"one of {sorted(_PERF_SOURCES)}")
    with _PERF_LOCK:
        _PERF_SOURCES[kind].pop(str(label), None)


def _perf_sources(kind: str) -> Dict[str, Any]:
    with _PERF_LOCK:
        return dict(_PERF_SOURCES[kind])


def _series_by_label(snap: Dict[str, Any], family: str, label_key: str,
                     field: str = "value") -> Dict[Any, float]:
    """{label value: summed `field`} over one family's series in a
    registry snapshot. Summing handles families whose series split a
    label further (e.g. server_slo_met_total carries tenant AND
    objective: keyed by tenant, the objectives aggregate)."""
    out: Dict[Any, float] = {}
    for row in snap.get(family, {}).get("series", []):
        label = row["labels"].get(label_key)
        out[label] = out.get(label, 0) + (row.get(field) or 0)
    return out


def registry_rollup(snap: Dict[str, Any],
                    fields: Dict[str, Any],
                    label_key: str = "engine",
                    derived=()) -> Dict[Any, Dict[str, Any]]:
    """Join labeled registry series into per-label rollup rows — the
    one helper behind every /varz ratio block (prefix-cache, spec
    acceptance, preemption, host-overhead, SLO) instead of a
    copy-pasted loop per subsystem.

    `fields` maps output column -> family name (counter/gauge `value`,
    cast to int) or -> (family, field, cast) for histogram columns
    (`field` "sum"/"count", cast float/int). `derived` is a sequence of
    (column, fn(row) -> value) appended in order — `ratio()` builds the
    common safe-division case. Returns {label: row} over the union of
    labels across all fields, sorted by str."""
    cols: Dict[str, Any] = {}
    for out_field, spec in fields.items():
        if isinstance(spec, str):
            family, field, cast = spec, "value", int
        else:
            family, field, cast = spec
        cols[out_field] = (_series_by_label(snap, family, label_key,
                                            field), cast)
    labels: set = set()
    for vals, _ in cols.values():
        labels |= set(vals)
    out: Dict[Any, Dict[str, Any]] = {}
    for label in sorted(labels, key=str):
        row: Dict[str, Any] = {f: cast(vals.get(label, 0))
                               for f, (vals, cast) in cols.items()}
        for out_field, fn in derived:
            row[out_field] = fn(row)
        out[label] = row
    return out


def ratio(num: str, den, digits: int = 4, scale: float = 1.0):
    """derived-fn factory for registry_rollup: `num` over the SUM of
    `den` field(s), rounded, None on a zero denominator (a ratio with
    no observations is unknown, not 0). Columns that are absent or
    themselves None (a derived column that degraded) read as 0 — the
    ratio degrades to None instead of raising, keeping every /varz
    block total even when a family hasn't registered yet."""
    den = (den,) if isinstance(den, str) else tuple(den)

    def fn(row: Dict[str, Any]):
        d = sum(row.get(k) or 0 for k in den)
        n = row.get(num)
        if n is None or not d:
            return None
        return round(n * scale / d, digits)
    return fn


def _serving_varz(snap: Dict[str, Any]) -> Dict[str, Any]:
    """Per-engine/per-tenant serving rollups for /varz: ratios an
    operator would otherwise derive from counter pairs by hand, all
    built by registry_rollup over the snapshot only — no engine
    references, same as every other /varz column."""
    out = {
        "prefix_hit_ratio": registry_rollup(snap, {
            "prefix_cache_hits": "serving_prefix_cache_hits_total",
            "prefix_cache_misses": "serving_prefix_cache_misses_total",
        }, derived=[
            # share of shareable prompt blocks served from the cache;
            # None until the engine has seen one
            ("prefix_hit_ratio",
             ratio("prefix_cache_hits",
                   ("prefix_cache_hits", "prefix_cache_misses")))]),
        "spec_accept_ratio": registry_rollup(snap, {
            "spec_proposed": "serving_spec_proposed_total",
            "spec_accepted": "serving_spec_accepted_total",
        }, derived=[
            # share of drafted tokens that verification accepted; None
            # until the engine has run a speculative pass
            ("spec_accept_ratio",
             ratio("spec_accepted", "spec_proposed"))]),
        # chunked prefill: how many budget-bounded prefill chunk
        # dispatches ran, per admission — >1 means long prompts are
        # really being split and interleaved with decode (0/None on
        # monolithic engines: the knob is off or nothing admitted)
        "prefill": registry_rollup(snap, {
            "prefill_chunks": "serving_prefill_chunks_total",
            "admitted": "serving_admitted_total",
        }, derived=[
            ("prefill_chunks_per_admission",
             ratio("prefill_chunks", "admitted"))]),
        # host-swap preemption: how often page pressure evicted a
        # running sequence, how many resumed, how many sit parked NOW
        "preemption": registry_rollup(snap, {
            "preemptions": "serving_preemptions_total",
            "swap_ins": "serving_swap_ins_total",
            "swapped_slots": "serving_swapped_slots",
        }),
        # tensor-parallel mesh + quantization geometry per engine:
        # shard count, the PER-CHIP arena bytes (pool_bytes / tp), the
        # arena storage itemsize (1 = int8-quantized KV), and the
        # served weight bytes — so an operator can see which replicas
        # are tensor-parallel and/or quantized and what one chip
        # actually holds, straight off the scrape path
        "mesh": registry_rollup(snap, {
            "mesh_shards": "serving_mesh_shards",
            "kv_pool_per_chip_bytes": "serving_kv_pool_per_chip_bytes",
            "kv_dtype_bytes": "serving_kv_dtype_bytes",
            "weight_bytes": "serving_weight_bytes",
        }),
        # host/device dispatch split (ServingConfig(dispatch_timing)):
        # mean launch-side host ms per fused dispatch — the pinned
        # baseline the native continuous-batching core is judged
        # against — plus the host share of attributed wall time
        "host_overhead_per_dispatch": registry_rollup(snap, {
            "dispatches": ("serving_dispatch_host_seconds", "count",
                           int),
            "host_s_total": ("serving_dispatch_host_seconds", "sum",
                             float),
            "device_s_total": ("serving_dispatch_device_seconds",
                               "sum", float),
        }, derived=[
            ("host_overhead_ms",
             ratio("host_s_total", "dispatches", digits=3,
                   scale=1e3)),
            ("host_share",
             ratio("host_s_total",
                   ("host_s_total", "device_s_total")))]),
        # cross-replica migration: completed hand-offs by router,
        # failure incidents, and the mean end-to-end handoff latency
        # (order created -> sequence adopted on the target). Families
        # exist only once a migration ran — rebalancer off = no rows.
        "migration": registry_rollup(snap, {
            "migrations": "server_migrations_total",
            "migration_failures": "server_migration_failures_total",
            "count": ("serving_migration_seconds", "count", int),
            "seconds_total": ("serving_migration_seconds", "sum",
                              float),
        }, label_key="router", derived=[
            ("migration_ms",
             ratio("seconds_total", "count", digits=3, scale=1e3))]),
        # per-tenant SLO attainment + goodput (router-scored; /slozv
        # carries the per-objective breakdown, this is the scrape-path
        # summary)
        "slo": registry_rollup(snap, {
            "slo_met": "server_slo_met_total",
            "slo_missed": "server_slo_missed_total",
            "tokens": "server_slo_tokens_total",
            "goodput_tokens": "server_goodput_tokens_total",
        }, label_key="tenant", derived=[
            ("slo_attainment",
             ratio("slo_met", ("slo_met", "slo_missed"))),
            ("goodput_ratio",
             ratio("goodput_tokens", "tokens"))]),
    }
    # multi-tenant adapter pool: residency + pool HBM + upload/evict
    # churn per engine. The families are conditional (registered only
    # on engines built with an AdapterPool), so the block appears only
    # when some engine actually serves adapters — adapterless fleets
    # keep their /varz payload byte-identical to pre-adapter builds.
    adapters = registry_rollup(snap, {
        "adapters_resident": "serving_adapters_resident",
        "adapter_pool_bytes": "serving_adapter_pool_bytes",
        "adapter_uploads": "serving_adapter_uploads_total",
        "adapter_evictions": "serving_adapter_evictions_total",
    })
    if adapters:
        out["adapters"] = adapters
    # engine tick-phase attribution (ServingConfig(tick_profile=True)
    # engines only — same conditional discipline as the adapter block:
    # profile-less fleets keep their /varz payload byte-identical):
    # per-phase tick counts, total seconds, and each phase's SHARE of
    # all attributed host time — the where-did-the-tick-go rollup
    tick = registry_rollup(snap, {
        "count": ("serving_tick_phase_seconds", "count", int),
        "seconds_total": ("serving_tick_phase_seconds", "sum", float),
    }, label_key="phase")
    if tick:
        total = sum(row["seconds_total"] for row in tick.values())
        for row in tick.values():
            row["share"] = (round(row["seconds_total"] / total, 4)
                            if total > 0 else None)
        out["tick_phases"] = tick
    return out


_BAD_LIMIT = object()   # _parse_limit sentinel: 400 already sent


def _parse_limit(h, q: Dict[str, str], default):
    """Parse ``?limit=`` for the ring-serving endpoints (/tracez,
    /trainz, /requestz, /tickz, /compilez, /alertz, /statusz): a
    non-negative int,
    `default` when absent. A malformed or negative value sends the 400
    and returns `_BAD_LIMIT` — the caller just returns. EVERY ring
    endpoint must route its limit through here (the meta-test in
    test_observability sweeps them all for the 400 contract)."""
    raw = q.get("limit")
    if raw is None:
        return default
    try:
        limit = int(raw)
    except ValueError:
        limit = -1
    if limit < 0:
        h._send_json({"error": f"bad limit {raw!r}: expected a "
                      "non-negative integer"}, status=400)
        return _BAD_LIMIT
    return limit


def _query_flag(q: Dict[str, str], name: str) -> bool:
    return q.get(name, "").lower() not in ("", "0", "false", "no")


class _Handler(BaseHTTPRequestHandler):
    server: "ThreadingHTTPServer"  # carries .debug (DebugServer)

    protocol_version = "HTTP/1.1"

    # -- plumbing ------------------------------------------------------------

    def log_message(self, fmt, *args):  # no stderr spam per scrape
        pass

    def _send(self, body: bytes, ctype: str, status: int = 200,
              extra: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj: Any, status: int = 200) -> None:
        self._send(json.dumps(obj, indent=2, default=str).encode(),
                   "application/json", status)

    # -- routing -------------------------------------------------------------

    def do_GET(self):  # noqa: N802 (http.server API)
        url = urlparse(self.path)
        query = {k: v[-1] for k, v in parse_qs(url.query).items()}
        dbg: "DebugServer" = self.server.debug
        route = dbg.routes.get(url.path)
        if route is None:
            self._send_json({"error": f"no such endpoint {url.path!r}",
                            "endpoints": sorted(dbg.routes)}, status=404)
            return
        try:
            dbg.requests.labels(path=url.path).inc()
            route(self, query)
        except BrokenPipeError:
            pass                     # client went away mid-response
        except Exception as e:       # a broken endpoint must report, not die
            try:
                self._send_json({"error": f"{type(e).__name__}: {e}"},
                                status=500)
            except Exception:
                pass


class DebugServer:
    """One ThreadingHTTPServer bound to (host, port), serving the
    observability plane from daemon threads."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self._registry = registry or get_registry()
        self._tracer = tracer or get_tracer()
        self._monitor = _watchdog.ProgressMonitor(self._registry)
        self._started_unix = time.time()
        self.requests = self._registry.counter(
            "debug_server_requests_total", "debug endpoint hits, by path")
        self.routes = {
            "/": self._index, "/metrics": self._metrics,
            "/metricz": self._metricz,
            "/healthz": self._healthz, "/varz": self._varz,
            "/tracez": self._tracez, "/trainz": self._trainz,
            "/tickz": self._tickz, "/compilez": self._compilez,
            "/requestz": self._requestz, "/alertz": self._alertz,
            "/statusz": self._statusz, "/stacksz": self._stacksz,
        }
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.debug = self
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pt-debug-http",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    # -- endpoints -----------------------------------------------------------

    def _index(self, h: _Handler, q: Dict[str, str]) -> None:
        h._send(_INDEX.encode(), "text/html; charset=utf-8")

    def _metrics(self, h: _Handler, q: Dict[str, str]) -> None:
        h._send(self._registry.to_prometheus().encode(),
                "text/plain; version=0.0.4; charset=utf-8")

    def _metricz(self, h: _Handler, q: Dict[str, str]) -> None:
        """Prometheus text exposition of the whole registry, with
        optional label aggregation: ?aggregate=engine merges every
        per-replica series into fleet totals (counters/gauges sum,
        same-layout histograms merge bucket-wise), so one scrape line
        covers all replicas in the process."""
        text = self._registry.to_prometheus(
            aggregate_label=q.get("aggregate"))
        h._send(text.encode(),
                "text/plain; version=0.0.4; charset=utf-8")

    def _healthz(self, h: _Handler, q: Dict[str, str]) -> None:
        wd = _watchdog.get_watchdog()
        raw = q.get("stall_threshold")
        if raw is None:
            threshold = wd.stall_threshold if wd else 30.0
        else:
            try:
                threshold = float(raw)
            except ValueError:
                threshold = -1.0
            if threshold <= 0:  # a probe typo must be a 400, not a
                # 500 or a spurious "stalled" verdict
                h._send_json({"error": f"bad stall_threshold {raw!r}: "
                              "expected a positive number of seconds"},
                             status=400)
                return
        progress = self._monitor.observe()
        stalled = [k for k, e in progress.items()
                   if e["busy"] and e["age_s"] >= threshold]
        h._send_json({
            "status": "stalled" if stalled else "ok",
            "stalled": stalled,
            "uptime_s": round(time.time() - self._started_unix, 3),
            "progress": progress,
            "watchdog": wd.status() if wd else {"running": False},
        }, status=503 if stalled else 200)

    def _varz(self, h: _Handler, q: Dict[str, str]) -> None:
        snap = self._registry.snapshot()
        h._send_json({
            "serving": _serving_varz(snap),
            "process": {
                "pid": os.getpid(),
                "python": sys.version.split()[0],
                "platform": sys.platform,
                "threads": threading.active_count(),
                "server_uptime_s": round(
                    time.time() - self._started_unix, 3),
                "argv": sys.argv,
            },
            "tracer": {
                "enabled": self._tracer.enabled,
                "span_count": self._tracer.span_count,
                "dropped": self._tracer.dropped,
                "capacity": self._tracer.capacity,
            },
            "watchdog": (w.status() if (w := _watchdog.get_watchdog())
                         else {"running": False}),
            "metrics": snap,
        })

    def _tracez(self, h: _Handler, q: Dict[str, str]) -> None:
        spans = self._tracer.snapshot()
        rid = q.get("request_id")
        if rid is not None:
            spans = [s for s in spans if _span_request_id(s) == rid]
        limit = _parse_limit(h, q, default=None)
        if limit is _BAD_LIMIT:
            return
        if limit is not None:
            spans = spans[-limit:] if limit else []
        if _query_flag(q, "chrome"):
            payload = {"traceEvents": spans_to_events(spans),
                       "displayTimeUnit": "ms"}
            h._send(json.dumps(payload, default=str).encode(),
                    "application/json",
                    extra={"Content-Disposition":
                           'attachment; filename="trace.json"'})
            return
        h._send_json({
            "enabled": self._tracer.enabled,
            "count": len(spans),
            "dropped": self._tracer.dropped,
            "request_id": rid,
            "spans": [s._asdict() for s in spans],
        })

    def _trainz(self, h: _Handler, q: Dict[str, str]) -> None:
        """Training telemetry: latest-N step scalars (StepLogger ring)
        plus the recompilation-attribution log, as JSON."""
        limit = _parse_limit(h, q, default=50)
        if limit is _BAD_LIMIT:
            return
        logger = _train_stats.get_step_logger()
        h._send_json({
            "enabled": logger is not None,
            "policy": logger.policy if logger else None,
            "steps_total": logger.step_count if logger else 0,
            "nan_steps": logger.nan_steps if logger else 0,
            "log_path": logger.log_path if logger else None,
            "steps": logger.recent(limit) if logger else [],
            "recompiles": _train_stats.recompile_log(limit),
        })

    def _tickz(self, h: _Handler, q: Dict[str, str]) -> None:
        """Engine tick-profiler flight ring: per-tick phase
        decomposition records from every registered tick_profile
        engine. ?engine= one engine's ring; ?limit=N newest N per
        engine; ?chrome=1 downloads the rings as a catapult
        chrome-trace (one phase sub-span per record)."""
        limit = _parse_limit(h, q, default=100)
        if limit is _BAD_LIMIT:
            return
        sources = _perf_sources("tick")
        engine = q.get("engine")
        if engine is not None:
            sources = {k: v for k, v in sources.items() if k == engine}
        engines = {}
        for label in sorted(sources):
            records = list(sources[label]() or [])
            engines[label] = records[-limit:] if limit else []
        if _query_flag(q, "chrome"):
            events = []
            for label, records in engines.items():
                events.extend(ticks_to_events(label, records))
            payload = {"traceEvents": events, "displayTimeUnit": "ms"}
            h._send(json.dumps(payload, default=str).encode(),
                    "application/json",
                    extra={"Content-Disposition":
                           'attachment; filename="ticks.json"'})
            return
        h._send_json({
            "enabled": bool(sources),
            "engine": engine,
            "count": sum(len(v) for v in engines.values()),
            "engines": engines,
        })

    def _compilez(self, h: _Handler, q: Dict[str, str]) -> None:
        """Executable cost & compile journal: per-family attribution
        (calls, compiles, compile seconds + share, cost_analysis
        FLOPs/bytes) and the compile-event records from every
        registered tick_profile engine. ?engine= one engine;
        ?limit=N newest N records per engine."""
        limit = _parse_limit(h, q, default=None)
        if limit is _BAD_LIMIT:
            return
        sources = _perf_sources("compile")
        engine = q.get("engine")
        if engine is not None:
            sources = {k: v for k, v in sources.items() if k == engine}
        engines = {}
        for label in sorted(sources):
            snap = dict(sources[label]() or {})
            if limit is not None:
                records = snap.get("records", [])
                snap["records"] = records[-limit:] if limit else []
            engines[label] = snap
        h._send_json({
            "enabled": bool(sources),
            "engine": engine,
            "engines": engines,
        })

    def _requestz(self, h: _Handler, q: Dict[str, str]) -> None:
        """Serving request-lifecycle events (the process request log's
        ring): in-flight request ids + recent transitions as JSON.
        ?request_id= filters to one request's timeline; ?limit=N newest
        N events (after the filter)."""
        limit = _parse_limit(h, q, default=200)
        if limit is _BAD_LIMIT:
            return
        rlog = _request_log.get_request_log()
        events = rlog.recent() if rlog else []
        rid = q.get("request_id")
        if rid is not None:
            events = [e for e in events if e.get("request_id") == rid]
        h._send_json({
            "enabled": rlog is not None,
            "log_path": rlog.log_path if rlog else None,
            "events_total": rlog.event_count if rlog else 0,
            "inflight": rlog.inflight_ids() if rlog else [],
            "request_id": rid,
            "events": events[-limit:] if limit else [],
        })

    def _alertz(self, h: _Handler, q: Dict[str, str]) -> None:
        """Fleet health alert plane: per-rule state + the bounded
        alert-transition ring from every registered FleetHealth source.
        ?source= one plane's payload; ?limit=N newest N transitions per
        source (default 100)."""
        limit = _parse_limit(h, q, default=100)
        if limit is _BAD_LIMIT:
            return
        sources = _perf_sources("alerts")
        source = q.get("source")
        if source is not None:
            sources = {k: v for k, v in sources.items() if k == source}
        planes = {}
        for label in sorted(sources):
            snap = dict(sources[label]() or {})
            trans = snap.get("transitions", [])
            snap["transitions"] = trans[-limit:] if limit else []
            planes[label] = snap
        h._send_json({
            "enabled": bool(sources),
            "source": source,
            "firing": sorted({r for s in planes.values()
                              for r in s.get("firing", [])}),
            "sources": planes,
        })

    def _statusz(self, h: _Handler, q: Dict[str, str]) -> None:
        """Fleet health score rollup: the one-curl operator verdict.
        Worst status and minimum health score across every registered
        FleetHealth plane, the firing rule set, the newest transitions
        (?limit=N, default 20), the process block, and the registry
        snapshot under "metrics" (so one fetch feeds dashboards and
        `tools/check_metrics.py` alike)."""
        limit = _parse_limit(h, q, default=20)
        if limit is _BAD_LIMIT:
            return
        sources = _perf_sources("alerts")
        planes = {}
        for label in sorted(sources):
            planes[label] = dict(sources[label]() or {})
        healths = [p.get("health", {}) for p in planes.values()]
        scores = [h_.get("score") for h_ in healths
                  if h_.get("score") is not None]
        statuses = [h_.get("status", "ok") for h_ in healths]
        status = ("page" if "page" in statuses
                  else "warn" if "warn" in statuses else "ok")
        recent = sorted(
            (t for p in planes.values()
             for t in p.get("transitions", [])),
            key=lambda t: t.get("ts_unix", 0))
        h._send_json({
            "enabled": bool(sources),
            "status": status,
            "health_score": min(scores) if scores else 100.0,
            "firing": sorted({r for p in planes.values()
                              for r in p.get("firing", [])}),
            "sources": {label: p.get("health", {})
                        for label, p in planes.items()},
            "transitions": recent[-limit:] if limit else [],
            "process": {
                "pid": os.getpid(),
                "threads": threading.active_count(),
                "server_uptime_s": round(
                    time.time() - self._started_unix, 3),
            },
            "metrics": self._registry.snapshot(),
        })

    def _stacksz(self, h: _Handler, q: Dict[str, str]) -> None:
        h._send(_watchdog.format_all_stacks().encode(),
                "text/plain; charset=utf-8")


# ---------------------------------------------------------------------------
# process-wide instance
# ---------------------------------------------------------------------------

_SERVER: Optional[DebugServer] = None
_SERVER_LOCK = threading.Lock()
_SERVER_REFS = 0
_SERVER_GEN = 0          # bumped per server instance; stale-release guard
_OPERATOR_REF = False    # start_debug_server's standing ref, at most one


def _ensure_locked(port: int, host: str) -> DebugServer:
    """Start-or-return under _SERVER_LOCK; raises if a DIFFERENT fixed
    port than the already-bound one was requested."""
    global _SERVER, _SERVER_GEN
    if _SERVER is not None:
        if port not in (0, _SERVER.port):
            raise RuntimeError(
                f"debug server already bound to port {_SERVER.port}; "
                f"cannot rebind to {port}")
        return _SERVER
    _SERVER = DebugServer(port=port, host=host)
    _SERVER_GEN += 1
    return _SERVER


def start_debug_server(port: int = 0, host: str = "127.0.0.1") -> int:
    """Start (or join) the process-wide debug server; returns the bound
    port (pass port=0 for an ephemeral one). Idempotent while running —
    a second call returns the existing port (and raises if it asked for
    a DIFFERENT fixed port than the one already bound). A server the
    operator touched this way holds a standing reference that engine
    teardowns never release: it stays up until stop_debug_server(),
    even if it was originally started by create_engine(debug_port=)."""
    global _SERVER_REFS, _OPERATOR_REF
    with _SERVER_LOCK:
        server = _ensure_locked(port, host)
        if not _OPERATOR_REF:
            _OPERATOR_REF = True
            _SERVER_REFS += 1
        return server.port


def acquire_debug_server(port: int = 0,
                         host: str = "127.0.0.1") -> "tuple[int, int]":
    """Start-or-join the process-wide server and take a reference
    (atomic); returns (bound port, release token). Pair every acquire
    with one release_debug_server(token): the server stops when the
    LAST reference is released, so rolling engine replacement
    (create_engine(debug_port=...) while an older engine still serves)
    can't tear diagnostics down under a live engine."""
    global _SERVER_REFS
    with _SERVER_LOCK:
        server = _ensure_locked(port, host)
        _SERVER_REFS += 1
        return server.port, _SERVER_GEN


def release_debug_server(token: Optional[int] = None) -> None:
    """Drop one acquire_debug_server() reference; stops the server when
    none remain. A token from a PREVIOUS server generation (the holder's
    server was force-stopped and a new one started since) is ignored —
    a stale release must not steal the new server's references."""
    global _SERVER, _SERVER_REFS
    with _SERVER_LOCK:
        if _SERVER is None:
            return
        if token is not None and token != _SERVER_GEN:
            return
        _SERVER_REFS = max(0, _SERVER_REFS - 1)
        if _SERVER_REFS == 0:
            _SERVER.stop()
            _SERVER = None


def get_debug_server() -> Optional[DebugServer]:
    return _SERVER


def stop_debug_server() -> None:
    """Force-stop regardless of outstanding references (operator/test
    teardown path)."""
    global _SERVER, _SERVER_REFS, _OPERATOR_REF
    with _SERVER_LOCK:
        if _SERVER is not None:
            _SERVER.stop()
            _SERVER = None
        _SERVER_REFS = 0
        _OPERATOR_REF = False
