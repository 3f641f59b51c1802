"""Deployable HTTP/SSE serving frontend over the replica router.

A copy of `paddle_tpu/server/service.py` (pure Python): the same
endpoints and the same SSE / JSON wire format, byte for byte, over the
port's router and engines (`tools/bench_serving.py --http` drives
either). `serve()` builds its replicas over the parameter tensors the
caller passes, on their device.

The reference ships inference as a deployable surface
(`paddle_inference_api.h` behind server scaffolding); this module is
that surface for the continuous-batching engine: a stdlib
`ThreadingHTTPServer` (same idiom as `observability/debug_server.py` —
the container has no web framework and needs none) exposing

    POST /v1/generate   JSON in, SSE token stream out (or one JSON
                        response with ``"stream": false``)
    GET  /healthz       readiness: ok (200) / draining (503) + live
                        per-replica slot/queue/block gauges
    GET  /metrics       Prometheus text exposition of the shared
                        process registry (serving_* + server_* series)
    GET  /metricz       the same exposition with per-replica series
                        aggregated into fleet totals (one scrape
                        covers every replica; ?raw=1 disables)
    GET  /alertz        fleet health alert plane (ServerConfig(health=
                        HealthConfig())): rule states + transition ring
    GET  /statusz       fleet health score rollup + replica states
    GET  /              endpoint index

Request JSON: ``{"prompt": [ids...], "max_new_tokens": n}`` plus
optional ``temperature`` / ``seed`` / ``eos_id`` / ``tenant`` /
``deadline_s`` / ``stream``. The SSE stream carries one
``data: {"token": id, "index": i}`` frame per generated token and a
final ``event: done`` frame with the finish reason
(stop/length/cancelled/deadline_exceeded/error) and the request's
latency cuts. A client that drops the connection mid-stream cancels
the request — its KV pages free and co-batched streams never notice.

Backpressure maps to status codes, never an exception escaping a
handler thread: tenant quota exhaustion and engine overload are 429
with a ``Retry-After`` hint (bucket-computed, or the engine's
queue-wait p50 from the structured EngineOverloadError), drain is 503,
malformed/impossible requests are 400.

Lifecycle: ``serve()`` starts the replica drivers + HTTP thread and
returns the bound port; ``shutdown()`` gracefully drains — stop
admitting, finish every in-flight stream, then tear engines down via
the refcounted ``close()`` path.
"""

from __future__ import annotations

import copy
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..observability.metrics import MetricsRegistry, get_registry
from ..serving.engine import EngineOverloadError, ServingEngine
from ..observability.alerts import HealthConfig
from .router import (DrainingError, QuotaConfig, QuotaExceededError,
                     RebalanceConfig, Router, SLOConfig, StreamHandle)

__all__ = ["ServerConfig", "GenerationServer", "serve"]

_INDEX = """<html><head><title>paddle_tpu server</title></head><body>
<h1>paddle_tpu serving service</h1><ul>
<li><code>POST /v1/generate</code> — JSON in, SSE token stream out</li>
<li><a href="/healthz">/healthz</a> — readiness + replica gauges</li>
<li><a href="/metrics">/metrics</a> — Prometheus text exposition</li>
<li><a href="/metricz">/metricz</a> — Prometheus text exposition with
per-replica series aggregated into fleet totals (<code>?raw=1</code>
for per-replica series)</li>
<li><a href="/slozv">/slozv</a> — per-tenant SLO attainment + goodput</li>
<li><a href="/alertz">/alertz</a> — fleet health alert plane: rule
states + transition ring (<code>?limit=</code>)</li>
<li><a href="/statusz">/statusz</a> — fleet health score rollup
(<code>?limit=</code>)</li>
<li><code>POST /admin/restart</code> — zero-downtime rolling restart of
one replica (<code>{"replica": i}</code>)</li>
</ul></body></html>
"""


class ServerConfig:
    """Service knobs. `replicas` engines share one router (least-loaded
    admission); `quotas` maps tenant -> QuotaConfig with `default_quota`
    for unlisted tenants (None = unlimited); `default_deadline_s` /
    `max_deadline_s` bound per-request deadlines (request values above
    the max are clamped); `drain_timeout_s` bounds shutdown's graceful
    drain; `retry_after_floor_s` is the minimum Retry-After hint when no
    better signal exists (no queue-wait samples yet);
    `stream_event_timeout_s` bounds the handler's wait per stream event
    so a wedged driver can't pin handler threads forever. The clock is
    injectable (quotas + deadlines) so tests pin exact behavior."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 replicas: int = 1,
                 serving=None,
                 quotas: Optional[Dict[str, QuotaConfig]] = None,
                 default_quota: Optional[QuotaConfig] = None,
                 slos: Optional[Dict[str, SLOConfig]] = None,
                 default_slo: Optional[SLOConfig] = None,
                 default_deadline_s: Optional[float] = None,
                 max_deadline_s: Optional[float] = None,
                 drain_timeout_s: float = 30.0,
                 retry_after_floor_s: float = 1.0,
                 stream_event_timeout_s: float = 60.0,
                 max_stream_retries: int = 1,
                 restart_backoff_s: float = 0.05,
                 restart_backoff_cap_s: float = 2.0,
                 rebalance: Optional[RebalanceConfig] = None,
                 health: Optional[HealthConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.host = host
        self.port = int(port)
        self.replicas = int(replicas)
        self.serving = serving
        self.quotas = dict(quotas or {})
        self.default_quota = default_quota
        # per-tenant SLO objectives, the quota wiring pattern: `slos`
        # maps tenant -> SLOConfig with `default_slo` for unlisted
        # tenants (None everywhere = the SLO plane stays dormant:
        # zero extra registry series)
        self.slos = dict(slos or {})
        self.default_slo = default_slo
        self.default_deadline_s = default_deadline_s
        self.max_deadline_s = max_deadline_s
        self.drain_timeout_s = float(drain_timeout_s)
        self.retry_after_floor_s = float(retry_after_floor_s)
        self.stream_event_timeout_s = float(stream_event_timeout_s)
        # failover knobs (router pass-through): how many times a
        # zero-token stream stranded by a replica failure re-submits,
        # and the backoff between a failed replica's rebuilds (base,
        # doubling each consecutive failure, capped at the cap)
        self.max_stream_retries = int(max_stream_retries)
        self.restart_backoff_s = float(restart_backoff_s)
        self.restart_backoff_cap_s = float(restart_backoff_cap_s)
        # pressure-driven cross-replica rebalancing (router
        # pass-through; None — the default — means the rebalancer
        # thread and its migration registry families don't exist)
        self.rebalance = rebalance
        # fleet health & alerting plane (router pass-through; None —
        # the default — means no sampler thread and no alert registry
        # families: the disabled path stays byte-identical)
        self.health = health
        self.clock = clock


def _clean_tenant(raw: Any) -> str:
    """Bound tenant label cardinality/size: a metrics label must never
    be attacker-sized."""
    tenant = str(raw) if raw is not None else "default"
    tenant = tenant.strip() or "default"
    return tenant[:64]


def _parse_request(payload: Dict[str, Any], cfg: ServerConfig):
    """Validate the generate body; raises ValueError with a message the
    400 response carries verbatim."""
    prompt = payload.get("prompt")
    if (not isinstance(prompt, (list, tuple)) or not prompt
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in prompt)):
        raise ValueError("'prompt' must be a non-empty list of token ids")
    if any(t < 0 for t in prompt):
        raise ValueError("'prompt' token ids must be >= 0")
    max_new = payload.get("max_new_tokens")
    if not isinstance(max_new, int) or isinstance(max_new, bool) \
            or max_new < 1:
        raise ValueError("'max_new_tokens' must be an integer >= 1")
    temperature = payload.get("temperature", 0.0)
    if not isinstance(temperature, (int, float)) \
            or isinstance(temperature, bool) or temperature < 0:
        raise ValueError("'temperature' must be a number >= 0")
    seed = payload.get("seed", 0)
    if not isinstance(seed, int) or isinstance(seed, bool):
        raise ValueError("'seed' must be an integer")
    eos_id = payload.get("eos_id")
    if eos_id is not None and (not isinstance(eos_id, int)
                               or isinstance(eos_id, bool) or eos_id < 0):
        raise ValueError("'eos_id' must be an integer >= 0 (or absent)")
    adapter_id = payload.get("adapter_id")
    if adapter_id is not None and (not isinstance(adapter_id, int)
                                   or isinstance(adapter_id, bool)
                                   or adapter_id < 0):
        raise ValueError("'adapter_id' must be an integer >= 0 "
                         "(0 = base model; absent = the tenant's "
                         "configured adapter binding)")
    deadline_s = payload.get("deadline_s", cfg.default_deadline_s)
    if deadline_s is not None:
        if not isinstance(deadline_s, (int, float)) \
                or isinstance(deadline_s, bool) or deadline_s <= 0:
            raise ValueError("'deadline_s' must be a number > 0")
        if cfg.max_deadline_s is not None:
            deadline_s = min(float(deadline_s), cfg.max_deadline_s)
    return np.asarray(prompt, np.int32), dict(
        max_new_tokens=max_new, temperature=float(temperature),
        seed=int(seed), eos_id=eos_id, deadline_s=deadline_s,
        adapter_id=adapter_id)


def _retry_after_header(retry_after_s: Optional[float],
                        floor_s: float) -> str:
    """Retry-After is whole seconds per RFC 7231; round the hint UP and
    never below the floor (a 0s hint invites an immediate retry storm).
    An inf hint (quota that can never grant) still gets a finite,
    honest-ish backoff."""
    if retry_after_s is None or math.isinf(retry_after_s):
        retry_after_s = max(floor_s, 30.0) if retry_after_s is not None \
            else floor_s
    return str(max(1, math.ceil(max(retry_after_s, floor_s))))


class _Handler(BaseHTTPRequestHandler):
    server: "ThreadingHTTPServer"   # carries .gen_server

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # no stderr spam per request
        pass

    # -- plumbing -----------------------------------------------------------

    def _send(self, body: bytes, ctype: str, status: int = 200,
              extra: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj: Any, status: int = 200,
                   extra: Optional[Dict[str, str]] = None) -> None:
        self._send(json.dumps(obj, indent=2, default=str).encode(),
                   "application/json", status, extra)

    # -- routing ------------------------------------------------------------

    def do_GET(self):   # noqa: N802 (http.server API)
        srv: "GenerationServer" = self.server.gen_server
        path = urlparse(self.path).path
        try:
            if path == "/":
                self._send(_INDEX.encode(), "text/html; charset=utf-8")
            elif path == "/healthz":
                self._healthz(srv)
            elif path == "/metrics":
                self._send(srv._registry.to_prometheus().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/metricz":
                # one scrape covers the fleet: per-replica ("engine"-
                # labeled) series merge into totals unless ?raw=1
                q = parse_qs(urlparse(self.path).query)
                raw = (q.get("raw") or ["0"])[0] not in ("0", "", "false")
                self._send(
                    srv.router.prometheus_text(aggregate=not raw)
                    .encode(),
                    "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/slozv":
                self._slozv(srv)
            elif path == "/alertz":
                self._alertz(srv)
            elif path == "/statusz":
                self._statusz(srv)
            elif path == "/v1/generate":
                self._send_json({"error": "use POST"}, status=405,
                                extra={"Allow": "POST"})
            else:
                self._send_json(
                    {"error": f"no such endpoint {path!r}",
                     "endpoints": ["/", "/healthz", "/metrics",
                                   "/metricz", "/slozv", "/alertz",
                                   "/statusz", "/v1/generate",
                                   "/admin/restart"]},
                    status=404)
        except BrokenPipeError:
            pass
        except Exception as e:   # a broken endpoint must report, not die
            self._best_effort_error(e)

    def do_POST(self):  # noqa: N802 (http.server API)
        path = urlparse(self.path).path
        try:
            if path == "/v1/generate":
                self._generate(self.server.gen_server)
            elif path == "/admin/restart":
                self._admin_restart(self.server.gen_server)
            else:
                self._send_json(
                    {"error": f"no such endpoint {path!r}"}, status=404)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:
            self._best_effort_error(e)

    def _best_effort_error(self, e: Exception) -> None:
        try:
            self._send_json({"error": f"{type(e).__name__}: {e}"},
                            status=500)
        except Exception:
            pass

    # -- endpoints ----------------------------------------------------------

    def _healthz(self, srv: "GenerationServer") -> None:
        router = srv.router
        draining = router.draining
        self._send_json({
            "status": "draining" if draining else "ok",
            "inflight": router.inflight,
            "uptime_s": round(time.time() - srv._started_unix, 3),
            # fleet-level fault-tolerance counters (the same numbers
            # the server_replica_{failures,restarts}_total series
            # carry in /metrics)
            "replica_failures": router.metrics.replica_failures,
            "replica_restarts": router.metrics.replica_restarts,
            "replicas": [
                {"engine": r.label,
                 # OK / FAILED / RESTARTING supervision state (lower-
                 # case to match the router's internal names)
                 "state": r.state,
                 "active_slots": int(r.engine.metrics.active_slots),
                 "queue_depth": int(r.engine.metrics.queue_depth),
                 "kv_blocks_used": int(r.engine.metrics.kv_blocks_used),
                 "kv_blocks_total": int(r.engine.metrics.kv_blocks_total),
                 # mesh geometry next to the block gauges: which
                 # replicas are tensor-parallel, and the KV bytes ONE
                 # chip actually holds (pool_bytes / tp) — whole-arena
                 # numbers alone would overstate per-chip HBM
                 "mesh_shape": list(r.mesh_shape),
                 "hbm_per_chip_bytes": int(
                     r.engine.kv.hbm_per_chip_bytes),
                 # quantization identity: the arena storage dtype and
                 # the served weight bytes — operators sizing a fleet
                 # must see which replicas run quantized (a
                 # dtype-blind reading of the block gauges would
                 # overstate an int8 replica's HBM ~4x)
                 "kv_dtype": r.engine.kv.kv_dtype,
                 "weight_bytes": int(r.engine.weight_bytes),
                 "swapped_slots": int(r.engine.metrics.swapped_slots),
                 "preemptions": int(r.engine.metrics.preemptions),
                 # completed cross-replica migrations this replica
                 # sourced / adopted (host mirrors of the
                 # server_migrations_total accounting)
                 "migrations_out": r.migrations_out,
                 "migrations_in": r.migrations_in,
                 # adapter pool occupancy: 0 on adapterless replicas
                 # (no pool ⇒ nothing resident), so operators can see
                 # at a glance which replicas can adopt an
                 # adapter-bearing migration ticket
                 "adapters_resident": int(
                     r.engine.adapters.resident_count)
                 if r.engine.adapters is not None else 0}
                for r in router.replicas],
        }, status=503 if draining else 200)

    def _slozv(self, srv: "GenerationServer") -> None:
        """Router-level SLO attainment: per-tenant objective met/missed
        + goodput, aggregated across every replica (scoring happens at
        the router, so one report covers the fleet). `slo_enabled`
        False means no SLOConfig is set anywhere — the accounting plane
        is dormant and `tenants` stays empty."""
        router = srv.router
        self._send_json({
            "router": router.metrics.label,
            "slo_enabled": router.slo_enabled,
            "replicas": len(router.replicas),
            "tenants": router.slo_report(),
        })

    def _parse_limit(self, default: int) -> Optional[int]:
        """?limit= for the alert endpoints: non-negative int, `default`
        when absent; malformed/negative sends the 400 (the debug-server
        ring-endpoint contract) and returns None."""
        q = parse_qs(urlparse(self.path).query)
        raw = (q.get("limit") or [None])[0]
        if raw is None:
            return default
        try:
            limit = int(raw)
        except ValueError:
            limit = -1
        if limit < 0:
            self._send_json({"error": f"bad limit {raw!r}: expected a "
                             "non-negative integer"}, status=400)
            return None
        return limit

    def _alertz(self, srv: "GenerationServer") -> None:
        """Fleet health alert plane for THIS router: per-rule state +
        the bounded alert-transition ring (?limit=N newest transitions,
        default 100). `enabled` False means the server was built
        without a HealthConfig — the plane is dormant."""
        limit = self._parse_limit(default=100)
        if limit is None:
            return
        health = srv.router.health
        if health is None:
            self._send_json({"enabled": False, "firing": [],
                             "transitions": []})
            return
        snap = health.snapshot()
        trans = snap.get("transitions", [])
        snap["transitions"] = trans[-limit:] if limit else []
        snap["enabled"] = True
        self._send_json(snap)

    def _statusz(self, srv: "GenerationServer") -> None:
        """Fleet health score rollup for THIS router: status + score +
        firing rules + newest transitions (?limit=N, default 20), next
        to the replica states /healthz already carries."""
        limit = self._parse_limit(default=20)
        if limit is None:
            return
        router = srv.router
        health = router.health
        h = health.health() if health is not None \
            else {"status": "ok", "score": 100.0, "firing": []}
        trans = (health.engine.transitions(limit)
                 if health is not None else [])
        self._send_json({
            "enabled": health is not None,
            "status": h["status"],
            "health_score": h["score"],
            "firing": h["firing"],
            "transitions": trans,
            "router": router.metrics.label,
            "replicas": [{"engine": r.label, "state": r.state}
                         for r in router.replicas],
        })

    def _admin_restart(self, srv: "GenerationServer") -> None:
        """POST /admin/restart {"replica": i}: zero-downtime rolling
        restart of one replica — its queued and running sequences
        MIGRATE to healthy peers (open SSE streams continue
        token-identically), then the replica rebuilds via the engine
        factory and rejoins. Blocks until done (bounded by the drain
        timeout): 200 on success, 400 for a bad body/index, 409 when
        the replica is not currently ok, 503 while draining, 504 when
        the restart outran the timeout (it keeps going — poll
        /healthz)."""
        router = srv.router
        try:
            length = int(self.headers.get("Content-Length") or 0)
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, TypeError) as e:
            return self._send_json(
                {"error": f"bad request body: {e}"}, status=400)
        idx = payload.get("replica")
        if not isinstance(idx, int) or isinstance(idx, bool) \
                or not 0 <= idx < len(router.replicas):
            return self._send_json(
                {"error": "'replica' must be an integer in "
                          f"[0, {len(router.replicas)})"}, status=400)
        force = payload.get("force", False)
        if not isinstance(force, bool):
            return self._send_json(
                {"error": "'force' must be a boolean"}, status=400)
        old_label = router.replicas[idx].label
        try:
            ok = router.restart_replica(
                idx, timeout=srv.config.drain_timeout_s, force=force)
        except DrainingError as e:
            return self._send_json({"error": str(e)}, status=503)
        except ValueError as e:       # replica not in a restartable state
            return self._send_json({"error": str(e)}, status=409)
        replica = router.replicas[idx]
        body = {"restarted": ok, "replica": idx,
                "old_engine": old_label, "engine": replica.label,
                "state": replica.state,
                "migrations_out": replica.migrations_out,
                "restarts_total": replica.restarts_total}
        self._send_json(body, status=200 if ok else 504)

    def _reject(self, srv: "GenerationServer", code: int, message: str,
                tenant: str,
                retry_after_s: Optional[float] = None) -> None:
        srv.router.metrics.observe_request(tenant, code)
        extra = None
        body: Dict[str, Any] = {"error": message}
        if code in (429, 503):
            header = _retry_after_header(
                retry_after_s, srv.config.retry_after_floor_s)
            extra = {"Retry-After": header}
            body["retry_after_s"] = retry_after_s \
                if retry_after_s is not None \
                and not math.isinf(retry_after_s) else float(header)
        self._send_json(body, status=code, extra=extra)

    def _generate(self, srv: "GenerationServer") -> None:
        cfg, router = srv.config, srv.router
        try:
            length = int(self.headers.get("Content-Length") or 0)
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, TypeError) as e:
            return self._reject(srv, 400, f"bad request body: {e}",
                                "invalid")
        tenant = _clean_tenant(payload.get("tenant"))
        try:
            prompt, kw = _parse_request(payload, cfg)
        except ValueError as e:
            return self._reject(srv, 400, str(e), tenant)
        stream = payload.get("stream", True)
        try:
            handle = router.submit(prompt, tenant=tenant, **kw)
        except DrainingError as e:
            return self._reject(srv, 503, str(e), tenant,
                                retry_after_s=cfg.drain_timeout_s)
        except QuotaExceededError as e:
            return self._reject(srv, 429, str(e), tenant,
                                retry_after_s=e.retry_after_s)
        except EngineOverloadError as e:
            # the engine's structured shed: retry hint = queue-wait p50
            return self._reject(srv, 429, str(e), tenant,
                                retry_after_s=e.retry_after_s)
        except ValueError as e:   # request can never be served
            return self._reject(srv, 400, str(e), tenant)
        if stream:
            self._stream_sse(srv, handle, tenant)
        else:
            self._respond_json(srv, handle, tenant)

    def _respond_json(self, srv: "GenerationServer", handle: StreamHandle,
                      tenant: str) -> None:
        # consume event by event like the SSE path so the timeout bounds
        # the wait PER TOKEN, not the whole generation — a long healthy
        # generation must not 500 just because its total exceeds the
        # per-event bound
        tokens, reason = [], None
        try:
            for kind, value in handle.events(
                    timeout=srv.config.stream_event_timeout_s):
                if kind == "token":
                    tokens.append(value)
                else:
                    reason = value
        except TimeoutError as e:
            srv.router.cancel(handle, reason="error")
            return self._reject(srv, 500, str(e), tenant)
        srv.router.metrics.observe_request(tenant, 200)
        body = {
            "request_id": handle.request_id,
            "tokens": tokens,
            "finish_reason": reason,
            "metrics": handle.request.metrics.to_dict()
            if handle.request is not None else {},
        }
        if reason == "replica_failed":
            # the serving replica died mid-generation: the client should
            # re-submit after a short backoff (a header can't carry this
            # — the 200 status line is long gone on the SSE twin, so
            # both paths put the hint in the terminal payload)
            body["retry_after_s"] = srv.config.retry_after_floor_s
        self._send_json(body)

    def _stream_sse(self, srv: "GenerationServer", handle: StreamHandle,
                    tenant: str) -> None:
        router = srv.router
        router.metrics.observe_request(tenant, 200)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        # no Content-Length on a stream: close delimits the body (and
        # send_header("Connection", "close") flips close_connection)
        self.send_header("Connection", "close")
        self.end_headers()
        index = 0
        try:
            for kind, value in handle.events(
                    timeout=srv.config.stream_event_timeout_s):
                if kind == "token":
                    frame = json.dumps({"token": value, "index": index})
                    self.wfile.write(f"data: {frame}\n\n".encode())
                    self.wfile.flush()
                    index += 1
                else:   # terminal event
                    done = {"request_id": handle.request_id,
                            "finish_reason": value, "tokens": index}
                    if value == "replica_failed":
                        # mid-stream replica death: headers are long
                        # sent, so the retry hint rides the done frame
                        done["retry_after_s"] = \
                            srv.config.retry_after_floor_s
                    if handle.request is not None:
                        done["metrics"] = handle.request.metrics.to_dict()
                    self.wfile.write(
                        f"event: done\ndata: {json.dumps(done)}\n\n"
                        .encode())
                    self.wfile.flush()
        except TimeoutError:
            # no event within the bound (wedged driver): NOT a client
            # disconnect — TimeoutError is an OSError subclass, so this
            # clause must come first or it would count as one
            router.cancel(handle, reason="error")
        except OSError:
            # the client dropped the connection: cancel so the request's
            # KV pages free; co-batched streams never notice (pinned in
            # tests/test_server.py)
            router.cancel(handle)


class GenerationServer:
    """The deployable service: a Router over engine replicas behind one
    ThreadingHTTPServer. Build over existing engines (or a prebuilt
    Router), `serve()` to start, `shutdown()` to drain and tear down."""

    def __init__(self, engines, config: Optional[ServerConfig] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.config = config or ServerConfig()
        if isinstance(engines, Router):
            self.router = engines
        else:
            # no engine factory here (the caller owns engine
            # construction): failed replicas park and are routed
            # around; pt.server.serve() builds a factory-backed router
            self.router = Router(
                list(engines),
                quotas=self.config.quotas,
                default_quota=self.config.default_quota,
                slos=self.config.slos,
                default_slo=self.config.default_slo,
                clock=self.config.clock,
                registry=registry,
                max_stream_retries=self.config.max_stream_retries,
                restart_backoff_s=self.config.restart_backoff_s,
                restart_backoff_cap_s=self.config.restart_backoff_cap_s,
                rebalance=self.config.rebalance,
                health=self.config.health)
        self._registry = registry or get_registry()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._started_unix = time.time()
        self.host: Optional[str] = None
        self.port: Optional[int] = None

    def serve(self) -> int:
        """Start the replica driver threads and the HTTP accept thread;
        returns the bound port (config.port=0 binds an ephemeral one).
        Idempotent while running."""
        if self._started:
            return self.port
        if self.router.closed:
            # the router's engines are torn down: a rebind would be a
            # zombie that 503s everything while re-minting dead labels
            raise RuntimeError(
                "server was shut down; build a new GenerationServer")
        self.router.start()
        self._httpd = ThreadingHTTPServer(
            (self.config.host, self.config.port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.gen_server = self
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pt-serve-http",
            daemon=True)
        self._thread.start()
        self._started = True
        self._started_unix = time.time()
        return self.port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Graceful teardown: stop admitting (new requests get 503),
        finish every in-flight stream (bounded by `timeout`, default
        config.drain_timeout_s), then stop the HTTP server and close
        every engine through the refcounted close() path. With
        drain=False, in-flight streams are cancelled instead."""
        if timeout is None:
            timeout = self.config.drain_timeout_s
        if drain:
            self.router.drain(timeout=timeout)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            if self._thread is not None:
                self._thread.join(timeout=10.0)
            self._httpd = None
            self._thread = None
        # drain already ran (or was skipped on purpose): close must not
        # wait again, just cancel leftovers and tear down
        self.router.close(drain=False)
        self._started = False


def serve(params, cfg, config: Optional[ServerConfig] = None,
          registry: Optional[MetricsRegistry] = None) -> GenerationServer:
    """One-call deployment: build `config.replicas` ServingEngine
    replicas over a GPT parameter pytree (gpt_decode's params/cfg, the
    same pair ServingEngine takes) and start the HTTP service. Returns
    the started GenerationServer; the bound port is `server.port`."""
    from ..serving import ServingConfig

    config = config or ServerConfig()
    serving = config.serving if config.serving is not None \
        else ServingConfig()

    def factory() -> ServingEngine:
        # the replica supervisor's rebuild hook: a FAILED replica gets
        # a FRESH engine over the same params/config and rejoins
        # admission (params live for the server's life either way) —
        # minus any fault plan: a plan observes ONE engine's step
        # stream (faults.py contract), and a rebuilt engine restarts
        # at step 0, so re-arming the schedule would turn a one-shot
        # injected fault into a permanent crash/rebuild loop
        if serving.fault_plan is not None:
            clean = copy.copy(serving)
            clean.fault_plan = None
            return ServingEngine(params, cfg, clean)
        return ServingEngine(params, cfg, serving)

    def initial() -> ServingEngine:
        return ServingEngine(params, cfg, serving)

    engines = [initial() for _ in range(config.replicas)]
    router = Router(engines,
                    quotas=config.quotas,
                    default_quota=config.default_quota,
                    slos=config.slos,
                    default_slo=config.default_slo,
                    clock=config.clock,
                    registry=registry,
                    engine_factory=factory,
                    max_stream_retries=config.max_stream_retries,
                    restart_backoff_s=config.restart_backoff_s,
                    restart_backoff_cap_s=config.restart_backoff_cap_s,
                    rebalance=config.rebalance,
                    health=config.health)
    server = GenerationServer(router, config, registry=registry)
    server.serve()
    return server
