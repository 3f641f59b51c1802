"""The PyTorch port's server tier (`paddle_tpu_torch.server`: router,
HTTP service, debug and alert planes) on the CPU, on the tiny GPT of
tests/test_server.py (vocab 97, hidden 32, 2 layers, 2 slots, max_len
32). Mirrors tests/test_server.py's contracts with the port's engines
behind the wire; every stream the service delivers is held token for
token against the JAX engine's library-path stream on the same weights
(`library_stream`):

  * SSE and JSON streams; 400s for bad requests; /healthz, /metrics and
    /metricz; quotas and overload as 429 with Retry-After; a concurrent
    graceful drain that drops no token; client disconnects and deadlines
    cancel in-flight work and free its pages;
  * least-loaded spread, failover of zero-token streams, rebuilds via
    the engine factory, drain with parked (preempted) sequences;
  * `Router.migrate` of a live stream, one injected migration fault a
    phase recovered exactly once, `restart_replica` with zero dropped
    tokens;
  * `/alertz` and `/statusz`, `serve()` with two preempting replicas,
    `create_engine(debug_port=0)`'s `/healthz`, `/tickz` and
    `/compilez`;
  * the server's modules import neither jax nor paddle_tpu.

The JAX soaks marked `slow` are not ported.
"""

import ast
import http.client
import json
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import gpt_decode as gd
from paddle_tpu.models.gpt import GPTConfig, gpt_lm_program
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch.models import gpt_decode as tgd
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.server import (AdapterConfig, DrainingError,
                                     GenerationServer, QuotaConfig,
                                     Router, ServerConfig, TokenBucket)
from paddle_tpu_torch.serving import (EngineOverloadError, FaultPlan,
                                      ServingConfig, ServingEngine)
from test_torch_serving import _close_engines, _opened  # noqa: F401
from torch_port_common import one_torch_thread  # noqa: F401


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(mod):
    return mod(vocab_size=97, hidden=32, layers=2, heads=4, max_pos=64,
               dropout=0.0, attn_impl="xla")


class _Trained(tuple):
    """(port cfg, port params), with the JAX twin's `jax_engine` (the
    reference every library_stream reads) alongside."""


@pytest.fixture(scope="module")
def trained():
    cfg = _cfg(GPTConfig)
    with pt.unique_name_guard():
        main, startup, _ = gpt_lm_program(cfg, 8, is_test=True)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor().run(startup)
        jp = gd.collect_gpt_params(scope, cfg)
    arrays = {v.name: np.asarray(scope.find_var(v.name))
              for v in main.list_vars() if v.persistable
              and scope.find_var(v.name) is not None}
    tscope = ptt.Scope()
    ptt.io.set_params_from_numpy(tscope, arrays, "cpu")
    tcfg = _cfg(TGPTConfig)
    t = _Trained((tcfg, tgd.collect_gpt_params(tscope, tcfg)))
    t.jax_engine = JServingEngine(jp, cfg, JServingConfig(
        num_slots=2, max_queue=16, prefill_buckets=(4, 8), max_len=32))
    t.refs = {}
    yield t
    t.jax_engine.close()


def make_engine(trained, **kw):
    cfg, params = trained
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_queue", 16)
    kw.setdefault("prefill_buckets", (4, 8))
    kw.setdefault("max_len", 32)
    return _opened(ServingEngine(params, cfg, ServingConfig(**kw)))


def make_server(trained, n=1, server_kw=None, **engine_kw):
    engines = [make_engine(trained, **engine_kw) for _ in range(n)]
    srv = GenerationServer(engines, ServerConfig(**(server_kw or {})))
    srv.serve()
    return srv


def library_stream(trained, prompt, max_new, **kw):
    """The JAX engine's library-path token stream for one request (a
    seeded stream is a function of the weights, prompt and seed only, so
    one shared JAX engine serves every reference)."""
    key = (tuple(int(t) for t in prompt), int(max_new),
           tuple(sorted(kw.items())))
    if key not in trained.refs:
        stream = []
        trained.jax_engine.submit(np.asarray(prompt, np.int32), max_new,
                                  on_token=lambda r, t: stream.append(t),
                                  **kw)
        trained.jax_engine.run_until_drained()
        trained.refs[key] = stream
    return list(trained.refs[key])


# ---------------------------------------------------------------------------
# wire client helpers (stdlib http.client)
# ---------------------------------------------------------------------------

def _post(port, payload, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/generate", json.dumps(payload),
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


def sse_generate(port, payload, timeout=60):
    """POST /v1/generate and consume the whole SSE stream. Returns
    (status, headers, tokens, done_payload_or_error_body)."""
    conn, r = _post(port, payload, timeout=timeout)
    try:
        if r.status != 200:
            return r.status, dict(r.getheaders()), [], \
                json.loads(r.read() or b"{}")
        tokens, done, event = [], None, "message"
        for line in iter(r.readline, b""):
            line = line.decode().rstrip("\n")
            if not line:
                event = "message"
                continue
            if line.startswith("event: "):
                event = line[7:]
                continue
            if line.startswith("data: "):
                obj = json.loads(line[6:])
                if event == "done":
                    done = obj
                else:
                    tokens.append(obj["token"])
        return r.status, dict(r.getheaders()), tokens, done
    finally:
        conn.close()


def _get_json(port, path, expect=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        body = r.read()
        if expect is not None:
            assert r.status == expect, (path, r.status, body[:500])
        return r.status, json.loads(body)
    finally:
        conn.close()


def _registry_value(family, **labels):
    snap = ptt.observability.get_registry().snapshot()
    for row in snap.get(family, {}).get("series", []):
        if all(row["labels"].get(k) == v for k, v in labels.items()):
            return row["value"]
    return None


# ---------------------------------------------------------------------------
# the contracts of tests/test_server.py, on the port
# ---------------------------------------------------------------------------

def test_sse_stream_token_identical_to_library_path(trained):
    """Acceptance: greedy AND seeded-sampled SSE output reproduces the
    library-path ServingEngine stream token for token, and the done
    frame carries the finish reason + request id."""
    srv = make_server(trained)
    try:
        prompt = [3, 1, 4, 1, 5]
        # greedy
        ref = library_stream(trained, prompt, 6)
        status, headers, tokens, done = sse_generate(
            srv.port, {"prompt": prompt, "max_new_tokens": 6})
        assert status == 200
        assert headers.get("Content-Type") == "text/event-stream"
        assert tokens == ref
        assert done["finish_reason"] == "length"
        assert done["tokens"] == 6
        assert done["request_id"]
        # seeded sampling: per-request PRNG makes the stream a function
        # of (params, prompt, seed), not of batching/transport
        ref = library_stream(trained, prompt, 6, temperature=0.8, seed=7)
        status, _, tokens, done = sse_generate(
            srv.port, {"prompt": prompt, "max_new_tokens": 6,
                       "temperature": 0.8, "seed": 7})
        assert status == 200
        assert tokens == ref
    finally:
        srv.shutdown()


def test_non_stream_json_response(trained):
    srv = make_server(trained)
    try:
        prompt = [9, 2, 6]
        ref = library_stream(trained, prompt, 5)
        conn, r = _post(srv.port, {"prompt": prompt, "max_new_tokens": 5,
                                   "stream": False})
        try:
            assert r.status == 200
            body = json.loads(r.read())
        finally:
            conn.close()
        assert body["tokens"] == ref
        assert body["finish_reason"] == "length"
        assert body["request_id"]
        assert body["metrics"]["tokens_out"] == 5
    finally:
        srv.shutdown()


def test_rejects_bad_requests_as_400(trained):
    srv = make_server(trained)
    try:
        cases = [
            ({}, "'prompt'"),
            ({"prompt": [], "max_new_tokens": 4}, "'prompt'"),
            ({"prompt": ["a"], "max_new_tokens": 4}, "'prompt'"),
            ({"prompt": [1, 2]}, "'max_new_tokens'"),
            ({"prompt": [1, 2], "max_new_tokens": 0}, "'max_new_tokens'"),
            ({"prompt": [1, 2], "max_new_tokens": 4,
              "temperature": -1}, "'temperature'"),
            ({"prompt": [1, 2], "max_new_tokens": 4,
              "deadline_s": 0}, "'deadline_s'"),
            # impossible request: engine validation propagates as 400
            ({"prompt": [1, 2, 3], "max_new_tokens": 400}, "max_len"),
        ]
        for payload, needle in cases:
            status, _, _, body = sse_generate(srv.port, payload)
            assert status == 400, (payload, status, body)
            assert needle in body["error"], (payload, body)
        # malformed JSON body
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=30)
        try:
            conn.request("POST", "/v1/generate", "{not json",
                         {"Content-Type": "application/json"})
            assert conn.getresponse().status == 400
        finally:
            conn.close()
        # unknown endpoint + wrong method
        status, body = _get_json(srv.port, "/nope")
        assert status == 404 and "endpoint" in body["error"]
        status, body = _get_json(srv.port, "/v1/generate")
        assert status == 405
    finally:
        srv.shutdown()


def test_healthz_and_metrics_endpoints(trained):
    srv = make_server(trained, n=2)
    try:
        status, body = _get_json(srv.port, "/healthz", expect=200)
        assert body["status"] == "ok"
        assert len(body["replicas"]) == 2
        for rep in body["replicas"]:
            assert {"engine", "active_slots", "queue_depth",
                    "kv_blocks_used",
                    "kv_blocks_total"} <= set(rep)
            # mesh geometry rides next to the block gauges so an
            # operator can see which replicas are tensor-parallel and
            # what ONE chip holds (single-chip fleet here: tp=1,
            # per-chip bytes == whole arena)
            assert rep["mesh_shape"] == [1]
            assert rep["hbm_per_chip_bytes"] > 0
        status, _, tokens, _ = sse_generate(
            srv.port, {"prompt": [1, 2, 3], "max_new_tokens": 3,
                       "tenant": "acme"})
        assert status == 200 and len(tokens) == 3
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=30)
        try:
            conn.request("GET", "/metrics")
            r = conn.getresponse()
            text = r.read().decode()
            assert r.status == 200
        finally:
            conn.close()
        # per-tenant request counter + router gauges + engine series all
        # ride the one shared scrape surface
        assert 'tenant="acme"' in text
        assert "server_requests_total{" in text
        assert "server_active_streams{" in text
        assert "serving_submitted_total{" in text

        # /metricz: the Prometheus surface with router-level
        # aggregation — one scrape covers the whole 2-replica fleet
        # (engine label folded into fleet totals); ?raw=1 keeps the
        # per-replica series
        def get_text(path):
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=30)
            try:
                conn.request("GET", path)
                r = conn.getresponse()
                assert r.status == 200
                assert r.getheader("Content-Type").startswith(
                    "text/plain; version=0.0.4")
                return r.read().decode()
            finally:
                conn.close()

        agg = get_text("/metricz")
        assert 'engine="' not in agg
        assert "serving_submitted_total " in agg       # fleet total
        assert agg == srv.router.prometheus_text()
        raw = get_text("/metricz?raw=1")
        # each replica keeps its own engine-labelled series in raw mode
        # (count per label, not in total: other engines from the same
        # process may share the registry)
        for rep in srv.router.replicas:
            label = rep.engine.metrics.engine_label
            assert raw.count(
                'serving_submitted_total{engine="%s"' % label) == 1
        assert raw == srv.router.prometheus_text(aggregate=False)
    finally:
        srv.shutdown()


def test_token_bucket_math_fake_clock():
    t = [0.0]
    b = TokenBucket(capacity=10, refill_per_s=2.0, clock=lambda: t[0])
    assert b.try_take(8) == 0.0            # burst grant
    assert b.tokens == pytest.approx(2.0)
    retry = b.try_take(6)                  # deficit 4 at 2/s
    assert retry == pytest.approx(2.0)
    t[0] = 2.0                             # refilled to 6
    assert b.try_take(6) == 0.0
    assert b.try_take(11) == float("inf")  # can NEVER grant > capacity
    t[0] = 100.0
    assert b.tokens == pytest.approx(10.0)  # capped at capacity
    frozen = TokenBucket(capacity=4, refill_per_s=0.0, clock=lambda: t[0])
    assert frozen.try_take(4) == 0.0
    assert frozen.try_take(1) == float("inf")   # no refill ever


def test_quota_shed_maps_to_429_with_retry_after(trained):
    srv = make_server(
        trained,
        server_kw=dict(quotas={"small": QuotaConfig(capacity=20,
                                                    refill_per_s=0.5)}))
    try:
        req = {"prompt": [1, 2, 3, 4], "max_new_tokens": 8,
               "tenant": "small"}          # cost 12 tokens
        status, _, tokens, _ = sse_generate(srv.port, req)
        assert status == 200 and len(tokens) == 8
        status, headers, _, body = sse_generate(srv.port, req)
        assert status == 429, body
        assert int(headers["Retry-After"]) >= 1
        assert body["retry_after_s"] > 0
        assert "quota" in body["error"]
        # an unlimited tenant is unaffected
        status, _, tokens, _ = sse_generate(
            srv.port, {**req, "tenant": "big"})
        assert status == 200 and len(tokens) == 8
        assert _registry_value("server_quota_rejections_total",
                               tenant="small") == 1
        assert _registry_value("server_requests_total", tenant="small",
                               code="429") == 1
    finally:
        srv.shutdown()


def test_overload_429_while_concurrent_drain_completes_streams(trained):
    """Acceptance: with the slot busy and the queue full, a new request
    gets 429 + Retry-After; a graceful drain started while both streams
    are in flight completes them with ZERO dropped tokens; post-drain
    requests get 503; shutdown retires every registry label."""
    srv = make_server(trained, num_slots=1, max_queue=1, decode_chunk=2)
    eng = srv.router.replicas[0].engine
    prompt = [5, 9, 2, 4]
    max_new = 24
    ref = library_stream(trained, prompt, max_new)
    # pace the decode loop (test-only): the polls below observe the
    # TRANSIENT running/queued states, and a warm engine can otherwise
    # admit AND retire a whole request between two poll ticks
    orig_step = eng.scheduler.step

    def paced_step():
        time.sleep(0.003)
        return orig_step()

    eng.scheduler.step = paced_step

    results = {}

    def run_stream(name, payload):
        results[name] = sse_generate(srv.port, payload, timeout=120)

    try:
        ta = threading.Thread(target=run_stream, args=(
            "A", {"prompt": prompt, "max_new_tokens": max_new}))
        ta.start()
        # wait until A occupies the slot (admitted = running)
        deadline = time.monotonic() + 120
        while eng.scheduler.active_count < 1:
            assert srv.router.replicas[0]._thread.is_alive()
            assert time.monotonic() < deadline, "A never admitted"
            time.sleep(0.002)
        # B fills the queue (will be admitted when A's slot frees)
        tb = threading.Thread(target=run_stream, args=(
            "B", {"prompt": prompt, "max_new_tokens": max_new}))
        tb.start()
        while int(eng.metrics.queue_depth) < 1 \
                and "B" not in results:
            assert time.monotonic() < deadline, "B never queued"
            time.sleep(0.002)
        # C: queue full -> 429 + Retry-After, a structured shed
        status, headers, _, body = sse_generate(
            srv.port, {"prompt": prompt, "max_new_tokens": max_new})
        assert status == 429, body
        assert int(headers["Retry-After"]) >= 1
        assert "queue full" in body["error"]
        # concurrent graceful drain: in-flight A and queued B both
        # complete, token-perfect
        assert srv.router.drain(timeout=120) is True
        ta.join(timeout=60)
        tb.join(timeout=60)
        for name in ("A", "B"):
            status, _, tokens, done = results[name]
            assert status == 200, (name, results[name])
            assert tokens == ref, name           # zero dropped tokens
            assert done["finish_reason"] == "length"
        # draining: new requests shed with 503
        status, headers, _, body = sse_generate(
            srv.port, {"prompt": prompt, "max_new_tokens": 2})
        assert status == 503
        assert "Retry-After" in headers
        status, body = _get_json(srv.port, "/healthz", expect=503)
        assert body["status"] == "draining"
        label = eng.metrics.engine_label
        router_label = srv.router.metrics.label
    finally:
        srv.shutdown()
    # teardown retired the engine's AND the router's registry series
    assert _registry_value("serving_submitted_total",
                           engine=label) is None
    assert _registry_value("server_active_streams",
                           router=router_label) is None


def test_client_disconnect_cancels_and_frees_pages(trained):
    """Satellite acceptance: dropping the SSE connection mid-stream
    cancels the request (it never completes), its KV pages free back to
    baseline, and the co-batched stream is token-identical to the
    library path."""
    srv = make_server(trained, num_slots=2, decode_chunk=1, max_len=64)
    eng = srv.router.replicas[0].engine
    try:
        assert eng.kv.blocks_used == 0           # baseline
        prompt_a, prompt_b = [7, 7, 7, 7], [2, 4, 6]
        ref_b = library_stream(trained, prompt_b, 16)
        # pace the decode loop (test-only) so A's 56-token stream is
        # still in flight when the disconnect lands — the RST/cancel
        # race against raw CPU decode speed would otherwise be flaky
        orig_step = eng.scheduler.step

        def paced_step():
            time.sleep(0.004)
            return orig_step()

        eng.scheduler.step = paced_step
        # A: start streaming a long generation (56 tokens at chunk=1)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=60)
        conn.request("POST", "/v1/generate",
                     json.dumps({"prompt": prompt_a,
                                 "max_new_tokens": 56}),
                     {"Content-Type": "application/json"})
        sock = conn.sock            # grab before the response detaches it
        r = conn.getresponse()
        assert r.status == 200
        line = r.readline()
        assert line.startswith(b"data: ")         # A is running
        # B rides the same batch while A is mid-stream
        result_b = {}
        tb = threading.Thread(target=lambda: result_b.update(
            res=sse_generate(srv.port, {"prompt": prompt_b,
                                        "max_new_tokens": 16})))
        tb.start()
        deadline = time.monotonic() + 120
        while eng.scheduler.active_count < 2:     # B co-batched with A
            assert time.monotonic() < deadline, "B never admitted"
            time.sleep(0.001)
        # A's client goes away — RST (SO_LINGER 0) so the server's next
        # token write fails promptly instead of filling socket buffers.
        # The response object holds a makefile dup of the FD, so IT must
        # close too or the socket never actually closes.
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        r.close()
        conn.close()
        tb.join(timeout=60)
        status, _, tokens_b, done_b = result_b["res"]
        assert status == 200
        assert tokens_b == ref_b                  # B unperturbed
        # the dropped stream cancels: pages free, stream never completes
        deadline = time.monotonic() + 120
        while eng.kv.blocks_used > 0 or eng.scheduler.active_count > 0:
            assert time.monotonic() < deadline, (
                "disconnect did not free pages",
                eng.kv.blocks_used, eng.scheduler.active_count)
            time.sleep(0.005)
        assert eng.kv.blocks_used == 0            # back to baseline
        assert int(eng.metrics.completed) == 1    # only B completed
        assert srv.router.inflight == 0
        assert _registry_value(
            "server_client_disconnects_total", tenant="default",
            router=srv.router.metrics.label) == 1
    finally:
        srv.shutdown()


def test_deadline_cancels_inflight_work(trained):
    """Per-request deadlines (fake router clock): an expired in-flight
    request is cancelled through the engine path — the stream ends with
    finish_reason=deadline_exceeded, short of its budget, and the slot
    and its pages free."""
    t = [0.0]
    srv = make_server(trained, num_slots=2, decode_chunk=1, max_len=56,
                      server_kw=dict(clock=lambda: t[0]))
    eng = srv.router.replicas[0].engine
    try:
        conn, r = _post(srv.port,
                        {"prompt": [5, 5, 5], "max_new_tokens": 48,
                         "deadline_s": 50.0}, timeout=60)
        assert r.status == 200
        # let the stream start, then blow the deadline
        line = r.readline()
        assert line.startswith(b"data: ")
        t[0] = 100.0
        tokens, done, event = 1, None, "message"
        for line in iter(r.readline, b""):
            line = line.decode().rstrip("\n")
            if not line:
                event = "message"
                continue
            if line.startswith("event: "):
                event = line[7:]
                continue
            if line.startswith("data: "):
                if event == "done":
                    done = json.loads(line[6:])
                else:
                    tokens += 1
        conn.close()
        assert done is not None
        assert done["finish_reason"] == "deadline_exceeded"
        assert tokens < 48                       # cancelled mid-budget
        deadline = time.monotonic() + 120
        while eng.kv.blocks_used > 0 or eng.scheduler.active_count > 0:
            assert time.monotonic() < deadline
            time.sleep(0.005)
    finally:
        srv.shutdown()


def test_router_least_loaded_spread_and_structured_overload(trained):
    """Without drivers running, submits land in engine queues: two
    requests spread over two idle replicas (least-loaded off the live
    gauges); once both queues are full the router propagates the
    engine's structured EngineOverloadError."""
    engines = [make_engine(trained, num_slots=1, max_queue=1)
               for _ in range(2)]
    router = Router(engines)
    try:
        router.submit([1, 2], 2)
        router.submit([1, 2], 2)
        depths = sorted(int(e.metrics.queue_depth) for e in engines)
        assert depths == [1, 1]                   # one each, not 2+0
        with pytest.raises(EngineOverloadError) as ei:
            router.submit([1, 2], 2)
        assert ei.value.queue_depth == 1
        assert ei.value.running == 0
        # cold engines have no queue-wait samples: the shed still
        # carries the documented conservative default, never None
        assert (ei.value.retry_after_s
                == ptt.serving.DEFAULT_RETRY_AFTER_S)
    finally:
        router.close(drain=False)
    # close cancelled the queued handles and retired the engine series
    for e in engines:
        assert _registry_value("serving_submitted_total",
                               engine=e.metrics.engine_label) is None


def test_router_drain_rejects_then_close_is_idempotent(trained):
    router = Router([make_engine(trained)])
    router.start()
    h = router.submit([1, 2, 3], 4)
    assert router.drain(timeout=60) is True
    assert h.result(timeout=1)[1] == "length"
    with pytest.raises(DrainingError):
        router.submit([1, 2, 3], 4)
    router.close()
    router.close()                               # second close: no-op


def test_zero_token_streams_failover_to_healthy_replica(trained):
    """A replica that dies before any of its streams emitted a token
    hands them to a healthy replica TRANSPARENTLY: the retried stream
    is bit-identical (prompt/seed/deadline ride the handle), the
    failure is counted, and — with no engine factory — the dead
    replica parks FAILED and the router routes around it."""
    # both replicas idle + equal load -> the round-robin tie-break
    # deterministically sends the FIRST submit to replica 0
    faulty = make_engine(trained,
                         fault_plan=FaultPlan(step_exceptions={0}))
    healthy = make_engine(trained)
    router = Router([faulty, healthy])
    router.start()
    try:
        prompt = np.asarray([3, 1, 4], np.int32)
        ref = library_stream(trained, [3, 1, 4], 6)
        h = router.submit(prompt, 6)
        assert h.replica.engine is faulty      # tie-break is rr-deterministic
        tokens, reason = h.result(timeout=60)
        assert reason == "length"
        assert tokens == ref                   # retried bit-identically
        assert h.retries == 1 and h.emitted == 6
        assert router.metrics.replica_failures == 1
        assert _registry_value(
            "server_replica_failures_total",
            replica=faulty.metrics.engine_label) == 1
        states = sorted(r.state for r in router.replicas)
        assert states == ["failed", "ok"]      # parked, not rebuilt
        # new admissions route around the dead replica
        h2 = router.submit(prompt, 6)
        assert h2.replica.engine is healthy
        tokens, reason = h2.result(timeout=60)
        assert reason == "length" and tokens == ref
    finally:
        router.close(drain=False)


def test_failed_replica_rebuilds_via_factory_and_rejoins(trained):
    """With an engine factory the supervisor rebuilds a FAILED replica:
    fresh engine from the same params after backoff, state returns to
    OK, the restart is counted, and the dead engine's registry series
    are retired."""
    built = []

    def factory():
        eng = make_engine(trained)
        built.append(eng)
        return eng

    faulty = make_engine(trained,
                         fault_plan=FaultPlan(step_exceptions={0}))
    dead_label = faulty.metrics.engine_label
    router = Router([faulty], engine_factory=factory,
                    restart_backoff_s=0.01)
    router.start()
    try:
        prompt = np.asarray([3, 1, 4], np.int32)
        ref = library_stream(trained, [3, 1, 4], 6)
        h = router.submit(prompt, 6)
        # zero-token stream but no healthy replica to retry on: the
        # stream terminates rather than waiting out the rebuild
        _, reason = h.result(timeout=60)
        assert reason == "replica_failed"
        deadline = time.monotonic() + 30
        while (router.replicas[0].state != "ok"
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert router.replicas[0].state == "ok"
        assert len(built) == 1
        assert router.replicas[0].engine is built[0]
        assert router.metrics.replica_restarts == 1
        assert _registry_value("server_replica_restarts_total",
                               replica=dead_label) == 1
        # the dead engine's serving series were retired at rebuild
        assert _registry_value("serving_submitted_total",
                               engine=dead_label) is None
        tokens, reason = router.submit(prompt, 6).result(timeout=60)
        assert reason == "length" and tokens == ref
    finally:
        router.close(drain=False)


def test_healthz_reports_replica_supervision_state(trained):
    """/healthz carries the fault-tolerance surface: per-replica
    supervision state + swapped_slots/preemptions gauges and the
    fleet-level failure/restart counters; a replica death flips its
    state and the terminal SSE frame carries the retry hint."""
    srv = make_server(trained,
                      fault_plan=FaultPlan(step_exceptions={0}))
    try:
        _, body = _get_json(srv.port, "/healthz", expect=200)
        rep = body["replicas"][0]
        assert rep["state"] == "ok"
        assert rep["swapped_slots"] == 0 and rep["preemptions"] == 0
        assert body["replica_failures"] == 0
        assert body["replica_restarts"] == 0
        status, _, tokens, done = sse_generate(
            srv.port, {"prompt": [3, 1, 4], "max_new_tokens": 6})
        assert status == 200
        assert tokens == [] and done["finish_reason"] == "replica_failed"
        assert done["retry_after_s"] > 0
        _, body = _get_json(srv.port, "/healthz", expect=200)
        assert body["replicas"][0]["state"] in ("failed", "restarting")
        assert body["replica_failures"] == 1
    finally:
        srv.shutdown()


def test_drain_finishes_parked_swapped_sequences(trained):
    """The zero-dropped-tokens drain pin extended to preemption:
    drain begins while a preempted sequence sits in the host swap pool,
    and still every stream finishes with its full budget and the arena
    returns to zero pages used."""
    cfg, _ = trained
    # over-subscribed arena (the test_serving PRESSURE geometry) +
    # slow-step injection so the parked window is wide enough to
    # observe without racing the driver
    eng = make_engine(trained, num_slots=4, max_queue=16, block_size=4,
                      kv_blocks=12, decode_chunk=4, preempt=True,
                      fault_plan=FaultPlan(
                          slow_steps={i: 0.001 for i in range(2, 12)}))
    router = Router([eng])
    router.start()
    try:
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
                   for n in (5, 7, 4, 6)]
        handles = [router.submit(p, 12) for p in prompts]
        deadline = time.monotonic() + 30
        while eng.swapped_count == 0 and time.monotonic() < deadline:
            time.sleep(0.0005)
        assert eng.swapped_count >= 1          # parked as drain begins
        assert router.drain(timeout=120)
        for h in handles:
            tokens, reason = h.result(timeout=1)
            assert reason == "length"
            assert len(tokens) == 12           # zero dropped tokens
        assert eng.swapped_count == 0
        assert eng.kv.blocks_used == 0
        assert eng.stats()["preemptions"] >= 1
    finally:
        router.close(drain=False)


def _slowed(plan_steps=200, delay=0.002, **fault_kw):
    """A FaultPlan that stretches every engine step — wide, determinate
    windows for catching streams mid-generation without racing the
    driver."""
    return FaultPlan(slow_steps={i: delay for i in range(plan_steps)},
                     **fault_kw)


def _await_emitted(handle, n=2, timeout=30.0):
    deadline = time.monotonic() + timeout
    while handle.emitted < n:
        assert time.monotonic() < deadline, "stream never emitted"
        time.sleep(0.002)
    assert handle.finish_reason is None


def test_router_migrate_stream_token_identical(trained):
    """The tentpole pin at the router: a live SSE-backed stream
    migrated between replicas mid-generation keeps its handle (the
    client never reconnects) and stays bit-identical — greedy and
    seeded — while the registry counts the migration and both arenas
    drain clean."""
    e0 = make_engine(trained, decode_chunk=4, max_len=48,
                     fault_plan=_slowed())
    e1 = make_engine(trained, decode_chunk=4, max_len=48)
    router = Router([e0, e1])
    router.start()
    try:
        p = [3, 1, 4]
        ref = library_stream(trained, p, 24, temperature=0.8, seed=5)
        h = router.submit(np.asarray(p, np.int32), 24,
                          temperature=0.8, seed=5)
        assert h.replica.engine is e0          # rr tie-break: first -> 0
        _await_emitted(h)
        order = router.migrate(h, target=1)
        assert order.done.wait(30)
        assert order.outcome == "migrated", order.outcome
        tokens, reason = h.result(timeout=60)
        assert reason == "length" and tokens == ref
        assert h.replica is router.replicas[1]
        assert router.replicas[0].migrations_out == 1
        assert router.replicas[1].migrations_in == 1
        assert _registry_value("server_migrations_total",
                               router=router.metrics.label,
                               reason="rebalance") == 1
        snap = ptt.observability.get_registry().snapshot()
        hist = next(r for r in snap["serving_migration_seconds"]["series"]
                    if r["labels"].get("router") == router.metrics.label)
        assert hist["count"] == 1 and hist["sum"] > 0
        # /varz migration rollup rides the same snapshot
        from paddle_tpu_torch.observability.debug_server import _serving_varz
        roll = _serving_varz(snap)["migration"][router.metrics.label]
        assert roll["migrations"] == 1
        assert roll["migration_failures"] == 0
        assert roll["migration_ms"] > 0
    finally:
        router.close(drain=True)
    assert e0.kv.blocks_used == 0 and e1.kv.blocks_used == 0
    assert e0.swapped_count == 0 and e1.swapped_count == 0


@pytest.mark.parametrize("phase", ["extract", "transfer", "adopt"])
def test_migration_fault_each_phase_recovers_exactly_once(trained, phase):
    """Exactly-once under injected migration faults: a fault at any
    phase leaves the sequence either still on the source (extract),
    recovered onto the source (transfer/adopt re-adoption), or
    migrated on retry — never duplicated, never leaked — and the
    stream completes bit-identically. The failure is counted under its
    phase label."""
    src_faults = {phase: {0}} if phase in ("extract", "transfer") \
        else None
    tgt_faults = {"adopt": {0}} if phase == "adopt" else None
    e0 = make_engine(trained, decode_chunk=4, max_len=48,
                     fault_plan=_slowed(
                         migration_faults=src_faults))
    e1 = make_engine(trained, decode_chunk=4, max_len=48,
                     fault_plan=FaultPlan(migration_faults=tgt_faults)
                     if tgt_faults else None)
    router = Router([e0, e1])
    router.start()
    try:
        p = [3, 1, 4]
        ref = library_stream(trained, p, 24, temperature=0.8, seed=7)
        h = router.submit(np.asarray(p, np.int32), 24,
                          temperature=0.8, seed=7)
        _await_emitted(h)
        order = router.migrate(h, target=1)
        assert order.done.wait(30)
        tokens, reason = h.result(timeout=60)
        assert reason == "length" and tokens == ref
        assert _registry_value("server_migration_failures_total",
                               router=router.metrics.label,
                               phase=phase) == 1
        if phase == "extract":
            assert order.outcome == "failed:extract"
            assert h.replica is router.replicas[0]   # never left
        elif phase == "transfer":
            assert order.outcome == "readopted"
            assert h.replica is router.replicas[0]   # recovered home
        else:
            assert order.outcome == "readopted"
            plan = e1.faults
            assert plan.injected_migration_faults == 1
    finally:
        router.close(drain=True)
    for eng in (e0, e1):
        assert eng.kv.blocks_used == 0 and eng.swapped_count == 0


def test_restart_replica_zero_dropped_tokens(trained):
    """Zero-downtime rolling restart under concurrent load: one
    replica of two drains by MIGRATING its live streams to the peer,
    rebuilds via the engine factory, and rejoins — every stream
    delivers its full budget bit-identically (the client connections
    never closed), the dead engine's registry series are retired, and
    the restart is counted."""
    built = []

    def factory():
        eng = make_engine(trained, decode_chunk=4, max_len=48)
        built.append(eng)
        return eng

    e0 = make_engine(trained, decode_chunk=4, max_len=48,
                     fault_plan=_slowed())
    e1 = make_engine(trained, decode_chunk=4, max_len=48)
    dead_label = e0.metrics.engine_label
    router = Router([e0, e1], engine_factory=factory)
    router.start()
    try:
        p = [3, 1, 4]
        refs = {i: library_stream(trained, p, 28, seed=i)
                for i in range(4)}
        router.replicas[1].state = "draining"   # pin the load on 0
        handles = [router.submit(np.asarray(p, np.int32), 28, seed=i)
                   for i in range(4)]
        router.replicas[1].state = "ok"
        _await_emitted(handles[0])
        assert router.restart_replica(0, timeout=60)
        assert router.replicas[0].state == "ok"
        assert router.replicas[0].engine is built[0]
        assert router.replicas[0].restarts_total == 1
        assert router.replicas[0].migrations_out >= 1
        for i, h in enumerate(handles):
            tokens, reason = h.result(timeout=120)
            assert reason == "length", (i, reason)
            assert len(tokens) == 28            # zero dropped tokens
            assert tokens == refs[i]
        # the drained engine's serving series were retired at rebuild
        assert _registry_value("serving_submitted_total",
                               engine=dead_label) is None
        assert _registry_value("server_replica_restarts_total",
                               replica=dead_label) == 1
        migs = _registry_value("server_migrations_total",
                               router=router.metrics.label,
                               reason="restart")
        assert migs is not None and migs >= 1
        # the rebuilt replica serves fresh admissions
        tokens, reason = router.submit(
            np.asarray(p, np.int32), 6).result(timeout=60)
        assert reason == "length" and len(tokens) == 6
        # a second restart of a healthy replica also works (rolling)
        assert router.restart_replica(1, timeout=60)
        assert router.replicas[1].restarts_total == 1
    finally:
        router.close(drain=True)


def test_restart_replica_validation(trained):
    """restart_replica argument/state guards: bad index and non-ok
    replicas raise ValueError, restarting the LAST healthy replica is
    refused without force=True (no peer = every stream would fail over
    — a wipeout, not a rolling restart), and a draining router raises
    DrainingError."""
    e0 = make_engine(trained)
    router = Router([e0])
    router.start()
    try:
        with pytest.raises(ValueError, match="out of range"):
            router.restart_replica(3)
        router.replicas[0].state = "failed"
        with pytest.raises(ValueError, match="needs a healthy"):
            router.restart_replica(0)
        router.replicas[0].state = "ok"
        # the only healthy replica: guarded, force overrides (the
        # replica is idle, so the forced soft restart is instant)
        with pytest.raises(ValueError, match="only healthy"):
            router.restart_replica(0)
        assert router.restart_replica(0, timeout=60, force=True)
        assert router.replicas[0].restarts_total == 1
    finally:
        router.close(drain=True)
    with pytest.raises(DrainingError):
        router.restart_replica(0, force=True)


def test_alertz_statusz_service_plane(trained):
    """/alertz and /statusz on the deployable server: dormant (enabled
    false) without ServerConfig(health=), live with the built-in rule
    set when configured, the ring-endpoint ?limit= 400 contract, and
    shutdown retiring every health-plane series and the sampler
    thread."""
    from paddle_tpu_torch.observability import HealthConfig
    srv = make_server(trained)
    try:
        _, body = _get_json(srv.port, "/alertz", expect=200)
        assert body == {"enabled": False, "firing": [],
                        "transitions": []}
        _, body = _get_json(srv.port, "/statusz", expect=200)
        assert body["enabled"] is False and body["status"] == "ok"
        assert body["health_score"] == 100.0
        assert "pt-health-sampler" not in {
            t.name for t in threading.enumerate()}
    finally:
        srv.shutdown()

    srv = make_server(trained, n=2, server_kw=dict(
        health=HealthConfig(interval_s=3600.0)))
    try:
        assert any(t.name == "pt-health-sampler"
                   for t in threading.enumerate())
        status, _, tokens, _ = sse_generate(
            srv.port, {"prompt": [1, 2, 3], "max_new_tokens": 3})
        assert status == 200 and len(tokens) == 3
        _, body = _get_json(srv.port, "/alertz", expect=200)
        assert body["enabled"] is True
        rules = {r["rule"] for r in body["rules"]}
        assert {"slo_burn_rate_page", "slo_burn_rate_warn",
                "throughput_collapse", "queue_growth", "compile_storm",
                "prefix_hit_ratio_drop"} <= rules
        assert body["firing"] == []                 # healthy fleet
        assert body["health"]["status"] == "ok"
        _, body = _get_json(srv.port, "/statusz", expect=200)
        assert body["enabled"] is True and body["status"] == "ok"
        assert body["health_score"] == 100.0
        assert body["router"] == srv.router.metrics.label
        assert len(body["replicas"]) == 2
        assert all(r["state"] == "ok" for r in body["replicas"])
        # the ring-endpoint ?limit= contract (debug-server discipline)
        for ep in ("/alertz", "/statusz"):
            for bad in ("-1", "x", "1.5"):
                status, body = _get_json(srv.port,
                                         f"{ep}?limit={bad}")
                assert status == 400, (ep, bad)
                assert "limit" in body["error"], (ep, bad)
            for good in ("0", "5"):
                _get_json(srv.port, f"{ep}?limit={good}", expect=200)
        # the health gauges ride the shared registry while serving
        assert _registry_value("server_health_score",
                               source=srv.router.metrics.label) == 100.0
    finally:
        srv.shutdown()
    assert "pt-health-sampler" not in {
        t.name for t in threading.enumerate()}
    snap = ptt.observability.get_registry().snapshot()
    for name, fam in snap.items():
        if name.startswith(("server_alerts", "server_alert",
                            "server_health", "timeseries_")):
            assert fam["series"] == [], name


# ---------------------------------------------------------------------------
# the port's own entry points
# ---------------------------------------------------------------------------

def test_serve_two_preempting_replicas_streams_match_jax(trained):
    """`server.serve()` with two replicas whose arenas must preempt:
    concurrent HTTP streams, greedy and seeded over two tenants, each
    equal the JAX engine's library stream; /metrics carries the
    preemptions and both arenas drain clean."""
    cfg, params = trained
    srv = ptt.server.serve(params, cfg, ServerConfig(
        replicas=2, serving=ServingConfig(
            num_slots=4, max_queue=16, block_size=4, kv_blocks=12,
            decode_chunk=4, preempt=True, prefill_buckets=(4, 8),
            max_len=32)))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 97, (n,)).astype(np.int32).tolist()
               for n in (5, 7, 4, 6, 8, 3, 7, 5)]
    kws = [{"temperature": 0.0} if i % 2 == 0
           else {"temperature": 0.8, "seed": 40 + i}
           for i in range(len(prompts))]
    results = {}

    def run(i):
        results[i] = sse_generate(srv.port, dict(
            prompt=prompts[i], max_new_tokens=12,
            tenant="gold" if i % 2 else "free", **kws[i]), timeout=120)

    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i in range(len(prompts)):
            status, _, tokens, done = results[i]
            assert status == 200 and done["finish_reason"] == "length"
            assert tokens == library_stream(trained, prompts[i], 12,
                                            **kws[i]), i
        engines = [r.engine for r in srv.router.replicas]
        assert sum(e.stats()["preemptions"] for e in engines) >= 1
        assert sum(e.stats()["swap_ins"] for e in engines) \
            == sum(e.stats()["preemptions"] for e in engines)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=30)
        try:
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode()
        finally:
            conn.close()
        assert "serving_preemptions_total{" in text
        _, body = _get_json(srv.port, "/healthz", expect=200)
        assert [r["state"] for r in body["replicas"]] == ["ok", "ok"]
        for e in engines:
            assert e.kv.blocks_used == 0 and e.swapped_count == 0
    finally:
        srv.shutdown()


def test_create_engine_debug_port_serves_tickz_and_compilez(trained,
                                                           tmp_path):
    """`inference.create_engine(debug_port=0)` starts (or joins) the
    refcounted debug server: /healthz answers, /tickz and /compilez read
    the engine's providers, and close() releases the server."""
    from paddle_tpu_torch.observability import debug_server as dbg

    cfg, _ = trained
    main, startup, fetches = ptt.models.gpt.gpt_lm_program(
        cfg, 8, is_test=True)
    exe = ptt.Executor(ptt.CPUPlace())
    sc = ptt.Scope()
    exe.run(startup, scope=sc)
    ptt.io.save_inference_model(str(tmp_path), ["tokens"],
                                [fetches["logits"]], exe,
                                main_program=main, scope=sc)
    conf = ptt.inference.Config(str(tmp_path))
    conf.disable_gpu()
    eng = ptt.inference.create_engine(
        conf, cfg, ServingConfig(num_slots=2, prefill_buckets=(4, 8),
                                 max_len=32, tick_profile=True),
        debug_port=0)
    try:
        assert eng.debug_port and dbg.get_debug_server() is not None
        eng.generate([np.asarray([1, 2, 3], np.int32)], 4)
        label = eng.metrics.engine_label
        status, body = _get_json(eng.debug_port, "/healthz", expect=200)
        _, tickz = _get_json(eng.debug_port, "/tickz", expect=200)
        assert tickz["engines"][label]
        _, compilez = _get_json(eng.debug_port, "/compilez", expect=200)
        fams = compilez["engines"][label]["families"]
        assert set(fams) == set(eng.scheduler.compile_events)
    finally:
        eng.close()
    assert dbg.get_debug_server() is None


def test_adapter_bindings_route_to_the_pool(trained):
    """A tenant bound to adapter 3 decodes under it (the stream of an
    engine asked for adapter 3 directly); an explicit adapter_id,
    0 included, overrides the binding; an unbound tenant gets the base
    model; /v1/generate's adapter_id reaches the pool and /healthz's row
    carries kv_dtype, weight_bytes and adapters_resident; an explicit id
    on an adapterless engine is the engine's 400."""
    cfg, params = trained
    prompt = np.asarray([1, 2, 3], np.int32)

    def pool_engine(**kw):
        eng = _opened(ServingEngine(params, cfg, ServingConfig(
            num_slots=2, prefill_buckets=(4, 8), max_len=32,
            max_adapters=4, adapter_rank=2, **kw)))
        eng.upload_adapter(3, ptt.serving.make_adapter(cfg, 2, 3))
        return eng

    direct = pool_engine()
    want = {aid: direct.generate([prompt], 6, adapter_id=aid)[0]
            [prompt.size:].tolist() for aid in (0, 3)}
    direct.close()
    assert want[0] != want[3]
    router = Router([pool_engine()], adapters={"acme": AdapterConfig(3)},
                    default_adapter=AdapterConfig(0))
    router.start()
    try:
        for kw, aid in (({"tenant": "acme"}, 3),
                        ({"tenant": "acme", "adapter_id": 0}, 0),
                        ({"tenant": "other"}, 0),
                        ({"tenant": "other", "adapter_id": 3}, 3)):
            tokens, _ = router.submit(prompt, 6, **kw).result(timeout=60)
            assert tokens == want[aid], kw
    finally:
        router.close(drain=False)
    srv = GenerationServer([pool_engine(kv_dtype="int8")], ServerConfig())
    srv.serve()
    try:
        status, _, tokens, _ = sse_generate(
            srv.port, {"prompt": prompt.tolist(), "max_new_tokens": 6,
                       "adapter_id": 3})
        assert status == 200 and len(tokens) == 6
        _, body = _get_json(srv.port, "/healthz", expect=200)
        rep = body["replicas"][0]
        assert rep["adapters_resident"] == 1
        assert rep["kv_dtype"] == "int8"
        assert rep["weight_bytes"] == srv.router.replicas[0].engine \
            .weight_bytes
    finally:
        srv.shutdown()
    plain = Router([make_engine(trained)],
                   adapters={"base": AdapterConfig(0)})
    try:
        with pytest.raises(ValueError, match="no adapter pool"):
            plain.submit([1, 2, 3], 2, adapter_id=2)
    finally:
        plain.close(drain=False)


_SERVER_MODULES = ("server/__init__.py", "server/router.py",
                   "server/service.py", "serving/migration.py",
                   "observability/alerts.py",
                   "observability/debug_server.py",
                   "observability/timeseries.py",
                   "observability/train_stats.py",
                   "tools/bench_serving.py", "models/gpt_decode.py",
                   "serving/__init__.py", "serving/engine.py",
                   "serving/scheduler.py", "serving/adapters.py",
                   "serving/kv_cache.py", "inference/__init__.py")


def test_server_modules_import_neither_jax_nor_paddle_tpu():
    for rel in _SERVER_MODULES:
        path = os.path.join(ROOT, "paddle_tpu_torch", rel)
        for node in ast.walk(ast.parse(open(path).read())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib",
                                               "paddle_tpu"), \
                    f"{rel} imports {n}"


@pytest.mark.parametrize("flag,item", [("--mesh 2", "A.8")])
def test_bench_serving_unported_workloads_raise(flag, item):
    from paddle_tpu_torch.tools import bench_serving
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        bench_serving.main(["tiny", "--device", "cpu"] + flag.split())


def test_bench_serving_oversubscribe_and_http_rows():
    """The bench's preemption workload preempts and completes every
    request; its --http rows come from a live server over the wire."""
    from paddle_tpu_torch.tools import bench_serving
    row, = bench_serving.run_oversubscribe("tiny", requests=6,
                                           device="cpu")
    assert row["metric"] == "tiny_serving_oversub_c8"
    assert row["extra"]["completed"] == 6
    assert row["extra"]["preemptions"] >= 1
    assert row["extra"]["blocks_used_after_drain"] == 0
    rows = bench_serving.run_http("tiny", concurrencies=[2],
                                  requests_per_level=4, max_new=8,
                                  device="cpu")
    assert [r["metric"] for r in rows] == ["tiny_serving_http_c2"]
    assert rows[0]["extra"]["completed"] == 4
    assert rows[0]["extra"]["server_requests_ok"] == 4
