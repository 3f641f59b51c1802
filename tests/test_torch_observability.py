"""The port's observability modules the serving engine needs, on the
CPU: the completed metrics registry against the JAX package's on the
same series (histogram buckets, quantiles, snapshot and Prometheus
text), the serving metrics' request cuts and engine series, the request
event log over an engine run, the stall watchdog's flight records, and
profiler.RecordEvent. Every clock is a fake one: nothing sleeps and no
assertion rests on wall time."""

import json
import os

import numpy as np
import pytest

import paddle_tpu.observability.metrics as jmetrics
import paddle_tpu.serving.metrics as jserving_metrics
import paddle_tpu_torch as ptt
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models import gpt_decode as tgd
from paddle_tpu_torch.models.gpt import GPTConfig, gpt_lm_program
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.serving import metrics as tserving_metrics


def _fill(reg):
    """The same series, in the same order, into either package's
    registry."""
    c = reg.counter("req_total", "requests")
    c.labels(engine="0", code="200").inc(3)
    c.labels(engine="0", code="429").inc()
    c.labels(engine='we"ird\\n').inc(2)
    g = reg.gauge("queue_depth", "queue")
    g.labels(engine="0").set(7)
    g.set(-1.5)
    h = reg.histogram("ttft_seconds", "ttft")
    for v in (0.0004, 0.003, 0.003, 0.2, 7.0, 12.0):
        h.labels(engine="0").observe(v)
    k = reg.histogram("tokens_per_dispatch", "count", buckets=(1, 2, 4, 8))
    for v in (1, 3, 8, 9, 16):
        k.labels(_buckets=(1, 2, 4, 8, 16, 32), engine="1").observe(v)
    for v in (2, 2, 5):
        k.labels(engine="2").observe(v)
    return reg


def test_registry_matches_jax_on_the_same_series():
    t = _fill(obs.MetricsRegistry())
    j = _fill(jmetrics.MetricsRegistry())
    assert t.to_prometheus() == j.to_prometheus()
    assert t.to_prometheus(aggregate_label="engine") == \
        j.to_prometheus(aggregate_label="engine")
    assert t.snapshot() == j.snapshot()
    assert json.loads(t.to_json()) == json.loads(j.to_json())
    h = t.histogram("ttft_seconds")
    s = h.labels(engine="0")
    assert s.count == 6 and s.sum == pytest.approx(19.2064)
    assert s.quantile(0.5) == 0.003 and s.quantile(0.99) == 12.0
    text = t.to_prometheus()
    assert 'ttft_seconds_bucket{engine="0",le="0.005"} 3' in text
    assert 'ttft_seconds_bucket{engine="0",le="+Inf"} 6' in text
    with pytest.raises(ValueError):
        t.counter("queue_depth")              # registered as a gauge
    with pytest.raises(ValueError):
        t.histogram("tokens_per_dispatch", buckets=(1, 3))


def test_serving_metrics_match_jax_under_a_fake_clock():
    """RequestMetrics' cuts and EngineMetrics' series, fed the same
    fake-clock stamps in both packages."""
    def run(mod, reg_mod):
        now = [0.0]
        em = mod.EngineMetrics(registry=reg_mod.MetricsRegistry(),
                               engine_label="e",
                               max_tokens_per_dispatch=16)
        for start, gaps in ((0.0, (1.0, 0.5, 0.25, 0.25)),
                            (2.0, (0.5, 1.0)), (3.0, (4.0,))):
            now[0] = start
            rm = mod.RequestMetrics(clock=lambda: now[0])
            rm.mark_submitted()
            now[0] += 0.125
            rm.mark_admitted()
            for gap in gaps:
                now[0] += gap
                rm.mark_token()
            rm.mark_finished()
            em.record(rm)
            em.tokens_out += len(gaps)
            em.observe_dispatch_tokens(len(gaps))
        return em, rm

    tem, trm = run(tserving_metrics, obs.metrics)
    jem, jrm = run(jserving_metrics, jmetrics)
    assert tem.snapshot() == jem.snapshot()
    assert trm.to_dict() == jrm.to_dict()
    assert trm.tpot is None and trm.ttft == 4.125   # a one-token request
    snap = tem.snapshot()
    assert snap["completed"] == 3 and snap["tokens_out"] == 7
    assert snap["p50_ttft"] == 1.125 and snap["p99_ttft"] == 4.125
    assert tem.queue_wait_p50() == 0.125
    assert tem._registry.to_prometheus() == jem._registry.to_prometheus()


@pytest.fixture(scope="module")
def tiny_params():
    cfg = GPTConfig(vocab_size=97, hidden=32, layers=2, heads=4,
                    max_pos=64, dropout=0.0)
    main, startup, _ = gpt_lm_program(cfg, 8, is_test=True)
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    return cfg, tgd.collect_gpt_params(scope, cfg)


def _engine(tiny_params, clock, **kw):
    cfg, params = tiny_params
    return ServingEngine(params, cfg, ServingConfig(
        num_slots=2, max_queue=2, prefill_buckets=(4, 8), max_len=32,
        clock=clock, **kw))


def test_request_log_journals_an_engine_run(tiny_params, tmp_path):
    now = [100.0]

    def clock():
        now[0] += 0.5
        return now[0]

    eng = _engine(tiny_params, clock, decode_chunk=2)
    log = obs.install_request_log(obs.RequestLog(log_dir=str(tmp_path)))
    try:
        a = eng.submit(np.asarray([1, 2, 3], np.int32), 5)
        b = eng.submit(np.asarray([4, 5], np.int32), 3, temperature=0.7,
                       seed=3)
        with pytest.raises(ptt.serving.EngineOverloadError):
            eng.submit(np.asarray([6], np.int32), 2)
        eng.run_until_drained()
    finally:
        assert obs.uninstall_request_log() is log
    kinds = {}
    for rec in log.recent():
        kinds.setdefault(rec["request_id"], []).append(rec["kind"])
    for req, n in ((a, 5), (b, 3)):
        seq = kinds[req.request_id]
        assert seq[:5] == ["submitted", "queued", "admitted", "prefill",
                           "decode"]
        assert seq[-1] == "finished" and set(seq[4:-1]) == {"decode"}
        assert req.metrics.tokens_out == n
    shed = [k for rid, k in kinds.items()
            if rid not in (a.request_id, b.request_id)]
    assert shed == [["submitted", "shed"]]
    assert log.inflight_ids() == []
    lines = open(os.path.join(str(tmp_path), "serving.jsonl")).readlines()
    assert len(lines) == log.event_count
    fin = [r for r in map(json.loads, lines) if r["kind"] == "finished"]
    assert [f["finish_reason"] for f in fin] == ["length", "length"]
    # the engine's cuts come from the fake clock, a multiple of its tick
    for cut in (a.metrics.queue_wait, a.metrics.ttft, a.metrics.total):
        assert cut > 0 and (cut / 0.5).is_integer()
    eng.close()


def test_watchdog_stall_record_with_a_fake_clock(tiny_params, tmp_path):
    """Queued work and no step: the monitor's fake clock passes the
    threshold, one check() writes one flight record, a second check in
    the same episode writes none, progress re-arms it."""
    reg = obs.MetricsRegistry()
    eng = _engine(tiny_params, lambda: 0.0)
    eng.metrics.unregister()
    eng.metrics = tserving_metrics.EngineMetrics(registry=reg)
    obs.enable_tracing()
    try:
        with obs.trace_span("pre_stall_marker"):
            pass
    finally:
        obs.disable_tracing()
    eng.submit(np.asarray([1, 2, 3], np.int32), 4)
    eng.metrics.queue_depth = 1              # what step() would publish
    now = [0.0]
    wd = obs.Watchdog(stall_threshold=30.0, base_dir=str(tmp_path),
                      max_records=3, registry=reg)
    wd._monitor = obs.ProgressMonitor(reg, clock=lambda: now[0])
    assert wd.check() is None                # first sight: age 0
    now[0] = 29.0
    assert wd.check() is None
    now[0] = 31.0
    path = wd.check()
    assert path is not None and wd.recorder.records() == [path]
    assert sorted(os.listdir(path)) == ["meta.json", "metrics.json",
                                        "spans.json", "stacks.txt"]
    meta = json.load(open(os.path.join(path, "meta.json")))
    key = f"engine:{eng.metrics.engine_label}"
    assert meta["reason"] == "stall"
    assert meta["details"]["stalled"][key]["age_s"] == 31.0
    spans = json.load(open(os.path.join(path, "spans.json")))
    assert any(e.get("name") == "pre_stall_marker"
               for e in spans["traceEvents"])
    assert "serving_queue_depth" in json.load(
        open(os.path.join(path, "metrics.json")))
    now[0] = 100.0
    assert wd.check() is None                # same episode: no new record
    eng.run_until_drained()                  # progress
    now[0] = 101.0
    assert wd.check() is None
    assert len(wd.recorder.records()) == 1
    dumps = reg.counter("watchdog_dumps_total").labels(reason="stall")
    assert dumps.value == 1


def test_record_event_lands_in_the_tracer():
    tracer = obs.get_tracer()
    tracer.clear()
    obs.enable_tracing()
    try:
        with ptt.profiler.RecordEvent("serving/prefill", bucket=8):
            with obs.trace_span("inner"):
                pass
    finally:
        obs.disable_tracing()
    spans = {s.name: s for s in tracer.snapshot()}
    assert spans["serving/prefill"].args == {"bucket": 8}
    assert spans["inner"].depth == spans["serving/prefill"].depth + 1
    rows = obs.self_times(tracer.snapshot())
    assert rows["serving/prefill"]["count"] == 1
    tracer.clear()
