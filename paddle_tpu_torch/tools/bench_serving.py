"""Continuous-batching serving bench for the PyTorch port: one JSON row
per (model, concurrency, decode_chunk) with generate throughput and
TTFT/TPOT. Mirrors `tools/bench_serving.py` (the same workloads, row
names and registry-sourced columns) over `paddle_tpu_torch.serving` and
`paddle_tpu_torch.server`, on the card unless `--device cpu`:

    python3 -m paddle_tpu_torch.tools.bench_serving [tiny gpt2]
    BENCH_SERVING_REQUESTS=32 python3 -m paddle_tpu_torch.tools.bench_serving gpt2
    python3 -m paddle_tpu_torch.tools.bench_serving tiny --decode-chunk 1 8
    python3 -m paddle_tpu_torch.tools.bench_serving tiny --http
    python3 -m paddle_tpu_torch.tools.bench_serving tiny --oversubscribe
    python3 -m paddle_tpu_torch.tools.bench_serving tiny --shared-prefix
    python3 -m paddle_tpu_torch.tools.bench_serving tiny --speculate 0 4
    python3 -m paddle_tpu_torch.tools.bench_serving tiny --quantize
    python3 -m paddle_tpu_torch.tools.bench_serving tiny --adapters 3
    python3 -m paddle_tpu_torch.tools.bench_serving tiny --mixed
    python3 -m paddle_tpu_torch.tools.bench_serving tiny --rebalance
    python3 -m paddle_tpu_torch.tools.bench_serving tiny --device cpu

Each library row carries the dispatch amortization columns read back
from the observability registry (`dispatches`, `dispatches_per_token`,
`tokens_per_dispatch`), the paged-pool columns (`blocks_used`,
`prefix_hit_rate`, `tokens_per_s_per_gb`), the dispatch split
(`host_overhead_ms`, `device_ms_per_dispatch`), the tick-phase
attribution (`tick_phase_ms`) and the tracing overhead
(`trace_overhead_pct`). `--http` adds one `<model>_serving_http_c<cc>`
row per concurrency from a live `server.GenerationServer` driven by
threaded SSE clients (client-measured TTFT/TPOT next to the engine's).
`--oversubscribe` runs requests whose page demand exceeds the arena
with host-swap preemption on (`preemptions`, `swap_ins`, `swap_in_ms`,
`swap_out_ms`); `--shared-prefix` compares the prefix cache off and
on; `--speculate K...` runs a repetitive-text mix once a speculate_k
(`spec_accept_rate`, `accepted_per_pass`, `dispatches_per_token`).
`--quantize` serves one greedy mix at fp32, int8 weights and int8
weights + int8 KV (`weight_bytes`, `pool_bytes`, `tokens_per_s_per_gb`,
the teacher-forced `greedy_token_agreement` and `max_logit_delta` of
`quantized_logit_delta`, `stream_agreement`), each quantized mode's
streams asserted identical on a second fresh engine; `--adapters N`
serves the mix through 1 and then N co-batched LoRA adapters (the
registry's `adapters_resident` / `adapter_pool_bytes` /
`adapter_uploads` / `adapter_evictions`), streams asserted identical on
a second fresh engine and, for N, on a dedicated engine an adapter.
`--mixed` runs K short-decode streams co-batched with one long prompt on
fresh engines, `prefill_chunk` off then on: two rows with the short
streams' client-measured `p99_tpot_ms` (per-token gaps), `long_ttft_ms`
and the registry's `prefill_chunks`, streams asserted identical across
the rows. `--rebalance` admits the mix skewed onto one of two router
replicas, the rebalancer off then on: one row with the registry's
`migrations` / `migration_ms` and the hot replica's p99 TPOT and TTFT
both ways, streams asserted identical.
`--debug-port N` serves the live diagnostics plane meanwhile.

The workload of the engine knob the port lacks raises as the engine
does: `--mesh` (ROADMAP A.8).
"""

import argparse
import http.client
import json
import os
import sys
import threading
import time

import numpy as np

MODELS = {
    # name -> (GPTConfig kwargs, concurrencies, prompt lens, buckets)
    "tiny": (dict(vocab_size=97, hidden=32, layers=2, heads=4, max_pos=128,
                  dropout=0.0, attn_impl="xla"),
             [1, 2, 4, 8], (4, 7, 12, 15), (8, 16)),
    "gpt2": (dict(dropout=0.0),                        # GPT-2-small
             [1, 4, 8, 16], (32, 57, 100, 120), (64, 128)),
}

# the workloads whose engine knobs the port lacks, and their ROADMAP items
_NOT_PORTED = {"--mesh": "A.8"}


def build_params(gpt_kwargs, device="cuda"):
    """GPT parameters from the startup program, on `device` (random
    weights, as the JAX bench's)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import gpt_decode as gd
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_lm_program

    cfg = GPTConfig(**gpt_kwargs)
    with pt.unique_name_guard():
        _, startup, _ = gpt_lm_program(cfg, 8, is_test=True)
    place = pt.CPUPlace() if device == "cpu" else pt.CUDAPlace(0)
    scope = pt.Scope()
    pt.Executor(place).run(startup, scope=scope)
    return cfg, gd.collect_gpt_params(scope, cfg)


def run_model(name, concurrencies=None, requests_per_level=None,
              max_new=32, decode_chunks=(1, 8), device="cuda"):
    """Benchmark one model at each (concurrency, decode_chunk); returns
    the JSON rows."""
    import paddle_tpu_torch as pt

    gpt_kwargs, default_cc, prompt_lens, buckets = MODELS[name]
    concurrencies = concurrencies or default_cc
    requests_per_level = requests_per_level or int(
        os.environ.get("BENCH_SERVING_REQUESTS", "16"))
    cfg, params = build_params(gpt_kwargs, device)
    max_len = max(buckets) + max_new
    rows = []
    for cc in concurrencies:
        for chunk in decode_chunks:
            rng = np.random.RandomState(0)     # same mix per chunk level
            eng = pt.serving.ServingEngine(
                params, cfg,
                pt.serving.ServingConfig(num_slots=cc,
                                         max_queue=requests_per_level,
                                         prefill_buckets=buckets,
                                         max_len=max_len,
                                         decode_chunk=chunk,
                                         dispatch_timing=True,
                                         tick_profile=True))
            prompts = [rng.randint(0, cfg.vocab_size,
                                   (prompt_lens[i % len(prompt_lens)],)
                                   ).astype(np.int32)
                       for i in range(requests_per_level)]
            # fresh draws for the traced re-run: resubmitting the SAME
            # prompts would prefix-cache-hit and the "tracer overhead"
            # delta would really be measuring cache wins
            trace_prompts = [rng.randint(
                0, cfg.vocab_size,
                (prompt_lens[i % len(prompt_lens)],)).astype(np.int32)
                for i in range(requests_per_level)]
            # warm the executables (compiles are O(buckets): one request
            # AT each bucket length warms every prefill shape + the
            # fused decode chunk)
            eng.generate([np.ones((b,), np.int32) for b in buckets],
                         max_new_tokens=2)
            old = eng.metrics
            old.unregister()           # retire the warmup series' label
            # drop the warmup rows, keeping the engine's own series
            # layout (bucket scaling + the dispatch-split histograms)
            eng.metrics = pt.serving.EngineMetrics(
                max_tokens_per_dispatch=old.max_tokens_per_dispatch,
                speculate_k=old.speculate_k,
                dispatch_timing=old.dispatch_timing,
                tick_profile=old.tick_profile)
            # the allocator's cumulative cache counters feed the new
            # series on the next step: drop the warmup's contribution
            eng.kv.prefix_hits = eng.kv.prefix_misses = 0
            t0 = time.perf_counter()
            reqs = [eng.submit(p, max_new_tokens=max_new)
                    for p in prompts]
            eng.step()           # admissions land; sample the gauge
            label = eng.stats()["engine_label"]
            blocks_used = _registry_counter(label,
                                            "serving_kv_blocks_used")
            eng.run_until_drained()
            dt = time.perf_counter() - t0
            s = eng.stats()
            tokens = sum(len(r.tokens) for r in reqs)
            quantiles = _registry_quantiles(label)
            dispatches = _registry_counter(label,
                                           "serving_dispatches_total")
            hit_rate = _registry_hit_rate(label)
            # disabled-path overhead: same mix again with the tracer ON
            # (executables already warm in both passes, so the delta is
            # the span-recording cost, not compiles)
            from paddle_tpu_torch import observability as obs
            was_enabled = obs.tracing_enabled()
            obs.enable_tracing()
            t0 = time.perf_counter()
            treqs = [eng.submit(p, max_new_tokens=max_new)
                     for p in trace_prompts]
            eng.run_until_drained()
            dt_traced = time.perf_counter() - t0
            if not was_enabled:
                obs.disable_tracing()
            tokens_traced = sum(len(r.tokens) for r in treqs)
            rows.append({
                "metric": f"{name}_serving_c{cc}_k{chunk}",
                "value": round(tokens / dt, 2),
                "unit": "tokens/s",
                "vs_baseline": None,
                "extra": {
                    "requests": requests_per_level,
                    "completed": s["completed"],
                    "max_new": max_new,
                    "decode_chunk": chunk,
                    "dispatches": dispatches,
                    "dispatches_per_token": round(dispatches / tokens, 4)
                        if tokens else None,
                    "tokens_per_dispatch": round(tokens / dispatches, 2)
                        if dispatches else None,
                    "mean_ttft_ms": round(s["mean_ttft"] * 1e3, 2),
                    "mean_tpot_ms": round(s["mean_tpot"] * 1e3, 3),
                    "mean_queue_wait_ms": round(
                        s["mean_queue_wait"] * 1e3, 2),
                    "decode_steps": s["decode_steps"],
                    "compiled_executables": s["compiled_executables"],
                    "tokens_per_s_traced": round(
                        tokens_traced / dt_traced, 2),
                    "trace_overhead_pct": round(
                        (dt_traced - dt) / dt * 100.0, 2),
                    "blocks_used": blocks_used,
                    "blocks_total": s["blocks_total"],
                    "prefix_hit_rate": hit_rate,
                    "tokens_per_s_per_gb": round(
                        (tokens / dt) / (s["pool_bytes"] / 2 ** 30), 2),
                    # host/device dispatch split (registry-sourced, the
                    # serving_dispatch_*_seconds histograms): mean
                    # launch-side host ms per fused dispatch — the
                    # pinned baseline native-core work is judged
                    # against — and the blocking device wait next to it
                    "host_overhead_ms": _registry_hist_ms(
                        label, "serving_dispatch_host_seconds"),
                    "device_ms_per_dispatch": _registry_hist_ms(
                        label, "serving_dispatch_device_seconds"),
                    # tick-phase attribution (registry-sourced, the
                    # serving_tick_phase_seconds histogram per phase):
                    # mean host ms per tick spent in each engine phase,
                    # and the journal-derived FLOP-utilization proxy
                    "tick_phase_ms": _registry_tick_phase_ms(label),
                    "mfu_proxy": _registry_gauge_value(
                        label, "serving_mfu_proxy"),
                    **quantiles,
                },
            })
            eng.close()                # this engine is done: no dead
            # labels left behind for the next level's scrape
    return rows


def _registry_series(label, family, label_key="engine"):
    """The series row for `family` matching {label_key: label} in a
    registry snapshot (None when absent) — the same data a /metrics
    scrape reports."""
    from paddle_tpu_torch.observability import get_registry

    snap = get_registry().snapshot()
    return next((r for r in snap.get(family, {}).get("series", [])
                 if r["labels"].get(label_key) == label), None)


def _registry_counter(engine_label, family):
    """One labeled counter/gauge value from the registry snapshot."""
    series = _registry_series(engine_label, family)
    return int(series["value"]) if series else 0


def _registry_hit_rate(engine_label):
    """Prefix-cache hit rate from the registry counters (the same
    numbers /varz derives its ratio column from); None when the
    workload had no shareable blocks at all."""
    hits = _registry_counter(engine_label,
                             "serving_prefix_cache_hits_total")
    misses = _registry_counter(engine_label,
                               "serving_prefix_cache_misses_total")
    return round(hits / (hits + misses), 4) if hits + misses else None


# shared-prefix workload geometry per model: (prefill buckets, block
# size, system-prompt length, unique-tail length). The system prompt
# fills most of the LARGE bucket so a cold admission pays the big
# prefill while a prefix-cache hit prefills only the tail through the
# SMALL bucket — the TTFT gap the row measures.
SHARED_PREFIX = {
    "tiny": ((32, 128), 16, 96, 8),
    "gpt2": ((64, 256), 32, 224, 16),
}


def run_shared_prefix(name, requests=None, max_new=16, concurrency=None,
                      device="cuda"):
    """The prefix-sharing workload: `requests` generate calls over ONE
    long system prompt with short unique tails, run twice on fresh
    engines — prefix cache OFF (every admission re-prefills the system
    prompt: the cold baseline) then ON (admissions after the first map
    the cached prefix blocks and prefill only the tail). One JSON row
    with both TTFT cuts + the registry-sourced hit rate and block
    occupancy."""
    import paddle_tpu_torch as pt

    gpt_kwargs, default_cc, _, _ = MODELS[name]
    buckets, block_size, sys_len, tail_len = SHARED_PREFIX[name]
    cc = concurrency or max(default_cc)
    requests = requests or int(
        os.environ.get("BENCH_SERVING_REQUESTS", "16"))
    cfg, params = build_params(gpt_kwargs, device)
    max_len = max(buckets)          # table keeps sys+tail+max_new inside
    rng = np.random.RandomState(0)
    sys_prompt = rng.randint(0, cfg.vocab_size, (sys_len,))
    prompts = [np.concatenate(
        [sys_prompt, rng.randint(0, cfg.vocab_size, (tail_len,))]
        ).astype(np.int32) for _ in range(requests)]
    results = {}
    for enabled in (False, True):
        eng = pt.serving.ServingEngine(
            params, cfg,
            pt.serving.ServingConfig(num_slots=cc, max_queue=requests,
                                     prefill_buckets=buckets,
                                     max_len=max_len,
                                     block_size=block_size,
                                     prefix_cache=enabled))
        # warm every suffix-bucket executable + the decode chunk —
        # with RANDOM prompts, not constants: a repeated warmup prompt
        # would hit its own prefix cache, shrink into a smaller suffix
        # bucket, and leave the LARGE bucket to compile inside the
        # timed run
        wrng = np.random.RandomState(12345)
        eng.generate([wrng.randint(0, cfg.vocab_size, (max(1, b - 2),))
                      .astype(np.int32) for b in buckets],
                     max_new_tokens=2)      # b-2 still buckets to b
        eng.metrics.unregister()
        eng.metrics = pt.serving.EngineMetrics()
        eng.kv.prefix_hits = eng.kv.prefix_misses = 0  # warmup stats out
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        eng.step()
        label = eng.stats()["engine_label"]
        blocks_used = _registry_counter(label, "serving_kv_blocks_used")
        eng.run_until_drained()
        dt = time.perf_counter() - t0
        s = eng.stats()
        results[enabled] = {
            "dt": dt,
            "tokens": sum(len(r.tokens) for r in reqs),
            "mean_ttft": s["mean_ttft"],
            "blocks_used": blocks_used,
            "hit_rate": _registry_hit_rate(label),
            "pool_bytes": s["pool_bytes"],
        }
        eng.close()
    cold, warm = results[False], results[True]
    return [{
        "metric": f"{name}_serving_shared_prefix_c{cc}",
        "value": round(warm["tokens"] / warm["dt"], 2),
        "unit": "tokens/s",
        "vs_baseline": None,
        "extra": {
            "requests": requests,
            "sys_prompt_len": sys_len,
            "tail_len": tail_len,
            "block_size": block_size,
            "max_new": max_new,
            "prefix_hit_rate": warm["hit_rate"],
            "blocks_used": warm["blocks_used"],
            "blocks_used_cold": cold["blocks_used"],
            "mean_ttft_ms_warm": round(warm["mean_ttft"] * 1e3, 2),
            "mean_ttft_ms_cold": round(cold["mean_ttft"] * 1e3, 2),
            "ttft_speedup": round(
                cold["mean_ttft"] / warm["mean_ttft"], 3)
                if warm["mean_ttft"] else None,
            "tokens_per_s_cold": round(cold["tokens"] / cold["dt"], 2),
            "tokens_per_s_per_gb": round(
                (warm["tokens"] / warm["dt"])
                / (warm["pool_bytes"] / 2 ** 30), 2),
        },
    }]


# over-subscription workload geometry per model: (prefill buckets,
# block size, prompt length, max_new, arena fraction). The arena is
# deliberately sized to `frac` of the workload's worst-case page
# demand, so admissions outrun the pool and the engine must preempt —
# host-swap running sequences out and resume them — to keep flowing.
OVERSUBSCRIBE = {
    "tiny": ((8, 16), 4, 12, 36, 0.55),
    "gpt2": ((32, 64), 16, 48, 64, 0.55),
}


def run_oversubscribe(name, requests=None, concurrency=None,
                      device="cuda"):
    """The --oversubscribe workload: requests whose combined page
    demand exceeds the arena (sized to `frac` of worst case), run with
    host-swap preemption ON. One row with the registry-sourced
    fault-tolerance columns: `preemptions` / `swap_ins`
    (serving_*_total counters), `swap_in_ms` / `swap_out_ms` (mean
    restore/copy-out latency from the serving_swap_{in,out}_seconds
    histograms), peak/steady block occupancy, and tokens/s — the
    graceful-degradation cost is a printed number, not a claim. Token
    streams under preemption are bit-identical to an unpressured run
    (pinned in tests/test_torch_serving_preempt.py)."""
    import paddle_tpu_torch as pt

    gpt_kwargs, default_cc, _, _ = MODELS[name]
    buckets, block_size, prompt_len, max_new, frac = OVERSUBSCRIBE[name]
    cc = concurrency or max(default_cc)
    requests = requests or int(
        os.environ.get("BENCH_SERVING_REQUESTS", "16"))
    cfg, params = build_params(gpt_kwargs, device)
    max_len = prompt_len + max_new
    pages_per_req = -(-max_len // block_size)        # ceil
    # worst case: every slot resident at full budget; undersize it
    kv_blocks = max(pages_per_req + 1,
                    int(cc * pages_per_req * frac) + 1)
    eng = pt.serving.ServingEngine(
        params, cfg,
        pt.serving.ServingConfig(num_slots=cc, max_queue=requests,
                                 prefill_buckets=buckets,
                                 max_len=max_len,
                                 block_size=block_size,
                                 kv_blocks=kv_blocks,
                                 preempt=True))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (prompt_len,))
               .astype(np.int32) for _ in range(requests)]
    # warm every executable incl. the swap pair (one forced preemption
    # via a deliberately page-starved co-resident mix would be flaky to
    # arrange; the swap executables are tiny, so just accept their two
    # compiles inside the measured run on cold engines)
    wrng = np.random.RandomState(12345)
    eng.generate([wrng.randint(0, cfg.vocab_size, (max(1, b - 2),))
                  .astype(np.int32) for b in buckets],
                 max_new_tokens=2)
    old = eng.metrics
    old.unregister()
    eng.metrics = pt.serving.EngineMetrics(
        max_tokens_per_dispatch=old.max_tokens_per_dispatch,
        speculate_k=old.speculate_k)
    eng.kv.prefix_hits = eng.kv.prefix_misses = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_drained()
    dt = time.perf_counter() - t0
    s = eng.stats()
    label = s["engine_label"]
    tokens = sum(len(r.tokens) for r in reqs)
    preemptions = _registry_counter(label, "serving_preemptions_total")
    swap_ins = _registry_counter(label, "serving_swap_ins_total")
    row = {
        "metric": f"{name}_serving_oversub_c{cc}",
        "value": round(tokens / dt, 2),
        "unit": "tokens/s",
        "vs_baseline": None,
        "extra": {
            "requests": requests,
            "completed": s["completed"],
            "max_new": max_new,
            "kv_blocks": kv_blocks,
            "worst_case_blocks": cc * pages_per_req,
            "oversubscription": round(cc * pages_per_req
                                      / (kv_blocks - 1), 2),
            "preemptions": preemptions,
            "swap_ins": swap_ins,
            "swapped_now": s["swapped_slots"],
            "swap_in_ms": _registry_hist_ms(
                label, "serving_swap_in_seconds"),
            "swap_out_ms": _registry_hist_ms(
                label, "serving_swap_out_seconds"),
            "blocks_used_peak": s["peak_blocks_used"],
            "blocks_total": s["blocks_total"],
            "blocks_used_after_drain": s["blocks_used"],
            "mean_ttft_ms": round(s["mean_ttft"] * 1e3, 2)
                if s["mean_ttft"] is not None else None,
            "mean_tpot_ms": round(s["mean_tpot"] * 1e3, 3)
                if s["mean_tpot"] is not None else None,
            "compiled_executables": s["compiled_executables"],
        },
    }
    eng.close()
    return [row]


# rebalance workload geometry per model: (prefill buckets, prompt
# length, max_new, replicas, per-replica slots). The mix is admitted
# skewed onto replica 0 (its peers briefly held out of admission), so
# the run measures what the pressure-driven rebalancer buys: live
# migrations onto the idle peers vs the hot replica grinding alone.
REBALANCE = {
    "tiny": ((8, 16), 12, 48, 2, 2),
    "gpt2": ((32, 64), 48, 64, 2, 4),
}


def run_rebalance(name, requests=None, replicas=None, device="cuda"):
    """The --rebalance workload: a skewed admission burst onto one
    replica of N, run twice on fresh engines — rebalancer OFF (the
    baseline: the hot replica serves its whole backlog) then ON (the
    router live-migrates running sequences to the idle peers). One row
    with registry-sourced migration columns (`migrations`,
    `migration_ms`) and the HOT replica's p99 TPOT on vs off — the
    tail-latency number rebalancing exists to shrink. Token streams
    are bit-identical in both runs (each request re-derives the same
    seeded stream; migration identity is pinned in tests)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.server import RebalanceConfig, Router

    gpt_kwargs, _, _, _ = MODELS[name]
    buckets, prompt_len, max_new, n_replicas, slots = REBALANCE[name]
    replicas = replicas or n_replicas
    requests = requests or int(
        os.environ.get("BENCH_SERVING_REQUESTS", "16"))
    cfg, params = build_params(gpt_kwargs, device)
    max_len = prompt_len + max_new
    results = {}
    for enabled in (False, True):
        engines = []
        for _ in range(replicas):
            eng = pt.serving.ServingEngine(
                params, cfg,
                pt.serving.ServingConfig(num_slots=slots,
                                         max_queue=requests,
                                         prefill_buckets=buckets,
                                         max_len=max_len,
                                         decode_chunk=8))
            # warm every executable on the library path, then drop the
            # warmup's registry rows (the standard bench discipline)
            wrng = np.random.RandomState(12345)
            eng.generate([wrng.randint(0, cfg.vocab_size,
                                       (max(1, b - 2),)).astype(np.int32)
                          for b in buckets], max_new_tokens=2)
            # warm the migration executables too (swap_out / release /
            # swap_in compile lazily on first use, and a cold compile
            # would dominate the migration_ms column): one ticket per
            # engine, extracted and re-adopted locally
            wreq = eng.submit(wrng.randint(0, cfg.vocab_size, (4,))
                              .astype(np.int32), max_new)
            while not wreq.tokens:
                eng.step()
            eng.migrate_in(eng.migrate_out(wreq))
            eng.run_until_drained()
            old = eng.metrics
            old.unregister()
            eng.metrics = pt.serving.EngineMetrics(
                max_tokens_per_dispatch=old.max_tokens_per_dispatch,
                speculate_k=old.speculate_k)
            eng.kv.prefix_hits = eng.kv.prefix_misses = 0
            engines.append(eng)
        router = Router(
            engines,
            rebalance=RebalanceConfig(interval_s=0.002,
                                      pressure_gap=0.2, hysteresis=2,
                                      max_concurrent=2)
            if enabled else None)
        router.start()
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab_size, (prompt_len,))
                   .astype(np.int32) for _ in range(requests)]
        # skew: hold every peer out of admission for the burst, so the
        # whole mix lands on replica 0 and the imbalance is maximal
        for r in router.replicas[1:]:
            r.state = "draining"
        t0 = time.perf_counter()
        handles = [router.submit(p, max_new, seed=i)
                   for i, p in enumerate(prompts)]
        for r in router.replicas[1:]:
            r.state = "ok"
        streams = [h.result(timeout=600)[0] for h in handles]
        dt = time.perf_counter() - t0
        tokens = sum(len(s) for s in streams)
        hot_label = engines[0].metrics.engine_label
        hot = _registry_series(hot_label, "serving_tpot_seconds")
        hot_ttft = _registry_series(hot_label, "serving_ttft_seconds")
        results[enabled] = {
            "dt": dt, "tokens": tokens, "streams": streams,
            "p99_tpot_ms": round(hot["p99"] * 1e3, 3)
            if hot and hot.get("p99") is not None else None,
            "p99_ttft_ms": round(hot_ttft["p99"] * 1e3, 3)
            if hot_ttft and hot_ttft.get("p99") is not None else None,
            "migrations": _registry_router_counter(
                router.metrics.label, "server_migrations_total"),
            "migration_failures": _registry_router_counter(
                router.metrics.label, "server_migration_failures_total"),
            "migration_ms": _registry_hist_ms(
                router.metrics.label, "serving_migration_seconds",
                label_key="router"),
        }
        router.close()               # drains + refcounted engine close()
    off, on = results[False], results[True]
    assert off["streams"] == on["streams"], \
        "rebalanced streams diverged from the baseline run"
    return [{
        "metric": f"{name}_serving_rebalance_r{replicas}",
        "value": round(on["tokens"] / on["dt"], 2),
        "unit": "tokens/s",
        "vs_baseline": None,
        "extra": {
            "requests": requests,
            "replicas": replicas,
            "num_slots": slots,
            "max_new": max_new,
            # registry-sourced migration columns (rebalancer-on run)
            "migrations": on["migrations"],
            "migration_failures": on["migration_failures"],
            "migration_ms": on["migration_ms"],
            # the tail-latency comparison the workload exists for: the
            # HOT replica's p99 TTFT (queue relief — migrations free
            # slots for its backlog) and p99 TPOT with peers helping
            # vs grinding alone
            "p99_ttft_ms_on": on["p99_ttft_ms"],
            "p99_ttft_ms_off": off["p99_ttft_ms"],
            "p99_tpot_ms_on": on["p99_tpot_ms"],
            "p99_tpot_ms_off": off["p99_tpot_ms"],
            "tokens_per_s_off": round(off["tokens"] / off["dt"], 2),
            "migrations_off": off["migrations"],   # pinned 0: the
            # rebalancer-off run must not register a single migration
        },
    }]


# mixed long-prompt/short-decode workload geometry per model:
# (max_pos override, prefill buckets, short prompt len, short max_new,
# short stream count, long prompt len, long max_new, prefill_chunk,
# decode_chunk). The shorts decode steadily while ONE long prompt is
# admitted mid-flight: monolithic prefill stalls every co-batched
# stream for its whole dispatch (the TPOT p99 spike), chunked prefill
# splits it into budget-bounded dispatches interleaved with decode.
# decode_chunk is small (tight streaming cadence) so the stall shows
# up in per-token gaps, not hidden inside a fused block.
# note the bucket grid: the long prompt (448) pads to the 512 bucket
# on the monolithic path — the realistic power-of-two grid every
# engine default uses — while the chunked path's shapes come from the
# small chunk bucket exactly; escaping big-bucket padding is part of
# the real win chunking buys, so the rows keep it.
MIXED = {
    "tiny": (544, (8, 112, 512), 8, 64, 4, 448, 16, 112, 1),
    "gpt2": (1088, (32, 224, 1024), 32, 64, 4, 896, 16, 224, 1),
}


def run_mixed(name, requests=None, short_max_new=None, device="cuda"):
    """The --mixed workload (chunked prefill): K short-decode streams
    co-batched with one long prompt, run twice on fresh engines —
    prefill_chunk=None (the long prompt's monolithic prefill stalls
    every short stream: the p99 TPOT spike) then prefill_chunk=N (the
    prefill runs as budget-bounded chunks interleaved with decode).
    Two rows, off then on; each carries client-measured `p99_tpot_ms`
    (p99 over the SHORT streams' per-token inter-arrival gaps — the
    stall metric, not the per-request mean), `long_ttft_ms`, and the
    registry-sourced `prefill_chunks` counter. The ON row adds the
    improvement ratios against the off row. Token streams are asserted
    bit-identical across both rows before anything prints — chunking
    changes WHEN tokens arrive, never WHICH.

    With device="cpu" the gap numbers are host times of the CPU run,
    not the card's; what carries is the RATIO (one monolithic prefill's
    worth of stall vs one chunk's worth), a property of the dispatch
    structure."""
    import paddle_tpu_torch as pt

    gpt_kwargs, _, _, _ = MODELS[name]
    (max_pos, buckets, short_len, s_max_new, shorts, long_len,
     long_max_new, chunk, decode_chunk) = MIXED[name]
    shorts = requests or shorts
    s_max_new = short_max_new or s_max_new
    cfg, params = build_params(dict(gpt_kwargs, max_pos=max_pos), device)
    max_len = max(buckets) + long_max_new   # warmup fills every bucket
    rng = np.random.RandomState(0)
    short_prompts = [rng.randint(0, cfg.vocab_size, (short_len,))
                     .astype(np.int32) for _ in range(shorts)]
    long_prompt = rng.randint(0, cfg.vocab_size, (long_len,)) \
        .astype(np.int32)
    results = {}
    for prefill_chunk in (None, chunk):
        eng = pt.serving.ServingEngine(
            params, cfg,
            pt.serving.ServingConfig(num_slots=shorts + 1,
                                     max_queue=shorts + 1,
                                     prefill_buckets=buckets,
                                     max_len=max_len,
                                     decode_chunk=decode_chunk,
                                     prefill_chunk=prefill_chunk))
        # warm every executable THIS engine will use (the monolithic
        # engine compiles prefill:L{b} per bucket; the chunked engine
        # compiles prefill_chunk:L{bucket_for(<=chunk)} instead — the
        # long bucket never compiles there), then drop the warmup rows
        wrng = np.random.RandomState(12345)
        eng.generate([wrng.randint(0, cfg.vocab_size, (max(1, b - 2),))
                      .astype(np.int32) for b in buckets],
                     max_new_tokens=2)
        old = eng.metrics
        old.unregister()
        eng.metrics = pt.serving.EngineMetrics(
            max_tokens_per_dispatch=old.max_tokens_per_dispatch,
            speculate_k=old.speculate_k)
        eng.kv.prefix_hits = eng.kv.prefix_misses = 0
        stamps = {}

        def on_token(req, tok):
            stamps[req.request_id].append(time.perf_counter())

        t0 = time.perf_counter()
        sreqs = []
        for i, p in enumerate(short_prompts):
            r = eng.submit(p, max_new_tokens=s_max_new,
                           temperature=0.8 if i % 2 else 0.0, seed=i,
                           on_token=on_token)
            stamps[r.request_id] = []
            sreqs.append(r)
        # let every short stream reach steady decode before the long
        # prompt lands — the stall must hit mid-stream, not at admit
        while any(len(r.tokens) < 2 for r in sreqs):
            eng.step()
        lreq = eng.submit(long_prompt, max_new_tokens=long_max_new)
        eng.run_until_drained()
        dt = time.perf_counter() - t0
        s = eng.stats()
        label = s["engine_label"]
        gaps = sorted(b - a for r in sreqs
                      for a, b in zip(stamps[r.request_id],
                                      stamps[r.request_id][1:]))
        p99 = gaps[min(len(gaps) - 1, int(len(gaps) * 0.99))] \
            if gaps else None
        tokens = sum(len(r.tokens) for r in sreqs) + len(lreq.tokens)
        results[prefill_chunk] = {
            "dt": dt, "tokens": tokens,
            "streams": [tuple(r.tokens) for r in sreqs + [lreq]],
            "p99_tpot_ms": round(p99 * 1e3, 3) if p99 else None,
            "long_ttft_ms": round(lreq.metrics.ttft * 1e3, 2),
            "prefill_chunks": _registry_counter(
                label, "serving_prefill_chunks_total"),
            "prefill_chunk_ms": _registry_hist_ms(
                label, "serving_prefill_chunk_seconds"),
            "compiled_executables": s["compiled_executables"],
            "mean_tpot_ms": round(s["mean_tpot"] * 1e3, 3)
            if s["mean_tpot"] is not None else None,
        }
        eng.close()
    off, on = results[None], results[chunk]
    assert off["streams"] == on["streams"], \
        "chunked-prefill streams diverged from the monolithic run"
    rows = []
    for mode, r in (("off", off), ("on", on)):
        extra = {
            "short_streams": shorts,
            "short_len": short_len,
            "short_max_new": s_max_new,
            "long_len": long_len,
            "long_max_new": long_max_new,
            "decode_chunk": decode_chunk,
            "prefill_chunk": chunk if mode == "on" else None,
            "p99_tpot_ms": r["p99_tpot_ms"],
            "long_ttft_ms": r["long_ttft_ms"],
            "prefill_chunks": r["prefill_chunks"],
            "prefill_chunk_ms": r["prefill_chunk_ms"],
            "mean_tpot_ms": r["mean_tpot_ms"],
            "compiled_executables": r["compiled_executables"],
            "streams_identical": True,    # asserted above, both rows
        }
        if mode == "on":
            # the two acceptance numbers, printed not claimed: the
            # co-batched tail win and the bounded long-prompt cost
            extra["p99_tpot_improvement"] = round(
                off["p99_tpot_ms"] / on["p99_tpot_ms"], 3) \
                if off["p99_tpot_ms"] and on["p99_tpot_ms"] else None
            extra["long_ttft_ratio"] = round(
                on["long_ttft_ms"] / off["long_ttft_ms"], 3) \
                if off["long_ttft_ms"] else None
        rows.append({
            "metric": f"{name}_serving_mixed_chunk"
                      f"{0 if mode == 'off' else chunk}",
            "value": round(r["tokens"] / r["dt"], 2),
            "unit": "tokens/s",
            "vs_baseline": None,
            "extra": extra,
        })
    return rows


# speculative workload geometry per model: (prefill buckets, motif
# length, prompt length, max_new). Prompts tile a `motif_len`-token
# motif to `prompt_len`, so the trigram drafter seeds from the prompt
# and greedy continuations settle into drafter-predictable cycles.
SPECULATE = {
    "tiny": ((8, 16), 4, 16, 48),
    "gpt2": ((32, 64), 8, 64, 64),
}


def run_speculate(name, speculate_ks=(0, 4), requests=None,
                  concurrency=None, decode_chunk=8, device="cuda"):
    """The speculative-decoding sweep: the repetitive-text mix once a
    speculate_k value on a fresh engine, one row a K with
    registry-sourced acceptance columns (tokens committed a verify pass,
    draft accept rate) beside throughput. Streams are bit-identical at
    every K; only the pass count changes."""
    import paddle_tpu_torch as pt

    gpt_kwargs, default_cc, _, _ = MODELS[name]
    buckets, motif_len, prompt_len, max_new = SPECULATE[name]
    cc = concurrency or min(4, max(default_cc))
    requests = requests or int(
        os.environ.get("BENCH_SERVING_REQUESTS", "16"))
    cfg, params = build_params(gpt_kwargs, device)
    max_len = prompt_len + max_new
    rows = []
    for k in speculate_ks:
        rng = np.random.RandomState(0)       # same mix a K
        eng = pt.serving.ServingEngine(
            params, cfg,
            pt.serving.ServingConfig(num_slots=cc, max_queue=requests,
                                     prefill_buckets=buckets,
                                     max_len=max_len,
                                     decode_chunk=decode_chunk,
                                     speculate_k=k))
        prompts = [np.tile(rng.randint(0, cfg.vocab_size, (motif_len,)),
                           -(-prompt_len // motif_len))[:prompt_len]
                   .astype(np.int32) for _ in range(requests)]
        # warm every family (random prompts: the large bucket cannot
        # shrink into a prefix-cache hit), then drop the warm-up's
        # registry rows and counters
        _warm(eng, cfg, buckets)
        _fresh_metrics(pt, eng)
        eng.scheduler.spec_proposed = eng.scheduler.spec_accepted = 0
        eng.scheduler.spec_passes = 0
        eng.scheduler.drain_spec_samples()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        eng.run_until_drained()
        dt = time.perf_counter() - t0
        s = eng.stats()
        label = s["engine_label"]
        tokens = sum(len(r.tokens) for r in reqs)
        dispatches = _registry_counter(label, "serving_dispatches_total")
        proposed = _registry_counter(label, "serving_spec_proposed_total")
        accepted = _registry_counter(label, "serving_spec_accepted_total")
        # verify passes = proposed / k (each live pass proposes k), and
        # every pass commits its accepted run + one corrected token
        passes = proposed // k if k else None
        rows.append({
            "metric": f"{name}_serving_spec_c{cc}_s{k}",
            "value": round(tokens / dt, 2),
            "unit": "tokens/s",
            "vs_baseline": None,
            "extra": {
                "requests": requests,
                "completed": s["completed"],
                "max_new": max_new,
                "decode_chunk": decode_chunk,
                "speculate_k": k,
                "spec_proposed": proposed,
                "spec_accepted": accepted,
                "spec_accept_rate": round(accepted / proposed, 4)
                    if proposed else None,
                "accepted_per_pass": round(1 + accepted / passes, 3)
                    if passes else None,
                "dispatches": dispatches,
                "dispatches_per_token": round(dispatches / tokens, 4)
                    if tokens else None,
                "tokens_per_dispatch": round(tokens / dispatches, 2)
                    if dispatches else None,
                "mean_ttft_ms": round(s["mean_ttft"] * 1e3, 2),
                "mean_tpot_ms": round(s["mean_tpot"] * 1e3, 3),
                "compiled_executables": s["compiled_executables"],
            },
        })
        eng.close()
    return rows


# quantize workload geometry per model: (prefill buckets, prompt
# length, max_new, per-engine slots). Only the quantization mode varies
# across rows, so tokens_per_s_per_gb is comparable and the fp32 row is
# the accuracy reference.
QUANTIZE = {
    "tiny": ((8, 16), 12, 32, 4),
    "gpt2": ((32, 64), 48, 32, 4),
}

# the --quantize sweep's modes: row suffix -> (weight_dtype, kv_dtype)
QUANTIZE_MODES = (
    ("fp32", None, None),
    ("int8w", "int8", None),
    ("int8w_int8kv", "int8", "int8"),
)


def _quant_probe(cfg, pp, prompt, steps, kv_dtype, drive=None):
    """One single-sequence pass through the paged prefill + decode
    functions on a fresh arena of `kv_dtype` on the params' device:
    self-driven greedy when `drive` is None, teacher-forced with
    `drive`'s tokens otherwise. Returns (logits (steps, V) numpy, greedy
    tokens)."""
    import torch
    from paddle_tpu_torch.models import gpt_decode as gd

    prompt = np.asarray(prompt, np.int32).reshape(-1)
    dev = pp["wte"].device
    bs = 8
    P = -(-(prompt.size + steps) // bs)
    heads, hd = cfg.heads, cfg.hidden // cfg.heads
    shape = (cfg.layers, 2, P + 1, heads, bs, hd)
    arena = torch.zeros(shape, dtype=torch.float32, device=dev) \
        if kv_dtype is None else (
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
    pages = torch.arange(1, P + 1, device=dev)
    with torch.no_grad():
        logits, arena = gd.gpt_prefill_pages(
            pp, cfg, prompt[None], 0, prompt.size, arena, pages)
        out_logits = [logits[0].cpu().numpy()]
        toks = []
        tok = int(np.argmax(out_logits[-1]))
        for i in range(steps - 1):
            toks.append(tok)
            feed = drive[i] if drive is not None else tok
            logits, arena = gd.gpt_decode_step_pages(
                pp, cfg, [feed], arena, pages[None], [prompt.size + i])
            out_logits.append(logits[0].cpu().numpy())
            tok = int(np.argmax(out_logits[-1]))
    toks.append(tok)
    return np.stack(out_logits), toks


def quantized_logit_delta(cfg, params, qparams, prompt, steps,
                          kv_dtype=None, ref=None):
    """Per-token logit-delta probe: ONE sequence through the paged
    prefill + decode functions twice — fp32 params on an fp32 arena
    (greedy, self-driven) and `qparams` on a `kv_dtype` arena
    TEACHER-FORCED with the fp32 trajectory's tokens — returning (max
    |logit delta| over every decode position, greedy agreement fraction
    along that trajectory). Conditioned on the same context at every
    position, so it measures what quantization does to the functions,
    not error compounding through a diverged prefix. `ref` (the fp32
    probe's (logits, tokens)) may be computed once and shared across
    modes."""
    if ref is None:
        ref = _quant_probe(cfg, params, prompt, steps, None)
    ref_logits, ref_toks = ref
    q_logits, q_toks = _quant_probe(cfg, qparams, prompt, steps,
                                    kv_dtype, drive=ref_toks)
    delta = float(np.max(np.abs(ref_logits - q_logits)))
    agree = float(np.mean([a == b for a, b in zip(ref_toks, q_toks)]))
    return delta, agree


def _fresh_metrics(pt, eng, adapters=False):
    """Drop the warm-up's registry rows: a new EngineMetrics of the same
    layout, and the allocator's cache counters reset."""
    old = eng.metrics
    old.unregister()
    eng.metrics = pt.serving.EngineMetrics(
        max_tokens_per_dispatch=old.max_tokens_per_dispatch,
        speculate_k=old.speculate_k, adapters=adapters)
    if adapters:
        eng._sync_adapter_metrics()
    eng.kv.prefix_hits = eng.kv.prefix_misses = 0


def _warm(eng, cfg, buckets):
    """One request a prefill bucket (random prompts: no later request
    hits their blocks)."""
    wrng = np.random.RandomState(12345)
    eng.generate([wrng.randint(0, cfg.vocab_size, (max(1, b - 2),))
                  .astype(np.int32) for b in buckets], max_new_tokens=2)


def run_quantize(name, requests=None, max_new=None, decode_chunk=8,
                 device="cuda"):
    """The --quantize sweep: the same greedy mix on fresh engines at
    each quantization mode (fp32, int8 weights, int8 weights + int8 KV),
    buckets warmed, one row a mode with `weight_dtype`/`kv_dtype`,
    `weight_bytes`, `pool_bytes`, `tokens_per_s_per_gb` (tokens/s over
    the arena's bytes), `greedy_token_agreement` and `max_logit_delta`
    (quantized_logit_delta, teacher-forced along the fp32 greedy
    trajectory over four probe prompts) and `stream_agreement` (the
    free-running streams position by position against the fp32 row's:
    one near-tie flip early in a stream moves every later position, so
    this is informational). Before any row prints, each quantized mode
    runs again on a second fresh engine and its streams are asserted
    identical."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import gpt_decode as gd

    gpt_kwargs, _, _, _ = MODELS[name]
    buckets, prompt_len, row_max_new, slots = QUANTIZE[name]
    max_new = max_new or row_max_new
    requests = requests or int(
        os.environ.get("BENCH_SERVING_REQUESTS", "16"))
    cfg, params = build_params(gpt_kwargs, device)
    max_len = prompt_len + max_new
    probe_rng = np.random.RandomState(7)
    probe_prompts = [probe_rng.randint(0, cfg.vocab_size, (prompt_len,))
                     for _ in range(4)]
    probe_refs = None                    # fp32 trajectories, shared

    def run_mix(weight_dtype, kv_dtype):
        rng = np.random.RandomState(0)        # same mix a mode
        eng = pt.serving.ServingEngine(
            params, cfg,
            pt.serving.ServingConfig(
                num_slots=slots, max_queue=requests,
                prefill_buckets=buckets, max_len=max_len,
                decode_chunk=decode_chunk,
                weight_dtype=weight_dtype, kv_dtype=kv_dtype))
        prompts = [rng.randint(0, cfg.vocab_size, (prompt_len,))
                   .astype(np.int32) for _ in range(requests)]
        _warm(eng, cfg, buckets)
        _fresh_metrics(pt, eng)
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        eng.run_until_drained()
        dt = time.perf_counter() - t0
        s = eng.stats()
        dispatches = _registry_counter(s["engine_label"],
                                       "serving_dispatches_total")
        eng.close()
        return [tuple(r.tokens) for r in reqs], s, dt, dispatches

    rows, base_streams = [], None
    for suffix, weight_dtype, kv_dtype in QUANTIZE_MODES:
        streams, s, dt, dispatches = run_mix(weight_dtype, kv_dtype)
        if weight_dtype is None and kv_dtype is None:
            base_streams = streams
            agreement, delta, stream_agreement = 1.0, 0.0, 1.0
        else:
            # determinism, asserted before the row prints: a second
            # fresh engine at the same mode gives the same streams
            streams2, _, _, _ = run_mix(weight_dtype, kv_dtype)
            assert streams == streams2, (
                f"quantized mode {suffix} streams are not "
                "deterministic across fresh engines")
            pairs = [(a, b) for qs, rs in zip(streams, base_streams)
                     for a, b in zip(qs, rs)]
            stream_agreement = round(
                sum(a == b for a, b in pairs) / len(pairs), 4) \
                if pairs else None
            qparams = gd.quantize_params(params, cfg) \
                if weight_dtype == "int8" else params
            if probe_refs is None:
                probe_refs = [_quant_probe(cfg, params, pp, max_new,
                                           None)
                              for pp in probe_prompts]
            probes = [quantized_logit_delta(
                cfg, params, qparams, pp, max_new, kv_dtype=kv_dtype,
                ref=ref)
                for pp, ref in zip(probe_prompts, probe_refs)]
            delta = round(max(d for d, _ in probes), 5)
            agreement = round(
                sum(a for _, a in probes) / len(probes), 4)
        tokens = sum(len(st) for st in streams)
        rows.append({
            "metric": f"{name}_serving_quant_{suffix}",
            "value": round(tokens / dt, 2),
            "unit": "tokens/s",
            "vs_baseline": None,
            "extra": {
                "requests": requests,
                "completed": s["completed"],
                "max_new": max_new,
                "num_slots": slots,
                "decode_chunk": decode_chunk,
                "weight_dtype": s["weight_dtype"],
                "kv_dtype": s["kv_dtype"],
                "weight_bytes": s["weight_bytes"],
                "pool_bytes": s["pool_bytes"],
                # tokens/s a GB of KV arena resident (pool_bytes is
                # dtype-aware: int8 data + the scale plane)
                "tokens_per_s_per_gb": round(
                    (tokens / dt) / (s["pool_bytes"] / 2 ** 30), 2),
                "greedy_token_agreement": agreement,
                "max_logit_delta": delta,
                "stream_agreement": stream_agreement,
                "streams_deterministic": True,   # asserted above
                "dispatches": dispatches,
                "tokens_per_dispatch": round(tokens / dispatches, 2)
                    if dispatches else None,
                "mean_ttft_ms": round(s["mean_ttft"] * 1e3, 2)
                    if s["mean_ttft"] is not None else None,
                "mean_tpot_ms": round(s["mean_tpot"] * 1e3, 3)
                    if s["mean_tpot"] is not None else None,
                "compiled_executables": s["compiled_executables"],
            },
        })
    return rows


def run_adapters(name, n_adapters=None, requests=None, max_new=None,
                 decode_chunk=8, adapter_rank=4, device="cuda"):
    """The --adapters sweep: the same greedy mix on fresh engines
    serving ONE LoRA adapter, then N distinct adapters co-batched
    (requests round-robin over the ids), one row a pool population with
    the registry-sourced pool columns (the serving_adapter* families)
    beside tokens/s. Before any row prints: determinism (a second fresh
    engine at the same population gives the same streams) and, for N,
    isolation (each request's stream equals a dedicated fresh engine
    holding only its adapter) are asserted."""
    import paddle_tpu_torch as pt

    gpt_kwargs, _, _, _ = MODELS[name]
    buckets, prompt_len, row_max_new, slots = QUANTIZE[name]
    max_new = max_new or row_max_new
    n_adapters = n_adapters or 3
    requests = requests or int(
        os.environ.get("BENCH_SERVING_REQUESTS", "16"))
    cfg, params = build_params(gpt_kwargs, device)
    max_len = prompt_len + max_new
    # one prompt mix for every row and engine; what varies is the
    # adapter each request decodes through
    mix_rng = np.random.RandomState(0)
    prompts = [mix_rng.randint(0, cfg.vocab_size, (prompt_len,))
               .astype(np.int32) for _ in range(requests)]

    def engine(upload_ids, n_requests):
        eng = pt.serving.ServingEngine(
            params, cfg,
            pt.serving.ServingConfig(
                num_slots=slots, max_queue=n_requests,
                prefill_buckets=buckets, max_len=max_len,
                decode_chunk=decode_chunk,
                max_adapters=n_adapters + 1,
                adapter_rank=adapter_rank))
        for aid in upload_ids:
            eng.upload_adapter(
                aid, pt.serving.make_adapter(cfg, adapter_rank, seed=aid))
        return eng

    def run_mix(adapter_ids, upload_ids):
        eng = engine(upload_ids, requests)
        _warm(eng, cfg, buckets)
        _fresh_metrics(pt, eng, adapters=True)
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=max_new, adapter_id=aid)
                for p, aid in zip(prompts, adapter_ids)]
        eng.run_until_drained()
        dt = time.perf_counter() - t0
        s = eng.stats()
        label = s["engine_label"]
        reg = {col: _registry_counter(label, family) for col, family in
               (("dispatches", "serving_dispatches_total"),
                ("adapters_resident", "serving_adapters_resident"),
                ("adapter_pool_bytes", "serving_adapter_pool_bytes"),
                ("adapter_uploads", "serving_adapter_uploads_total"),
                ("adapter_evictions",
                 "serving_adapter_evictions_total"))}
        eng.close()
        return [tuple(r.tokens) for r in reqs], s, dt, reg

    all_ids = list(range(1, n_adapters + 1))
    rows = []
    for n_pop in sorted({1, n_adapters}):
        ids = all_ids[:n_pop]
        adapter_ids = [ids[i % len(ids)] for i in range(requests)]
        streams, s, dt, reg = run_mix(adapter_ids, ids)
        streams2, _, _, _ = run_mix(adapter_ids, ids)
        assert streams == streams2, (
            f"{n_pop}-adapter streams are not deterministic across "
            "fresh engines")
        if n_pop > 1:
            # isolation: each co-batched request against a dedicated
            # engine holding only its adapter
            for aid in ids:
                picks = [i for i, a in enumerate(adapter_ids) if a == aid]
                solo = engine([aid], len(picks))
                reqs = [solo.submit(prompts[i], max_new_tokens=max_new,
                                    adapter_id=aid) for i in picks]
                solo.run_until_drained()
                solo.close()
                assert [tuple(r.tokens) for r in reqs] \
                    == [streams[i] for i in picks], (
                    f"adapter {aid}: co-batched streams differ from a "
                    "dedicated single-adapter engine")
        tokens = sum(len(st) for st in streams)
        rows.append({
            "metric": f"{name}_serving_adapters_{n_pop}",
            "value": round(tokens / dt, 2),
            "unit": "tokens/s",
            "vs_baseline": None,
            "extra": {
                "requests": requests,
                "completed": s["completed"],
                "max_new": max_new,
                "num_slots": slots,
                "decode_chunk": decode_chunk,
                "n_adapters": n_pop,
                "adapter_rank": adapter_rank,
                "adapters_resident": reg["adapters_resident"],
                "adapter_pool_bytes": reg["adapter_pool_bytes"],
                "adapter_uploads": reg["adapter_uploads"],
                "adapter_evictions": reg["adapter_evictions"],
                "streams_deterministic": True,    # asserted above
                "streams_isolated": n_pop > 1,    # asserted above
                "dispatches": reg["dispatches"],
                "tokens_per_dispatch": round(
                    tokens / reg["dispatches"], 2)
                    if reg["dispatches"] else None,
                "mean_ttft_ms": round(s["mean_ttft"] * 1e3, 2)
                    if s["mean_ttft"] is not None else None,
                "mean_tpot_ms": round(s["mean_tpot"] * 1e3, 3)
                    if s["mean_tpot"] is not None else None,
                "compiled_executables": s["compiled_executables"],
            },
        })
    return rows


def _registry_hist_ms(label, family, label_key="engine"):
    """Mean of a latency histogram in ms (sum/count of the registry
    snapshot series matching {label_key: label}) — the swap_in_ms /
    swap_out_ms / migration_ms columns."""
    series = _registry_series(label, family, label_key)
    if not series or not series.get("count"):
        return None
    return round(series["sum"] / series["count"] * 1e3, 3)


def _registry_tick_phase_ms(engine_label):
    """{phase: mean ms per tick} from the serving_tick_phase_seconds
    histogram — the per-phase engine-host attribution a
    tick_profile=True scrape carries. None when the engine ran with
    the profiler off (no series registered at all)."""
    from paddle_tpu_torch.observability import get_registry

    snap = get_registry().snapshot()
    out = {}
    fam = snap.get("serving_tick_phase_seconds", {})
    for row in fam.get("series", []):
        if row["labels"].get("engine") != engine_label:
            continue
        if row.get("count"):
            out[row["labels"]["phase"]] = round(
                row["sum"] / row["count"] * 1e3, 4)
    return out or None


def _registry_gauge_value(engine_label, family):
    """One labeled gauge as a float (None when the series is absent —
    e.g. the profiler was off and the family never registered)."""
    series = _registry_series(engine_label, family)
    return round(float(series["value"]), 10) if series else None


def _sse_generate(port, payload, timeout=120):
    """POST /v1/generate and consume the SSE stream, stamping
    perf_counter at every frame. Returns (status, tokens, stamps,
    done_payload) — stamps[0] is the first-token arrival, the
    end-to-end TTFT numerator."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/generate", json.dumps(payload),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        if r.status != 200:
            return r.status, [], [], json.loads(r.read() or b"{}")
        tokens, stamps, done, event = [], [], None, "message"
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
                    stamps.append(time.perf_counter())
        return 200, tokens, stamps, done
    finally:
        conn.close()


def run_http(name, concurrencies=None, requests_per_level=None,
             max_new=32, decode_chunk=8, device="cuda"):
    """--http mode: the library request mix driven over the wire against
    a live GenerationServer (one engine per level, cc client threads).
    Rows mirror run_model's registry-sourced engine columns and ADD the
    client-measured end-to-end cuts, so wire overhead is the printed
    delta between `<model>_serving_c<cc>_k<chunk>` and
    `<model>_serving_http_c<cc>` rows."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.server import GenerationServer, ServerConfig

    gpt_kwargs, default_cc, prompt_lens, buckets = MODELS[name]
    concurrencies = concurrencies or default_cc
    requests_per_level = requests_per_level or int(
        os.environ.get("BENCH_SERVING_REQUESTS", "16"))
    cfg, params = build_params(gpt_kwargs, device)
    max_len = max(buckets) + max_new
    rows = []
    for cc in concurrencies:
        rng = np.random.RandomState(0)         # same mix as run_model
        eng = pt.serving.ServingEngine(
            params, cfg,
            pt.serving.ServingConfig(num_slots=cc,
                                     max_queue=max(requests_per_level,
                                                   16),
                                     prefill_buckets=buckets,
                                     max_len=max_len,
                                     decode_chunk=decode_chunk,
                                     dispatch_timing=True,
                                     tick_profile=True))
        prompts = [rng.randint(0, cfg.vocab_size,
                               (prompt_lens[i % len(prompt_lens)],)
                               ).astype(np.int32)
                   for i in range(requests_per_level)]
        # warm every executable on the library path BEFORE the server
        # owns the engine, then drop the warmup's registry rows
        eng.generate([np.ones((b,), np.int32) for b in buckets],
                     max_new_tokens=2)
        old = eng.metrics
        old.unregister()
        eng.metrics = pt.serving.EngineMetrics(
            max_tokens_per_dispatch=old.max_tokens_per_dispatch,
            speculate_k=old.speculate_k,
            dispatch_timing=old.dispatch_timing,
            tick_profile=old.tick_profile)
        eng.kv.prefix_hits = eng.kv.prefix_misses = 0
        # generous default SLOs: the slo_attainment / goodput columns
        # are registry-sourced numbers a healthy run meets, so misses
        # on the row mean the service really degraded
        from paddle_tpu_torch.server import SLOConfig
        server = GenerationServer([eng], ServerConfig(
            default_slo=SLOConfig(ttft_s=30.0, tpot_s=1.0,
                                  e2e_s=120.0)))
        port = server.serve()
        work = list(enumerate(prompts))
        results, lock = [], threading.Lock()

        def worker():
            while True:
                with lock:
                    if not work:
                        return
                    i, p = work.pop()
                t_sent = time.perf_counter()
                status, tokens, stamps, done = _sse_generate(
                    port, {"prompt": [int(x) for x in p],
                           "max_new_tokens": max_new, "seed": i})
                with lock:
                    results.append((status, t_sent, tokens, stamps))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker) for _ in range(cc)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        dt = time.perf_counter() - t0
        label = eng.stats()["engine_label"]
        s = eng.stats()
        ok = [row for row in results if row[0] == 200]
        tokens = sum(len(r[2]) for r in ok)
        ttfts = sorted(r[3][0] - r[1] for r in ok if r[3])
        tpots = [(r[3][-1] - r[3][0]) / (len(r[3]) - 1)
                 for r in ok if len(r[3]) > 1]
        quantiles = _registry_quantiles(label)
        dispatches = _registry_counter(label, "serving_dispatches_total")
        rows.append({
            "metric": f"{name}_serving_http_c{cc}",
            "value": round(tokens / dt, 2) if dt else None,
            "unit": "tokens/s",
            "vs_baseline": None,
            "extra": {
                "transport": "http",
                "requests": requests_per_level,
                "completed": len(ok),
                "max_new": max_new,
                "decode_chunk": decode_chunk,
                # client-measured end-to-end cuts (incl. wire overhead)
                "e2e_mean_ttft_ms": round(
                    sum(ttfts) / len(ttfts) * 1e3, 2) if ttfts else None,
                "e2e_p50_ttft_ms": round(
                    ttfts[len(ttfts) // 2] * 1e3, 2) if ttfts else None,
                "e2e_mean_tpot_ms": round(
                    sum(tpots) / len(tpots) * 1e3, 3) if tpots else None,
                # the same registry-sourced engine-side columns the
                # library rows carry (scrape-path truth, not internals)
                "mean_ttft_ms": round(s["mean_ttft"] * 1e3, 2)
                    if s["mean_ttft"] is not None else None,
                "mean_tpot_ms": round(s["mean_tpot"] * 1e3, 3)
                    if s["mean_tpot"] is not None else None,
                "dispatches": dispatches,
                "dispatches_per_token": round(dispatches / tokens, 4)
                    if tokens else None,
                "blocks_used_peak": s["peak_blocks_used"],
                "blocks_total": s["blocks_total"],
                "compiled_executables": s["compiled_executables"],
                "server_requests_ok": _server_requests(
                    server.router.metrics.label, "200"),
                # SLO/goodput plane (registry-sourced, the router-
                # scored server_slo_* / server_goodput_* series) +
                # the host/device dispatch split
                "host_overhead_ms": _registry_hist_ms(
                    label, "serving_dispatch_host_seconds"),
                "tick_phase_ms": _registry_tick_phase_ms(label),
                "mfu_proxy": _registry_gauge_value(
                    label, "serving_mfu_proxy"),
                "slo_attainment": _registry_slo_attainment(
                    server.router.metrics.label),
                "goodput_tokens_per_s": round(
                    _registry_router_counter(
                        server.router.metrics.label,
                        "server_goodput_tokens_total") / dt, 2)
                    if dt else None,
                **quantiles,
            },
        })
        server.shutdown()      # drain + refcounted engine close()
    return rows


def _registry_router_counter(router_label, family):
    """One router-labeled counter family summed over its tenant (and
    objective) splits — the scrape-path read behind the SLO columns."""
    from paddle_tpu_torch.observability import get_registry

    snap = get_registry().snapshot()
    return sum(int(row["value"])
               for row in snap.get(family, {}).get("series", [])
               if row["labels"].get("router") == router_label)


def _registry_slo_attainment(router_label):
    """met / (met + missed) across every tenant and objective this
    router scored; None before any stream closed under an SLO."""
    met = _registry_router_counter(router_label, "server_slo_met_total")
    missed = _registry_router_counter(router_label,
                                      "server_slo_missed_total")
    return round(met / (met + missed), 4) if met + missed else None


def _server_requests(router_label, code):
    """server_requests_total summed over tenants for one router+code —
    the wire-level acceptance count a scrape sees."""
    from paddle_tpu_torch.observability import get_registry

    snap = get_registry().snapshot()
    total = 0
    for row in snap.get("server_requests_total", {}).get("series", []):
        if row["labels"].get("router") == router_label \
                and row["labels"].get("code") == code:
            total += int(row["value"])
    return total


def _registry_quantiles(engine_label):
    """p50/p99 TTFT/TPOT in ms, read back from the observability registry
    snapshot (NOT from engine internals) — proves the scrape path carries
    the same numbers an operator would see."""
    from paddle_tpu_torch.observability import get_registry

    snap = get_registry().snapshot()
    out = {}
    for key, fam in (("ttft", "serving_ttft_seconds"),
                     ("tpot", "serving_tpot_seconds")):
        series = next((r for r in snap.get(fam, {}).get("series", [])
                       if r["labels"].get("engine") == engine_label), None)
        for q in ("p50", "p99"):
            v = series[q] if series else None
            out[f"{q}_{key}_ms"] = round(v * 1e3, 3) if v is not None \
                else None
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("models", nargs="*",
                    help=f"models to bench (default: all of "
                         f"{', '.join(MODELS)})")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engines serve (default: the card)")
    ap.add_argument("--debug-port", type=int, default=None, metavar="PORT",
                    help="serve the live diagnostics plane on PORT for "
                         "the duration of the bench (0 = ephemeral)")
    ap.add_argument("--decode-chunk", type=int, nargs="+", default=[1, 8],
                    metavar="K",
                    help="fused decode iterations per dispatch to sweep "
                         "(default: 1 8; token streams are identical at "
                         "every K)")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="run the prefix-sharing workload instead: "
                         "prefix cache off (cold) vs on")
    ap.add_argument("--oversubscribe", action="store_true",
                    help="run the over-subscription workload instead: "
                         "more KV pages demanded than the arena holds, "
                         "host-swap preemption on")
    ap.add_argument("--http", action="store_true",
                    help="also drive a live paddle_tpu_torch.server over "
                         "the wire: one <model>_serving_http_c<cc> row "
                         "per concurrency")
    ap.add_argument("--speculate", type=int, nargs="+", default=None,
                    metavar="K",
                    help="run the speculative-decoding workload instead: "
                         "the repetitive-text mix swept over these "
                         "speculate_k values (e.g. 0 4), one row a K with "
                         "registry-sourced accepted_per_pass / "
                         "spec_accept_rate columns; streams are "
                         "bit-identical at every K")
    ap.add_argument("--quantize", action="store_true",
                    help="run the quantized-serving sweep instead: the "
                         "same greedy mix on fresh engines at fp32, "
                         "int8 weights, and int8 weights + int8 KV — "
                         "one row a mode with weight/KV bytes, "
                         "tokens_per_s_per_gb, greedy_token_agreement "
                         "and max_logit_delta; every quantized row's "
                         "streams asserted deterministic first")
    ap.add_argument("--adapters", type=int, default=None, metavar="N",
                    help="run the multi-tenant adapter sweep instead: "
                         "the same greedy mix with 1 vs N LoRA adapters "
                         "resident, one row a population with the "
                         "registry's pool columns; streams asserted "
                         "deterministic and isolated first")
    ap.add_argument("--mixed", action="store_true",
                    help="run the chunked-prefill workload instead: K "
                         "short-decode streams co-batched with one "
                         "long prompt, prefill_chunk off vs on on "
                         "fresh engines — two rows with p99_tpot_ms "
                         "(per-token gap p99 of the short streams), "
                         "long_ttft_ms and registry-sourced "
                         "prefill_chunks; streams asserted "
                         "bit-identical across rows")
    ap.add_argument("--rebalance", action="store_true",
                    help="run the cross-replica migration workload "
                         "instead: a skewed admission burst onto one "
                         "replica of N, rebalancer off vs on — one row "
                         "with registry-sourced migrations / "
                         "migration_ms and the hot replica's p99 TPOT "
                         "both ways (streams bit-identical on and off)")
    ap.add_argument("--mesh", type=int, nargs="+", default=None,
                    help="not ported (ROADMAP A.8)")
    ap.add_argument("--json", metavar="OUT", default=None,
                    help="also write every result row as JSONL to OUT")
    args = ap.parse_args(argv)
    unknown = [m for m in args.models if m not in MODELS]
    if unknown:
        ap.error(f"unknown model(s) {unknown}; choose from {list(MODELS)}")
    bad = [k for k in args.decode_chunk if k < 1]
    if bad:
        ap.error(f"--decode-chunk values must be >= 1, got {bad}")
    if args.speculate is not None:
        bad = [k for k in args.speculate if k < 0]
        if bad:
            ap.error(f"--speculate values must be >= 0, got {bad}")
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag[2:]) not in (None, False):
            raise NotImplementedError(
                f"bench_serving {flag} is not ported to paddle_tpu_torch "
                f"yet (ROADMAP {item})")
    if args.adapters is not None and args.adapters < 1:
        ap.error(f"--adapters must be >= 1, got {args.adapters}")
    replacing = [f for f, on in (("--shared-prefix", args.shared_prefix),
                                 ("--oversubscribe", args.oversubscribe),
                                 ("--speculate",
                                  args.speculate is not None),
                                 ("--mixed", args.mixed),
                                 ("--rebalance", args.rebalance),
                                 ("--quantize", args.quantize),
                                 ("--adapters", args.adapters is not None))
                 if on]
    if len(replacing) > 1:
        ap.error(f"{replacing[0]} replaces the standard workload; "
                 f"drop {' '.join(replacing[1:])}")
    if args.http and replacing:
        ap.error(f"{replacing[0]} replaces the standard workload and "
                 "has no wire-path pairing; drop --http")

    server_started = False
    if args.debug_port is not None:
        from paddle_tpu_torch.observability import (start_debug_server,
                                                    stop_debug_server)
        port = start_debug_server(port=args.debug_port)
        server_started = True
        print(f"debug server: http://127.0.0.1:{port}", file=sys.stderr)
    all_rows = []
    try:
        for name in args.models or list(MODELS):
            if args.shared_prefix:
                rows = run_shared_prefix(name, device=args.device)
            elif args.oversubscribe:
                rows = run_oversubscribe(name, device=args.device)
            elif args.speculate is not None:
                rows = run_speculate(name,
                                     speculate_ks=tuple(args.speculate),
                                     device=args.device)
            elif args.mixed:
                rows = run_mixed(name, device=args.device)
            elif args.rebalance:
                rows = run_rebalance(name, device=args.device)
            elif args.quantize:
                rows = run_quantize(name, device=args.device)
            elif args.adapters is not None:
                rows = run_adapters(name, n_adapters=args.adapters,
                                    device=args.device)
            else:
                rows = run_model(name,
                                 decode_chunks=tuple(args.decode_chunk),
                                 device=args.device)
                if args.http:
                    rows += run_http(
                        name, decode_chunk=max(args.decode_chunk),
                        device=args.device)
            for row in rows:
                print(json.dumps(row), flush=True)
            all_rows.extend(rows)
    finally:
        if server_started:
            stop_debug_server()
    if args.json is not None:
        with open(args.json, "w") as f:
            for row in all_rows:
                f.write(json.dumps(row) + "\n")
        print(f"wrote {len(all_rows)} row(s) to {args.json}",
              file=sys.stderr)


if __name__ == "__main__":
    main()
