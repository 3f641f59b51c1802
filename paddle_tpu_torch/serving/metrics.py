"""Serving metrics: per-request latency breakdown + engine gauges,
published through the process-wide observability registry.

The reference's profiler counts op-level host/device events
(platform/profiler.h RecordEvent); a serving engine needs the
request-level cuts on top: queue wait (submit -> slot admission), TTFT
(submit -> first token out), TPOT (mean inter-token time after the
first), and engine gauges (active slots, queue depth, shed count).

A copy of `paddle_tpu/serving/metrics.py` (pure Python): the same
series under the same names, so a scrape reads the port's engine as it
reads the JAX one (the adapter families exist only on an engine with an
adapter pool, as in JAX).

Storage is `paddle_tpu_torch.observability.metrics`: every EngineMetrics
instance owns labeled series (`engine="<n>"`) under stable names —
counters `serving_<name>_total` (incl. the paged pool's
`serving_prefix_cache_{hits,misses}_total` and the speculative
decoder's `serving_spec_{proposed,accepted}_total`), gauges
`serving_active_slots` / `serving_queue_depth` /
`serving_kv_blocks_{total,used,cached}`, histograms
`serving_ttft_seconds` / `serving_tpot_seconds` /
`serving_queue_wait_seconds` (and, only when the engine runs with
`dispatch_timing=True`, the host/device split pair
`serving_dispatch_{host,device}_seconds`; and, only with
`tick_profile=True`, the performance-attribution plane:
`serving_tick_phase_seconds{phase}`, `serving_compiles_total{family}`,
`serving_compile_seconds`, and the derived `serving_mfu_proxy` /
`serving_dispatch_hbm_bytes` gauges) — so a Prometheus
scrape or `get_registry().snapshot()` sees the serving plane without
holding the engine, and the bench's p50/p99 rows come registry-sourced.
`snapshot()` still returns the same plain dict as before (scrapers and
tests keep consuming it directly), now with p50/p99 columns. Device-side
visibility comes from the profiler.RecordEvent scopes the scheduler
wraps around every prefill/decode dispatch (they land in the
observability tracer AND a torch.profiler trace next to the CUDA
kernels).

Degenerate cases return None, never raise and never emit inf: TPOT and
output-rate cuts are undefined for single-token generations and for
zero/negative-duration windows (a non-monotonic injected clock), and
missing lifecycle stamps yield None throughout.

The clock is injectable (default time.monotonic) so tests can pin exact
TTFT/TPOT values with a fake clock.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, Optional

from ..observability.metrics import MetricsRegistry, get_registry

__all__ = ["RequestMetrics", "EngineMetrics"]


class RequestMetrics:
    """Lifecycle timestamps for one request; stamp methods are called by
    the engine as the request moves queue -> slot -> tokens -> done."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.submitted_at: Optional[float] = None
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.tokens_out = 0

    def mark_submitted(self):
        self.submitted_at = self._clock()

    def mark_admitted(self):
        self.admitted_at = self._clock()

    def mark_token(self):
        self.tokens_out += 1
        if self.first_token_at is None:
            self.first_token_at = self._clock()

    def mark_finished(self):
        self.finished_at = self._clock()

    # -- derived cuts -------------------------------------------------------

    @property
    def queue_wait(self) -> Optional[float]:
        if self.submitted_at is None or self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token: submit -> first emission."""
        if self.submitted_at is None or self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token AFTER the first (the decode-step
        steady state); None until at least two tokens are out, and None
        for a negative emission window (non-monotonic injected clock) —
        a nonsense sample must not poison the histogram."""
        if (self.first_token_at is None or self.finished_at is None
                or self.tokens_out < 2):
            return None
        window = self.finished_at - self.first_token_at
        if window < 0:
            return None
        return window / (self.tokens_out - 1)

    @property
    def output_tps(self) -> Optional[float]:
        """Decode throughput: tokens after the first over the emission
        window (first token -> finish). None for single-token
        generations and zero/negative-duration windows — a rate over an
        empty window is undefined, not inf."""
        if (self.first_token_at is None or self.finished_at is None
                or self.tokens_out < 2):
            return None
        window = self.finished_at - self.first_token_at
        if window <= 0:
            return None
        return (self.tokens_out - 1) / window

    @property
    def total(self) -> Optional[float]:
        if self.submitted_at is None or self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def to_dict(self) -> Dict[str, Optional[float]]:
        return {"queue_wait": self.queue_wait, "ttft": self.ttft,
                "tpot": self.tpot, "output_tps": self.output_tps,
                "total": self.total, "tokens_out": self.tokens_out}


_HELP = {
    "submitted": "requests submitted (incl. shed)",
    "admitted": "requests admitted into a KV slot",
    "completed": "requests finished",
    "shed": "requests rejected at the admission door",
    "tokens_out": "total generated tokens",
    "decode_steps": "batched decode steps executed",
    "prefills": "prefill admissions (one per admitted request — a "
                "chunked-prefill engine's per-dispatch count is "
                "serving_prefill_chunks_total)",
    "prefill_chunks": "budget-bounded chunked-prefill dispatches "
                      "(ServingConfig(prefill_chunk=N); 0 on a "
                      "monolithic engine)",
    "dispatches": "fused decode-chunk dispatches launched",
    "spec_proposed": "draft tokens proposed by the speculative "
                     "n-gram drafter (k per live verify pass)",
    "spec_accepted": "draft tokens accepted by verification (each "
                     "saves one full model pass)",
    "prefix_cache_hits": "prompt blocks served from the hashed prefix "
                         "cache instead of re-prefilled",
    "prefix_cache_misses": "shareable prompt blocks that missed the "
                           "prefix cache",
    "preemptions": "running sequences preempted to the host swap pool "
                   "under page pressure",
    "swap_ins": "preempted sequences resumed from the host swap pool",
    "active_slots": "KV slots currently occupied",
    "queue_depth": "requests waiting for a slot",
    "swapped_slots": "preempted sequences currently parked in the host "
                     "swap pool, waiting for pages",
    "kv_blocks_total": "allocatable KV arena blocks (scratch excluded)",
    "kv_blocks_used": "KV arena blocks referenced by live sequences",
    "kv_blocks_cached": "unreferenced KV blocks kept warm for "
                        "prefix-cache hits (LRU-evicted under pressure)",
    "mesh_shards": "tensor-parallel shard count of this engine's "
                   "serving mesh (1 = single chip)",
    "kv_pool_per_chip_bytes": "KV arena bytes resident PER CHIP "
                              "(pool_bytes / mesh_shards — the "
                              "capacity-planning number on a sharded "
                              "pool)",
    "kv_dtype_bytes": "bytes per stored K/V value in the paged arena "
                      "(4 = float32, 2 = bfloat16, 1 = int8-quantized "
                      "— scale planes excluded; pool gauges carry the "
                      "full footprint)",
    "weight_bytes": "whole-model parameter bytes as served (post-"
                    "quantization; summed across chips on a mesh) — "
                    "the weight half of the capacity budget next to "
                    "the KV pool gauges",
}

_COUNTERS = ("submitted", "admitted", "completed", "shed", "tokens_out",
             "decode_steps", "prefills", "prefill_chunks", "dispatches",
             "spec_proposed", "spec_accepted",
             "prefix_cache_hits", "prefix_cache_misses",
             "preemptions", "swap_ins")
_GAUGES = ("active_slots", "queue_depth", "kv_blocks_total",
           "kv_blocks_used", "kv_blocks_cached", "swapped_slots",
           "mesh_shards", "kv_pool_per_chip_bytes",
           "kv_dtype_bytes", "weight_bytes")
_HISTOGRAMS = {"ttft": "serving_ttft_seconds",
               "tpot": "serving_tpot_seconds",
               "queue_wait": "serving_queue_wait_seconds",
               "tokens_per_dispatch": "serving_tokens_per_dispatch",
               "spec_accepted_run": "serving_spec_accepted_run",
               "swap_out": "serving_swap_out_seconds",
               "swap_in": "serving_swap_in_seconds",
               "prefill_chunk": "serving_prefill_chunk_seconds"}
_HIST_HELP = {
    "ttft": "request ttft in seconds "
            "(default latency buckets, 0.5ms..10s)",
    "tpot": "request tpot in seconds "
            "(default latency buckets, 0.5ms..10s)",
    "queue_wait": "request queue wait in seconds "
                  "(default latency buckets, 0.5ms..10s)",
    "tokens_per_dispatch": "tokens emitted per fused decode dispatch "
                           "(the chunk-amortization ratio: dispatches-"
                           "per-token is its reciprocal; power-of-two "
                           "count buckets, widened per engine to its "
                           "dispatch token ceiling)",
    "spec_accepted_run": "accepted draft-run length per speculative "
                         "verify pass (0 = every draft rejected; "
                         "tokens per pass is this + 1; count buckets "
                         "0..speculate_k per engine)",
    "swap_out": "host-swap copy-out latency per preemption in seconds "
                "(pipeline fence + device_get of the slot's blocks; "
                "default latency buckets, 0.5ms..10s)",
    "swap_in": "host-swap restore latency per resume in seconds "
               "(block adoption + scatter + carry rebuild; default "
               "latency buckets, 0.5ms..10s)",
    "prefill_chunk": "launch-side wall seconds per chunked-prefill "
                     "dispatch (staging + trace/enqueue of the chunk "
                     "executable; empty on a monolithic engine; "
                     "default latency buckets, 0.5ms..10s)",
}

# host/device dispatch split (ServingConfig(dispatch_timing=True) only:
# the disabled default must add ZERO registry series): per fused decode
# dispatch, the launch-side host segment vs the blocking wait for its
# result. host seconds per dispatch is the pinned baseline the native
# continuous-batching core is judged against.
_TIMING_HISTOGRAMS = {"dispatch_host": "serving_dispatch_host_seconds",
                      "dispatch_device": "serving_dispatch_device_seconds"}
_TIMING_HELP = {
    "dispatch_host": "launch-side host seconds per fused decode "
                     "dispatch (arg flatten + enqueue; the host "
                     "overhead the native-core work must shrink; "
                     "default latency buckets, 0.5ms..10s)",
    "dispatch_device": "blocking wait per fused decode dispatch for "
                       "its result (un-hidden device execution; "
                       "default latency buckets, 0.5ms..10s)",
}

# performance-attribution plane (ServingConfig(tick_profile=True) only
# — the disabled default must add ZERO registry families/series, same
# discipline as the dispatch-timing pair): per-tick phase decomposition
# of the GIL-bound host loop, plus the executable compile/cost journal
# series the /compilez endpoint and the mfu-proxy gauges are derived
# from.
_TICK_PHASES = ("admit", "prefill_chunk", "launch", "collect",
                "stream", "bookkeeping")
# host-tick phases live at the microsecond scale, far below the
# latency-seconds default grid — a dedicated fine grid keeps the phase
# histograms from piling into the bottom bucket
_TICK_PHASE_BUCKETS = (1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4,
                       1e-3, 5e-3, 0.01, 0.05, 0.25)
# compile events (a family's first call at a shape) can take seconds;
# the default sub-second grid would dump them into +Inf
_COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                    10.0, 30.0, 60.0)
_TICK_HELP = {
    "tick_phase": "host wall seconds per engine tick phase (admit / "
                  "prefill_chunk / launch / collect / stream / "
                  "bookkeeping) — the phase decomposition the native "
                  "continuous-batching core is scoped and judged by "
                  "(fine microsecond bucket grid, 1us..0.25s)",
    "compiles": "executable compile events per jit family (one per "
                "newly traced shape bucket; steady state adds none)",
    "compile_seconds": "wall seconds spent inside dispatches that "
                       "were their family's first call at a shape "
                       "(coarse buckets, 10ms..60s)",
    "mfu_proxy": "model-FLOPs-utilization proxy: cost_analysis FLOPs "
                 "x dispatch rate over nominal peak FLOPs (override "
                 "peak via PT_SERVING_PEAK_FLOPS) — a trend line, "
                 "not an absolute MFU",
    "dispatch_hbm_bytes": "cost_analysis bytes accessed per fused "
                          "decode dispatch (the HBM roofline side of "
                          "the attribution)",
}

# multi-tenant adapter pool series (ServingConfig(max_adapters=...)
# engines only — the adapterless default must add ZERO registry
# families/series, same discipline as the dispatch-timing pair): the
# resident count / device bytes the pool pins, and the cumulative
# upload/eviction totals mirrored from the pool's host bookkeeping.
_ADAPTER_COUNTERS = ("adapter_uploads", "adapter_evictions")
_ADAPTER_GAUGES = ("adapters_resident", "adapter_pool_bytes")
_ADAPTER_HELP = {
    "adapter_uploads": "LoRA adapter uploads installed into the "
                       "device pool (re-uploads of a resident id "
                       "included)",
    "adapter_evictions": "LoRA adapters dropped from the pool "
                         "(explicit evicts + LRU evictions under "
                         "upload pressure)",
    "adapters_resident": "uploaded LoRA adapters currently resident "
                         "in the device pool (the reserved base "
                         "identity row excluded)",
    "adapter_pool_bytes": "device bytes the LoRA A/B pool pins "
                          "(constant for the engine's life — the "
                          "pool is allocated whole at construction)",
}

def _count_buckets(upper: int):
    """Power-of-two count-histogram bounds covering [1, upper] — the
    scale-free grid for "how many per dispatch" distributions."""
    bounds, b = [], 1
    while b < upper:
        bounds.append(b)
        b *= 2
    bounds.append(b)
    return tuple(bounds)


# count-scaled base layouts (NOT latency seconds): identical for every
# EngineMetrics at the family level, per-engine scaling happens through
# the per-SERIES bucket override (engines with different decode_chunk /
# speculate_k share one process registry, and the registry rightly
# refuses conflicting family-level layouts)
_TPD_BASE = _count_buckets(512)
_SPEC_RUN_BASE = (0, 1, 2, 3, 4, 6, 8, 12, 16)


class EngineMetrics:
    """Engine-level counters + gauges, stored as labeled series in the
    observability registry. Counters are monotonic; gauges are set by the
    engine each step; record() feeds a finished request's RequestMetrics
    into the TTFT/TPOT/queue-wait histograms so snapshot() carries
    fleet-level means AND p50/p99 without keeping every request alive.

    The attribute protocol is unchanged (`metrics.submitted += 1`,
    `metrics.queue_depth = n`): each name is a property over its registry
    series, so engine code and the registry can never disagree."""

    _ids = itertools.count()

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 engine_label: Optional[str] = None,
                 max_tokens_per_dispatch: Optional[int] = None,
                 speculate_k: int = 0, dispatch_timing: bool = False,
                 adapters: bool = False, tick_profile: bool = False):
        self._registry = registry or get_registry()
        self.engine_label = str(engine_label if engine_label is not None
                                else next(EngineMetrics._ids))
        # bucket-scaling inputs kept readable so a replacement instance
        # (an engine's post-warmup metrics reset) reproduces this
        # engine's series layout instead of re-deriving the formula
        self.max_tokens_per_dispatch = (int(max_tokens_per_dispatch)
                                        if max_tokens_per_dispatch
                                        else None)
        self.speculate_k = int(speculate_k)
        self.dispatch_timing = bool(dispatch_timing)
        self.adapters = bool(adapters)
        self.tick_profile = bool(tick_profile)
        label = {"engine": self.engine_label}
        self._families = []
        self._series = {}
        # multi-label series (engine+phase / engine+family) tracked
        # with their FULL label sets: MetricFamily.remove() matches the
        # exact key tuple, so unregister()'s engine-only sweep would
        # leave them behind
        self._labeled = []
        for name in _COUNTERS:
            fam = self._registry.counter(
                f"serving_{name}_total", _HELP[name])
            self._families.append(fam)
            self._series[name] = fam.labels(**label)
        for name in _GAUGES:
            fam = self._registry.gauge(f"serving_{name}", _HELP[name])
            self._families.append(fam)
            self._series[name] = fam.labels(**label)
        self._hists = {}
        for key, full in _HISTOGRAMS.items():
            # tokens-per-dispatch / accepted-run are COUNT distributions,
            # not latencies: the default seconds-scaled buckets would
            # dump every observation in +Inf. The family registers the
            # shared base grid; THIS engine's series widens it to
            # num_slots * decode_chunk * (1 + speculate_k) (the true
            # per-dispatch token ceiling under speculation) resp.
            # 0..speculate_k, so accepted runs never pile into the top
            # bucket however the engine is configured.
            buckets = series_buckets = None
            if key == "tokens_per_dispatch":
                buckets = _TPD_BASE
                if max_tokens_per_dispatch:
                    series_buckets = _count_buckets(
                        max(int(max_tokens_per_dispatch), _TPD_BASE[-1]))
            elif key == "spec_accepted_run":
                buckets = _SPEC_RUN_BASE
                if speculate_k:
                    series_buckets = tuple(range(int(speculate_k) + 1))
            fam = self._registry.histogram(full, _HIST_HELP[key],
                                           buckets=buckets)
            self._families.append(fam)
            self._hists[key] = fam.labels(_buckets=series_buckets,
                                          **label)
        if self.dispatch_timing:
            # registered ONLY when the split is on: the disabled path
            # is pinned to add zero registry families/series
            for key, full in _TIMING_HISTOGRAMS.items():
                fam = self._registry.histogram(full, _TIMING_HELP[key])
                self._families.append(fam)
                self._hists[key] = fam.labels(**label)
        if self.tick_profile:
            # performance-attribution series, registered ONLY when the
            # tick profiler is on — the default family set is pinned
            # unchanged (test_tick_profile_disabled_is_noop)
            fam = self._registry.histogram(
                "serving_tick_phase_seconds", _TICK_HELP["tick_phase"],
                buckets=_TICK_PHASE_BUCKETS)
            self._families.append(fam)
            self._tick_phase = {}
            for phase in _TICK_PHASES:
                s = fam.labels(engine=self.engine_label, phase=phase)
                self._tick_phase[phase] = s
                self._labeled.append((fam, {"engine": self.engine_label,
                                            "phase": phase}))
            self._compiles_fam = self._registry.counter(
                "serving_compiles_total", _TICK_HELP["compiles"])
            self._families.append(self._compiles_fam)
            self._compiles = {}   # family tag -> counter series (lazy)
            fam = self._registry.histogram(
                "serving_compile_seconds", _TICK_HELP["compile_seconds"],
                buckets=_COMPILE_BUCKETS)
            self._families.append(fam)
            self._hists["compile"] = fam.labels(**label)
            fam = self._registry.gauge(
                "serving_mfu_proxy", _TICK_HELP["mfu_proxy"])
            self._families.append(fam)
            self._series["mfu_proxy"] = fam.labels(**label)
            fam = self._registry.gauge(
                "serving_dispatch_hbm_bytes",
                _TICK_HELP["dispatch_hbm_bytes"])
            self._families.append(fam)
            self._series["dispatch_hbm_bytes"] = fam.labels(**label)
        if self.adapters:
            # adapter pool series, registered ONLY for pool-carrying
            # engines — the adapterless family set is pinned unchanged
            for name in _ADAPTER_COUNTERS:
                fam = self._registry.counter(
                    f"serving_{name}_total", _ADAPTER_HELP[name])
                self._families.append(fam)
                self._series[name] = fam.labels(**label)
            for name in _ADAPTER_GAUGES:
                fam = self._registry.gauge(
                    f"serving_{name}", _ADAPTER_HELP[name])
                self._families.append(fam)
                self._series[name] = fam.labels(**label)

    def unregister(self) -> None:
        """Remove this engine's labeled series from the registry so a
        retired/replaced engine stops showing up in scrapes (a long-lived
        service recreating engines must not accumulate dead labels).
        snapshot() keeps working on the detached series."""
        for fam, labels in self._labeled:
            fam.remove(**labels)
        for fam in self._families:
            fam.remove(engine=self.engine_label)

    def queue_wait_p50(self) -> Optional[float]:
        """Median queue wait (seconds) over the recent request window —
        the Retry-After hint a shed (EngineOverloadError) carries so the
        HTTP tier can tell clients how long a slot realistically takes
        to free. None until a request has completed the queue."""
        return self._hists["queue_wait"].quantile(0.5)

    def observe_dispatch_tokens(self, n: int) -> None:
        """One collected decode dispatch emitted n live tokens (frozen
        ride-along repeats excluded) — the amortization series the
        /varz- and bench-visible dispatches-per-token columns read."""
        self._hists["tokens_per_dispatch"].observe(float(n))

    def observe_spec_run(self, accepted: int) -> None:
        """One live speculative verify pass accepted `accepted` draft
        tokens (0..speculate_k) — the per-pass acceptance distribution
        behind the /varz acceptance-ratio rollup."""
        self._hists["spec_accepted_run"].observe(float(accepted))

    def observe_prefill_chunk(self, seconds: float) -> None:
        """One chunked-prefill dispatch spent `seconds` launch-side —
        the per-chunk latency series behind the bench's
        prefill_chunk_ms column and the /varz prefill rollup."""
        self._hists["prefill_chunk"].observe(float(seconds))

    def observe_swap(self, direction: str, seconds: float) -> None:
        """One host-swap transfer took `seconds`; direction is
        "swap_out" (preemption copy-out) or "swap_in" (resume restore)
        — the latency series behind the bench's swap_in_ms column."""
        self._hists[direction].observe(float(seconds))

    def observe_tick_phase(self, phase: str, seconds: float) -> None:
        """One engine tick spent `seconds` of host wall time in the
        named phase — the decomposition behind the /varz tick_phases
        rollup, the /tickz flight ring, and the bench's tick_phase_ms
        columns. No-op unless this instance was built with
        tick_profile=True (the series don't exist otherwise)."""
        if not self.tick_profile:
            return
        self._tick_phase[phase].observe(float(seconds))

    def observe_compile(self, family: str, seconds: float) -> None:
        """One dispatch of jit family `family` triggered a compile that
        took `seconds` wall time (its first call at that shape).
        Series per family are minted lazily — families only exist once
        they have compiled at least once. No-op unless tick_profile."""
        if not self.tick_profile:
            return
        s = self._compiles.get(family)
        if s is None:
            labels = {"engine": self.engine_label, "family": family}
            s = self._compiles_fam.labels(**labels)
            self._compiles[family] = s
            self._labeled.append((self._compiles_fam, labels))
        s.inc()
        self._hists["compile"].observe(float(seconds))

    def set_perf_gauges(self, mfu_proxy: Optional[float],
                        hbm_bytes: Optional[float]) -> None:
        """Refresh the derived cost x dispatch-rate gauges from the
        compile journal (None leaves a gauge untouched — cost analysis
        is best-effort and may be unavailable for a family). No-op
        unless tick_profile."""
        if not self.tick_profile:
            return
        if mfu_proxy is not None:
            self._series["mfu_proxy"].set(float(mfu_proxy))
        if hbm_bytes is not None:
            self._series["dispatch_hbm_bytes"].set(float(hbm_bytes))

    def observe_dispatch_split(self, host_s: float,
                               device_s: float) -> None:
        """One fused decode dispatch spent `host_s` launch-side and
        `device_s` blocked on its result — the host/device attribution
        behind the /varz host_overhead_per_dispatch rollup and the
        bench's host_overhead_ms column. No-op unless this instance was
        built with dispatch_timing=True (the series don't exist
        otherwise)."""
        if not self.dispatch_timing:
            return
        self._hists["dispatch_host"].observe(float(host_s))
        self._hists["dispatch_device"].observe(float(device_s))

    def record(self, rm: RequestMetrics):
        self.completed += 1
        if rm.ttft is not None:
            self._hists["ttft"].observe(rm.ttft)
        if rm.tpot is not None:
            self._hists["tpot"].observe(rm.tpot)
        if rm.queue_wait is not None:
            self._hists["queue_wait"].observe(rm.queue_wait)

    def snapshot(self) -> Dict[str, Optional[float]]:
        out: Dict[str, Optional[float]] = {}
        for name in _COUNTERS + _GAUGES:
            out[name] = int(self._series[name].value)
        for name in _ADAPTER_COUNTERS + _ADAPTER_GAUGES:
            if name in self._series:   # pool-carrying engines only
                out[name] = int(self._series[name].value)
        for name in ("mfu_proxy", "dispatch_hbm_bytes"):
            if name in self._series:   # tick_profile engines only
                out[name] = float(self._series[name].value)
        for key, h in self._hists.items():
            out[f"mean_{key}"] = h.mean
            out[f"p50_{key}"] = h.quantile(0.5)
            out[f"p99_{key}"] = h.quantile(0.99)
        return out


def _make_prop(name: str, doc: str) -> property:
    def _get(self):
        return int(self._series[name].value)

    def _set(self, value):
        self._series[name].set(value)

    return property(_get, _set, doc=doc)


for _name in _COUNTERS + _GAUGES:
    setattr(EngineMetrics, _name, _make_prop(_name, _HELP[_name]))
del _name

# adapter properties exist on every instance; the backing series only
# when the engine was built with adapters=True (the engine guards every
# access behind its pool being non-None)
for _name in _ADAPTER_COUNTERS + _ADAPTER_GAUGES:
    setattr(EngineMetrics, _name, _make_prop(_name, _ADAPTER_HELP[_name]))
del _name
