"""Request-lifecycle engine: admission queue, backpressure, streaming.

Port of `paddle_tpu/serving/engine.py`. A request moves

    submit() -> QUEUED -> (slot free AND pages free) RUNNING -> FINISHED
             -> EngineOverloadError when the admission queue is full
                (shed at the door; an arena out of PAGES queues instead —
                retirements free pages, so the wait is bounded)

with a per-request streaming callback fired on every emitted token and
RequestMetrics stamping queue-wait/TTFT/TPOT along the way. The engine
is driven synchronously — step() interleaves admissions with one decode
pipeline tick (launch the next fused chunk dispatch, fan out the oldest
completed block; see scheduler.py); run_until_drained() loops — while
submit() itself is lock-protected so producer threads can feed a driver
loop.

With `ServingConfig(preempt=True)` page pressure evicts a policy-chosen
running sequence to a host swap pool (`scheduler.swap_out`) and resumes
it, with strict priority over new admissions, once pages free; and
`migrate_out`/`migrate_in` hand a running or parked sequence to another
engine as a `migration.MigrationTicket` (the router's rebalancing and
restarts). Resumed and migrated streams are bit-identical to
never-preempted runs. With `ServingConfig(speculate_k=k)` every decode
iteration drafts k tokens from a per-slot n-gram table and verifies them
in one model pass; streams stay bit-identical to speculate_k=0. With
`weight_dtype="int8"` the engine quantizes its weights at construction
(`gpt_decode.quantize_params`) and with `kv_dtype="int8"` it serves from
an int8 arena with an f32 scale plane; with `max_adapters`/
`adapter_rank` it holds a LoRA pool (`adapters.AdapterPool`) and each
request decodes under its own `adapter_id`.

The engine runs on its parameters' device (`inference.create_engine`
puts them on the card unless the Config says `disable_gpu()`).
`ServingConfig` keeps the JAX signature; mesh_shape (ROADMAP A.8) raises
NotImplementedError at construction, and nothing falls back to another
path.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..models import gpt_decode as _gd
from ..observability import request_log as _request_log
from ..observability import watchdog as _watchdog
from ..observability.tracer import get_tracer, request_scope, trace_span
from .kv_cache import ShapeBuckets, SlotKVCache
from .metrics import _TICK_PHASES, EngineMetrics, RequestMetrics
from .scheduler import (PREFILL_PENDING, CompileJournal,
                        ContinuousBatchingScheduler)

_TRACER = get_tracer()

__all__ = ["ServingConfig", "ServingEngine", "GenerationRequest",
           "EngineOverloadError", "DEFAULT_RETRY_AFTER_S"]

# Retry-After hint a shed carries before the engine has any queue-wait
# samples (cold engine)
DEFAULT_RETRY_AFTER_S = 0.1


class EngineOverloadError(RuntimeError):
    """Admission queue full: the request was shed, not enqueued.

    Structured fields: `queue_depth` (requests waiting at shed time),
    `running` (slots occupied), `retry_after_s` (suggested client
    backoff: the engine's queue-wait p50 when it has samples, else
    DEFAULT_RETRY_AFTER_S — never None from the engine's own shed
    path)."""

    def __init__(self, message: str, queue_depth: Optional[int] = None,
                 running: Optional[int] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.running = running
        self.retry_after_s = retry_after_s


def _not_ported(knob: str, item: str):
    return NotImplementedError(
        f"ServingConfig({knob}) is not ported to paddle_tpu_torch yet "
        f"(ROADMAP {item})")


class ServingConfig:
    """Engine knobs (the JAX package's signature). num_slots bounds
    concurrency (the decode batch dim = page-table rows); max_queue
    bounds the admission queue (beyond it, submit() sheds);
    prefill_buckets is the fixed set of padded prompt-SUFFIX lengths;
    max_len is the per-sequence position capacity (default cfg.max_pos).

    Paged pool knobs: block_size is the page granularity; kv_blocks
    sizes the arena (default: num_slots × pages-per-max_len + scratch);
    prefix_cache toggles hashed prefix sharing.

    Decode knobs: decode_chunk decode iterations per dispatch (streams
    identical at every setting); overlap keeps one dispatch in flight
    while host post-processing runs (overlap=False reads each dispatch's
    block at once). top_k > 0 samples among the k best logits.
    prefill_chunk=N splits every prompt's suffix prefill into chunk
    dispatches of at most N tokens, one budget per engine step
    (streams identical to None).

    Observability knobs: dispatch_timing=True attributes every decode
    dispatch's wall time into launch-side host work vs the wait for its
    block (serving_dispatch_{host,device}_seconds); tick_profile=True
    decomposes every engine tick into phases
    (serving_tick_phase_seconds{phase}, a bounded per-tick ring, and the
    compile journal). Both off by default, adding no series.

    Preemption knobs: preempt=True evicts, under page pressure, the
    policy-chosen RUNNING sequence's pages to a host swap pool and
    resumes it when pages free, instead of only queueing new
    admissions. preempt_policy: "newest" (default), "oldest", or a
    callable over the running table. Resumed streams are bit-identical
    to never-preempted runs.

    Speculation knobs: speculate_k > 0 turns every fused decode
    iteration into a draft -> verify -> accept pass — a per-slot
    n-gram drafter proposes speculate_k tokens, one model pass verifies
    them, exact-match acceptance commits 1..speculate_k+1 tokens — with
    token streams bit-identical to speculate_k=0; speculate_ngram sizes
    the hashed per-slot drafter table.

    Quantization knobs (both None = full precision): weight_dtype="int8"
    serves per-output-channel int8 matmul weights with f32 scales,
    kv_dtype="int8" an int8 block arena with an f32 scale plane
    (quantized at every K/V scatter, dequantized at every page gather).
    Any other string raises ValueError; a quantized engine is
    bit-identical to itself across chunk sizes, preemption and
    migration, not to fp32.

    Adapter knobs (both None = no pool): max_adapters=N (>= 2, row 0 the
    base identity) and adapter_rank=r allocate a LoRA pool; upload with
    ServingEngine.upload_adapter and route with submit(adapter_id=k).
    Co-batched requests run different adapters in one dispatch, and
    adapter_id=0 streams are bit-identical to an adapterless engine.

    Not ported yet: mesh_shape (ROADMAP A.8) raises
    NotImplementedError."""

    def __init__(self, num_slots: int = 4, max_queue: int = 16,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 max_len: Optional[int] = None, top_k: int = 0,
                 max_admits_per_step: Optional[int] = None,
                 decode_chunk: int = 8, overlap: bool = True,
                 block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 speculate_k: int = 0,
                 speculate_ngram: int = 512,
                 prefill_chunk: Optional[int] = None,
                 preempt: bool = False,
                 preempt_policy="newest",
                 mesh_shape: Optional[Sequence[int]] = None,
                 weight_dtype: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 max_adapters: Optional[int] = None,
                 adapter_rank: Optional[int] = None,
                 fault_plan=None,
                 dispatch_timing: bool = False,
                 tick_profile: bool = False,
                 clock: Callable[[], float] = time.monotonic):
        if mesh_shape is not None:
            raise _not_ported(f"mesh_shape={mesh_shape!r}", "A.8")
        # quantized serving: an unknown dtype string is a loud config
        # error, never a silent fp32 fallback
        for knob, val in (("weight_dtype", weight_dtype),
                          ("kv_dtype", kv_dtype)):
            if val not in (None, "int8"):
                raise ValueError(
                    f"unknown {knob} {val!r}: expected None (full "
                    "precision) or 'int8' — quantized serving never "
                    "falls back silently")
        self.weight_dtype = weight_dtype
        self.kv_dtype = kv_dtype
        # the adapter pool needs both its row count and its rank
        if (max_adapters is None) != (adapter_rank is None):
            raise ValueError(
                "max_adapters and adapter_rank must be set together "
                f"(got max_adapters={max_adapters!r}, "
                f"adapter_rank={adapter_rank!r}) — an adapter pool "
                "needs both its row count and its rank")
        if max_adapters is not None:
            if not isinstance(max_adapters, int) \
                    or isinstance(max_adapters, bool) or max_adapters < 2:
                raise ValueError(
                    f"max_adapters must be an int >= 2 (row 0 is the "
                    f"reserved base identity), got {max_adapters!r}")
            if not isinstance(adapter_rank, int) \
                    or isinstance(adapter_rank, bool) or adapter_rank < 1:
                raise ValueError(
                    f"adapter_rank must be an int >= 1, got "
                    f"{adapter_rank!r}")
        self.max_adapters = max_adapters
        self.adapter_rank = adapter_rank
        self.num_slots = int(num_slots)
        self.max_queue = int(max_queue)
        self.prefill_buckets = tuple(prefill_buckets) \
            if prefill_buckets is not None else None
        self.max_len = max_len
        self.top_k = int(top_k)
        self.max_admits_per_step = max_admits_per_step
        self.block_size = int(block_size)
        self.kv_blocks = kv_blocks
        self.prefix_cache = bool(prefix_cache)
        self.preempt = bool(preempt)
        self.preempt_policy = preempt_policy
        # speculative decoding (off by default): the scheduler
        # validates both; migration tickets check them
        self.speculate_k = int(speculate_k)
        self.speculate_ngram = int(speculate_ngram)
        self.decode_chunk = int(decode_chunk)
        self.overlap = bool(overlap)
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 or None, got "
                f"{prefill_chunk}")
        self.prefill_chunk = int(prefill_chunk) \
            if prefill_chunk is not None else None
        # deterministic fault injection (serving.faults.FaultPlan)
        self.fault_plan = fault_plan
        self.dispatch_timing = bool(dispatch_timing)
        self.tick_profile = bool(tick_profile)
        self.clock = clock


class GenerationRequest:
    """One generate call in flight. `tokens` accumulates the generated
    ids (prompt excluded); `output()` is prompt + generated. state is
    one of queued / running / finished / cancelled / shed. `request_id`
    is the engine-minted trace id (`<engine_label>-<n>`) every span this
    request produces carries."""

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 temperature: float, seed: int, eos_id: Optional[int],
                 on_token: Optional[Callable[["GenerationRequest", int],
                                             Any]],
                 clock: Callable[[], float],
                 request_id: Optional[str] = None,
                 adapter_id: int = 0):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.eos_id = eos_id
        self.on_token = on_token
        self.tokens: List[int] = []
        self.state = "queued"
        self.metrics = RequestMetrics(clock)
        self.request_id = request_id
        self.adapter_id = int(adapter_id)
        self._submit_ns: Optional[int] = None  # tracer queue-wait anchor

    @property
    def finished(self) -> bool:
        return self.state == "finished"

    def output(self) -> np.ndarray:
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])


def _default_buckets(max_len: int):
    sizes, s = [], 16
    while s < max_len:
        sizes.append(s)
        s *= 2
    sizes.append(max_len)
    return sizes


# per-tick flight records kept (bounded: a day of serving must not grow
# host memory)
TICK_RING_SIZE = 256


class _TickClock:
    """Per-tick phase stopwatch (tick_profile engines only). start()
    re-arms it at the top of each tick and lap(phase) charges the wall
    time since the last cut to the named phase, minus whatever the
    scheduler's hooked launch/collect segments already claimed inside
    that window (hook(), wired as scheduler.on_tick_phase). So
    sum(phases.values()) == the tick's wall time."""

    __slots__ = ("phases", "_t0", "_tick_t0", "_hooked")

    def __init__(self):
        self.phases = dict.fromkeys(_TICK_PHASES, 0.0)
        self._t0 = self._tick_t0 = 0.0
        self._hooked = 0.0

    def start(self) -> None:
        self._t0 = self._tick_t0 = time.perf_counter()
        self._hooked = 0.0
        for phase in _TICK_PHASES:
            self.phases[phase] = 0.0

    def hook(self, phase: str, seconds: float) -> None:
        self.phases[phase] += seconds
        self._hooked += seconds

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        self.phases[phase] += (now - self._t0) - self._hooked
        self._hooked = 0.0
        self._t0 = now


class ServingEngine:
    """Continuous-batching generate service over a GPT parameter tree.

    params/cfg are gpt_decode's (collect_gpt_params + GPTConfig); the
    engine, its arena and its decode state live on the parameters'
    device. inference.create_engine() wires them from a saved model
    dir."""

    def __init__(self, params, cfg, serving: Optional[ServingConfig] = None):
        serving = serving or ServingConfig()
        self.cfg = cfg
        self.config = serving
        max_len = int(serving.max_len if serving.max_len is not None
                      else cfg.max_pos)
        if max_len > cfg.max_pos:
            raise ValueError(
                f"max_len {max_len} exceeds cfg.max_pos {cfg.max_pos}")
        if serving.prefill_buckets is not None:
            buckets = serving.prefill_buckets
            too_big = [b for b in buckets if b > max_len]
            if too_big:
                raise ValueError(
                    f"prefill_buckets {too_big} exceed max_len {max_len} "
                    "— a prompt filling such a bucket could never fit the "
                    "KV pool")
        else:
            buckets = _default_buckets(max_len)
        self.buckets = ShapeBuckets(buckets)
        self.device = params["wte"].device
        # coverage asserts: a quantized arena or an adapter pool may only
        # reach the paged functions whose dequant / low-rank path exists
        # (gpt_decode.QUANTIZED_KV_KERNELS / ADAPTER_KERNELS); refusing
        # beats reading int8 rows as values or serving base tokens
        if serving.kv_dtype == "int8" and serving.speculate_k > 0 \
                and "gpt_decode_verify_pages" not in \
                _gd.QUANTIZED_KV_KERNELS:
            raise ValueError(
                "kv_dtype='int8' with speculate_k > 0 requires the "
                "verify kernel's dequant path "
                "(gpt_decode.QUANTIZED_KV_KERNELS lacks "
                "'gpt_decode_verify_pages') — refusing rather than "
                "silently reading quantized rows as values")
        if serving.max_adapters is not None:
            needed = {"gpt_prefill_pages", "gpt_decode_chunk_pages"}
            if serving.speculate_k > 0:
                needed.add("gpt_decode_verify_pages")
            if serving.prefill_chunk is not None:
                needed.add("gpt_prefill_chunk_pages")
            missing = sorted(needed - set(_gd.ADAPTER_KERNELS))
            if missing:
                raise ValueError(
                    "max_adapters requires the per-slot adapter path in "
                    f"every dispatched kernel; gpt_decode.ADAPTER_KERNELS "
                    f"lacks {missing} — refusing rather than silently "
                    "serving base-model tokens")
        compute = _gd.compute_dtype(params)
        if serving.weight_dtype == "int8":
            params = _gd.quantize_params(params, cfg)
        # parameter bytes AS SERVED (int8 weights and their scales after
        # quantization) and the weight dtype stats() reports: the knob
        # when set, else the embedding table's dtype
        self.weight_bytes = int(sum(t.numel() * t.element_size()
                                    for t in _gd.param_tensors(params)))
        self._weight_dtype = serving.weight_dtype or \
            str(params["wte"].dtype).replace("torch.", "")
        # the LoRA pool on the engine's device (None = adapterless: the
        # server and migration tickets read this)
        self.adapters = None
        if serving.max_adapters is not None:
            from .adapters import AdapterPool
            self.adapters = AdapterPool(cfg, serving.max_adapters,
                                        serving.adapter_rank,
                                        device=self.device)
        self.kv = SlotKVCache(cfg, serving.num_slots, max_len, compute,
                              block_size=serving.block_size,
                              num_blocks=serving.kv_blocks,
                              prefix_cache=serving.prefix_cache,
                              kv_dtype=serving.kv_dtype,
                              device=self.device)
        self.scheduler = ContinuousBatchingScheduler(
            params, cfg, self.kv, self.buckets, top_k=serving.top_k,
            decode_chunk=serving.decode_chunk, overlap=serving.overlap,
            speculate_k=serving.speculate_k,
            speculate_ngram=serving.speculate_ngram,
            prefill_chunk=serving.prefill_chunk,
            adapters=self.adapters)
        self.scheduler.on_prefill_chunk = self._on_prefill_chunk
        # launch-side heartbeat: bumped at dispatch ENQUEUE inside the
        # scheduler, so a device hang with the host blocked in the next
        # read still shows the last launch that went in
        self.scheduler.on_launch = self._on_dispatch_launched
        # count-scaled histogram layout: one dispatch can emit up to
        # num_slots * decode_chunk * (1 + speculate_k) tokens, and the
        # acceptance histogram spans 0..speculate_k accepted a pass
        self.metrics = EngineMetrics(
            max_tokens_per_dispatch=(serving.num_slots
                                     * serving.decode_chunk
                                     * (1 + serving.speculate_k)),
            speculate_k=serving.speculate_k,
            dispatch_timing=serving.dispatch_timing,
            adapters=self.adapters is not None,
            tick_profile=serving.tick_profile)
        if serving.dispatch_timing:
            self.scheduler.dispatch_timing = True
            self.scheduler.on_dispatch_timed = self._on_dispatch_timed
        # performance-attribution plane (tick_profile=True only)
        self._tick = None
        self._tick_ring = None
        if serving.tick_profile:
            self._tick = _TickClock()
            self._tick_ring = collections.deque(maxlen=TICK_RING_SIZE)
            self.scheduler.on_tick_phase = self._tick.hook
            journal = CompileJournal()
            journal.on_compile = self._on_compile
            self.scheduler.compile_journal = journal
            # /tickz + /compilez read through the debug server's
            # perf-source registry; close() unregisters them
            from ..observability import debug_server as _dbg
            _dbg.register_perf_source(
                "tick", self.metrics.engine_label, self._tick_records)
            _dbg.register_perf_source(
                "compile", self.metrics.engine_label,
                self._compile_snapshot)
        self._sync_geometry_gauges()
        self._queue: List[GenerationRequest] = []
        self._pending_cancels: List[GenerationRequest] = []
        # host swap pool: SwappedSequence records of preempted or
        # adopted sequences, FIFO (oldest-preempted resumes first).
        # Driver-thread state, like the scheduler.
        self._swapped: List[Any] = []
        self.faults = serving.fault_plan
        self._step_no = 0
        self._lock = threading.Lock()
        # drain flag (begin_drain): migration refuses on a draining
        # engine; stepping and swap-in of parked sequences go on
        self._draining = False
        self._rid_counter = itertools.count()
        self.debug_port: Optional[int] = None   # set by create_engine
        # debug-server release token from acquire_debug_server (None =
        # this engine holds no reference); set by create_engine
        self._debug_server_ref: Optional[int] = None

    @property
    def faults(self):
        """The installed FaultPlan (None = no injection). Assigning here
        mirrors the plan onto the scheduler so dispatch-level faults
        fire too."""
        return self._faults

    @faults.setter
    def faults(self, plan) -> None:
        self._faults = plan
        self.scheduler.faults = plan

    def _sync_geometry_gauges(self) -> None:
        self.metrics.kv_blocks_total = self.kv.blocks_total
        self.metrics.mesh_shards = self.kv.mesh_shards
        self.metrics.kv_pool_per_chip_bytes = self.kv.hbm_per_chip_bytes
        self.metrics.kv_dtype_bytes = self.kv.kv.element_size()
        self.metrics.weight_bytes = self.weight_bytes
        if self.adapters is not None:
            self._sync_adapter_metrics()

    # -- admission ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               seed: int = 0, eos_id: Optional[int] = None,
               on_token: Optional[Callable] = None,
               adapter_id: int = 0) -> GenerationRequest:
        """Enqueue one generate request. Raises ValueError for requests
        that can never be served (too long for the buckets/pool, an
        unknown or unresident adapter_id) and EngineOverloadError when
        the queue is full (backpressure: nothing queues unboundedly).
        adapter_id pins the named LoRA adapter (upload_adapter) for the
        request's whole life: its pool row cannot be evicted or
        overwritten until the request finishes, cancels or migrates
        away."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        adapter_id = int(adapter_id)
        if adapter_id < 0:
            raise ValueError(f"adapter_id must be >= 0, got {adapter_id}")
        if adapter_id and self.adapters is None:
            raise ValueError(
                f"adapter_id {adapter_id} on an engine with no adapter "
                "pool (ServingConfig(max_adapters=..., adapter_rank=...))")
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.buckets.bucket_for(prompt.size)          # raises if too long
        total = prompt.size + max_new_tokens
        if total > self.kv.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the pool's max_len "
                f"({self.kv.max_len})")
        if self.kv.blocks_for(total) > self.kv.blocks_total:
            raise ValueError(
                f"request needs {self.kv.blocks_for(total)} KV blocks "
                f"but the arena only has {self.kv.blocks_total}")
        req = GenerationRequest(
            prompt, max_new_tokens, temperature, seed, eos_id, on_token,
            self.config.clock,
            request_id=f"{self.metrics.engine_label}-"
                       f"{next(self._rid_counter)}",
            adapter_id=adapter_id)
        if _TRACER.enabled:  # queue-wait anchor; no clock read when off
            req._submit_ns = time.monotonic_ns()
        rlog = _request_log.get_request_log()
        if rlog is not None:
            rlog.event("submitted", request_id=req.request_id,
                       engine=self.metrics.engine_label,
                       prompt_len=int(prompt.size),
                       max_new=int(max_new_tokens),
                       adapter_id=adapter_id)
        with self._lock:
            # pin the adapter row first: an unknown id is the typed 4xx
            # (UnknownAdapterError, a ValueError) and does not count as
            # a submission
            if adapter_id:
                self.adapters.acquire(adapter_id)
            self.metrics.submitted += 1
            if len(self._queue) >= self.config.max_queue:
                self.metrics.shed += 1
                if adapter_id:   # a shed request pins nothing
                    self.adapters.release(adapter_id)
                req.state = "shed"
                shed_depth = len(self._queue)
                queued_depth = None
            else:
                req.metrics.mark_submitted()
                self._queue.append(req)
                self.metrics.queue_depth = queued_depth = \
                    len(self._queue)
        # journal + hooks OUTSIDE the lock
        if queued_depth is not None:
            if rlog is not None:
                rlog.event("queued", request_id=req.request_id,
                           queue_depth=queued_depth)
            return req
        if rlog is not None:
            rlog.event("shed", request_id=req.request_id,
                       queue_depth=shed_depth)
        _watchdog.notify_overload(self.metrics.engine_label)
        p50 = self.metrics.queue_wait_p50()
        raise EngineOverloadError(
            f"admission queue full ({self.config.max_queue}); "
            "request shed",
            queue_depth=shed_depth, running=self.kv.active_count,
            retry_after_s=p50 if p50 is not None
            else DEFAULT_RETRY_AFTER_S)

    # -- drive loop ---------------------------------------------------------

    def _emit(self, event):
        req: GenerationRequest = event.request
        if req.state == "cancelled":
            # cancelled concurrently with the decode step that produced
            # this token: swallow the emission, the slot frees next step
            return
        req.tokens.append(event.token)
        req.metrics.mark_token()
        self.metrics.tokens_out += 1
        if event.finished:
            req.state = "finished"
            req.metrics.mark_finished()
            self.metrics.record(req.metrics)
            if req.adapter_id and self.adapters is not None:
                # terminal unpin: the row is LRU-evictable again (lock:
                # submit acquires from client threads)
                with self._lock:
                    self.adapters.release(req.adapter_id)
            rlog = _request_log.get_request_log()
            if rlog is not None:
                rlog.event(
                    "finished", request_id=req.request_id,
                    finish_reason="stop" if (req.eos_id is not None
                                             and event.token == req.eos_id)
                    else "length",
                    tokens=len(req.tokens))
        if req.on_token is not None:
            if _TRACER.enabled:
                with _TRACER.span("serving/on_token", "serving",
                                  {"request_id": req.request_id,
                                   "token": event.token,
                                   "finished": event.finished}):
                    req.on_token(req, event.token)
            else:
                req.on_token(req, event.token)

    def step(self) -> int:
        """Admit waiting requests into free slots, then run one decode
        pipeline tick: launch the next fused chunk dispatch and fan out
        the oldest completed one (with overlap on, the first tick of a
        burst only launches). Returns the number of tokens emitted; 0
        means idle OR a launch-only tick, so drive loops should key on
        queue/active state, not on the return value."""
        with trace_span("serving/engine_step", "serving"):
            return self._step_impl()

    def _step_impl(self) -> int:
        step_no = self._step_no
        self._step_no += 1
        tp = self._tick   # tick profiler (None = no clock reads here)
        if tp is not None:
            tp.start()
        if self.faults is not None:
            # counter already advanced: an injected exception fires once
            self.faults.begin_step(step_no)
        admitted = []
        with self._lock:
            # apply deferred cancels first (scheduler state is only ever
            # touched from the driver thread; cancel() just marks)
            for req in self._pending_cancels:
                if not self.scheduler.cancel(req):
                    # not in a slot: the request may be parked in the
                    # host swap pool — drop its record (its pages were
                    # freed at swap-out)
                    n = len(self._swapped)
                    self._swapped = [s for s in self._swapped
                                     if s.req is not req]
                    if len(self._swapped) != n:
                        self.metrics.swapped_slots = len(self._swapped)
            self._pending_cancels.clear()
        if tp is not None:
            tp.lap("bookkeeping")
        # resume-first: parked sequences have strict priority over new
        # admissions for freed pages and slots. FIFO scan — oldest
        # first, but a record that does not fit yet does not block a
        # later one that does.
        if self._swapped:
            for sw in list(self._swapped):
                if not self.scheduler.can_swap_in(sw):
                    continue
                t0 = time.perf_counter()
                slot = self.scheduler.swap_in(sw)
                assert slot is not None  # checked, same thread
                self._swapped.remove(sw)
                self.metrics.swap_ins += 1
                self.metrics.observe_swap("swap_in",
                                          time.perf_counter() - t0)
            self.metrics.swapped_slots = len(self._swapped)
        with self._lock:
            limit = self.config.max_admits_per_step
            can_take = self.kv.free_count
            if limit is not None:
                can_take = min(can_take, limit)
            while self._queue and len(admitted) < can_take:
                admitted.append(self._queue.pop(0))
            self.metrics.queue_depth = len(self._queue)
        emitted = 0
        for i, req in enumerate(admitted):
            with self._lock:
                if req.state != "queued":
                    # cancelled while popped out of the queue
                    continue
            # pages-aware admission: head-of-line requests that don't
            # fit go back to the FRONT of the queue (FIFO preserved; a
            # later retirement frees their pages)
            if not self._admission_feasible(req, step_no):
                with self._lock:
                    self._queue[:0] = [r for r in admitted[i:]
                                       if r.state == "queued"]
                    self.metrics.queue_depth = len(self._queue)
                break
            with self._lock:
                if req.state != "queued":
                    continue
                req.state = "running"
            # stamp BEFORE the prefill dispatch: queue_wait is time spent
            # waiting for a slot, not prefill latency
            req.metrics.mark_admitted()
            self.metrics.admitted += 1
            self.metrics.prefills += 1
            rlog = _request_log.get_request_log()
            if rlog is not None:
                rlog.event("admitted", request_id=req.request_id,
                           queue_wait_s=req.metrics.queue_wait,
                           adapter_id=req.adapter_id)
            if _TRACER.enabled and req._submit_ns is not None:
                _TRACER.record_complete(
                    "serving/queue_wait", req._submit_ns,
                    time.monotonic_ns(), "serving",
                    {"request_id": req.request_id})
            with request_scope(req.request_id):
                event = self.scheduler.admit(
                    req, req.prompt, req.max_new_tokens,
                    temperature=req.temperature, seed=req.seed,
                    eos_id=req.eos_id, adapter_id=req.adapter_id)
                assert event is not None  # can_admit checked, same thread
                if event is not PREFILL_PENDING:
                    self._emit(event)
                    emitted += 1
        if tp is not None:
            tp.lap("admit")
        # chunked prefill: at most one prefill token budget, ordered
        # before this tick's decode dispatch
        for event in self.scheduler.advance_prefill():
            self._emit(event)
            emitted += 1
        if tp is not None:
            tp.lap("prefill_chunk")
        events = self.scheduler.step()
        if tp is not None:
            tp.lap("bookkeeping")
        if events:
            self.metrics.decode_steps += 1
            self.metrics.observe_dispatch_tokens(len(events))
        for event in events:
            self._emit(event)
            emitted += 1
        if tp is not None:
            tp.lap("stream")
        if self.scheduler.speculate_k:
            # speculation telemetry: the scheduler's cumulative totals
            # are the registry's truth, and each live verify pass feeds
            # one accepted-run sample into the histogram
            self.metrics.spec_proposed = self.scheduler.spec_proposed
            self.metrics.spec_accepted = self.scheduler.spec_accepted
            for run in self.scheduler.drain_spec_samples():
                self.metrics.observe_spec_run(run)
        self.metrics.active_slots = self.kv.active_count
        self.metrics.swapped_slots = len(self._swapped)
        self.metrics.kv_blocks_used = self.kv.blocks_used
        self.metrics.kv_blocks_cached = self.kv.blocks_cached
        self.metrics.prefix_cache_hits = self.kv.prefix_hits
        self.metrics.prefix_cache_misses = self.kv.prefix_misses
        # constant geometry refreshed too, so a replaced metrics
        # instance heals on the next step
        self._sync_geometry_gauges()
        if tp is not None:
            tp.lap("bookkeeping")
            self._finish_tick(step_no, emitted)
        return emitted

    def _admission_feasible(self, req, step_no: int) -> bool:
        """Can `req` take a slot + pages RIGHT NOW? Applies, in order:
        injected page shortages (requeue, never preempt — a forced
        shortage simulates transient pressure), the swap-pool page
        reservation (parked sequences have strict priority over new
        admissions for freed pages), the real allocator check, and
        finally — preemption on, nothing already parked — eviction of
        running sequences until the admission fits."""
        if self.faults is not None and self.faults.deny_pages(step_no):
            return False
        if self._swapped:
            # reserve the parked sequences' blocks against what this
            # admission would actually consume (prefix hits on live
            # blocks are free)
            reserved = sum(s.n_blocks for s in self._swapped)
            need = self.kv.blocks_needed(
                req.prompt, req.prompt.size + req.max_new_tokens,
                adapter_id=req.adapter_id)
            if self.kv.blocks_available < reserved + need:
                return False
        if self.scheduler.can_admit(req.prompt, req.max_new_tokens,
                                    adapter_id=req.adapter_id):
            return True
        if not self.config.preempt or self._swapped:
            # preempting while sequences already wait in the swap pool
            # would ping-pong residents: pressure with a non-empty pool
            # always queues
            return False
        while not self.scheduler.can_admit(req.prompt,
                                           req.max_new_tokens,
                                           adapter_id=req.adapter_id):
            if not self._preempt_once(req):
                return False
        return True

    def _preempt_once(self, req) -> bool:
        """Evict one policy-chosen RUNNING sequence to the host swap
        pool. Returns True when admission should be re-checked: either
        a victim moved out, or the fence's collected retirements already
        freed the pages."""
        if self.scheduler.active_count == 0:
            return False
        # swap_out needs an empty pipeline; the fence's tokens fan out
        # NOW (and may retire slots — re-check before evicting)
        self._fence()
        if self.scheduler.can_admit(req.prompt, req.max_new_tokens,
                                    adapter_id=req.adapter_id):
            return True
        slot = self.scheduler.pick_victim(self.config.preempt_policy)
        if slot is None:
            return False
        t0 = time.perf_counter()
        sw = self.scheduler.swap_out(slot)
        self._swapped.append(sw)
        self.metrics.preemptions += 1
        self.metrics.observe_swap("swap_out", time.perf_counter() - t0)
        self.metrics.swapped_slots = len(self._swapped)
        return True

    def _fence(self) -> None:
        """Drain the overlap pipeline and fan its tokens out NOW — the
        precondition for swap_out/migrate_out (a block in flight could
        still carry the victim's tokens). Per-dispatch batches feed the
        same decode_steps / tokens-per-dispatch telemetry step() does."""
        for batch in self.scheduler._sync_batches():
            if batch:
                self.metrics.decode_steps += 1
                self.metrics.observe_dispatch_tokens(len(batch))
            for event in batch:
                self._emit(event)

    @property
    def swapped_count(self) -> int:
        """Preempted sequences currently parked in the host swap pool
        (they still owe tokens: drain loops count them as work)."""
        return len(self._swapped)

    @property
    def mesh_shape(self):
        """This engine's serving mesh geometry: (1,), one card."""
        return self.kv.mesh_shape

    # -- cross-replica migration ---------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Flag the engine as draining: from here on migrate_out and
        migrate_in REFUSE with MigrationError — a sequence handed off
        during drain could never resume. Stepping, run_until_drained
        and swap-in of parked sequences go on. Idempotent."""
        self._draining = True

    def migrate_out(self, request) -> "Any":
        """Extract one RUNNING or PARKED sequence into a portable
        MigrationTicket: fence the pipeline (its tokens fan out
        normally), copy the sequence's KV blocks + decode carry to the
        host through the swap-out path, free its pages and slot, and
        detach the stream (the GenerationRequest left behind goes
        state="migrated" and never emits again). `request` is a
        GenerationRequest or its request_id. DRIVER-THREAD ONLY.

        Raises MigrationError, with the sequence left where it was, when
        the engine is draining, when the request is not running or
        parked here, or when the fence finishes it first. An injected
        extract-phase fault fires after the fence and before any state
        moves."""
        from .migration import MigrationError, MigrationTicket

        if self._draining:
            raise MigrationError(
                "engine is draining; migrate_out refused — the drain "
                "loop finishes residents in place")
        rid = request if isinstance(request, str) \
            else getattr(request, "request_id", None)
        rlog = _request_log.get_request_log()
        # parked first: a swap-pool record is already on the host — the
        # handoff is a pure host-side wrap, no fence, no device call
        for sw in self._swapped:
            if getattr(sw.req, "request_id", None) == rid:
                if sw.req.state != "running":
                    raise MigrationError(
                        f"request {rid} is {sw.req.state}, not "
                        "migratable")
                if self.faults is not None:
                    self.faults.migration_phase("extract")
                self._swapped.remove(sw)
                self.metrics.swapped_slots = len(self._swapped)
                sw.req.state = "migrated"
                ticket = MigrationTicket.from_swapped(
                    sw, self.kv.block_size, mesh_shape=self.mesh_shape,
                    adapter_digest=self._adapter_digest_for(sw))
                self._release_migrated(sw)
                if rlog is not None:
                    rlog.event("migrate_out", request_id=rid,
                               replica=self.metrics.engine_label,
                               phase="parked", blocks=ticket.n_blocks,
                               bytes=ticket.swap_bytes,
                               produced=ticket.produced,
                               adapter_id=ticket.adapter_id)
                return ticket

        # mid-chunked-prefill: the fill cursor is not ticketable — a
        # typed refusal; the sequence migrates once its first token
        # lands
        for pf in self.scheduler._prefilling.values():
            if getattr(pf.req, "request_id", None) == rid:
                raise MigrationError(
                    f"request {rid} is mid-prefill (chunked-prefill "
                    "cursor not yet ticketable); migrate_out refused — "
                    "retry after its first token")

        def _find_slot():
            return next(
                (s for s, st in self.scheduler._running.items()
                 if getattr(st.req, "request_id", None) == rid
                 and st.req.state == "running"), None)

        if _find_slot() is None:
            raise MigrationError(
                f"request {rid} is not running or parked on this "
                "engine (queued requests re-route without a ticket)")
        # fence BEFORE extraction: in-flight blocks may still carry the
        # sequence's tokens; they stream to the client normally
        self._fence()
        if self.faults is not None:
            self.faults.migration_phase("extract")
        slot = _find_slot()
        if slot is None:
            raise MigrationError(
                f"request {rid} finished during the migration fence")
        # journal=False: a handoff, not page pressure
        sw = self.scheduler.swap_out(slot, journal=False)
        sw.req.state = "migrated"
        ticket = MigrationTicket.from_swapped(
            sw, self.kv.block_size, mesh_shape=self.mesh_shape,
            adapter_digest=self._adapter_digest_for(sw))
        self._release_migrated(sw)
        if rlog is not None:
            rlog.event("migrate_out", request_id=rid,
                       replica=self.metrics.engine_label,
                       phase="running", blocks=ticket.n_blocks,
                       bytes=ticket.swap_bytes,
                       produced=ticket.produced,
                       adapter_id=ticket.adapter_id)
        return ticket

    def _adapter_digest_for(self, sw) -> bytes:
        """The content digest a migration ticket commits for the
        sequence's adapter (b"" for the base identity or an adapterless
        engine), read before the pin is released."""
        aid = getattr(sw, "adapter_id", 0)
        if not aid or self.adapters is None:
            return b""
        return self.adapters.digest_of(aid)

    def _release_migrated(self, sw) -> None:
        """Drop the departing sequence's adapter pin: the ticket carries
        (id, digest) and the target acquires it on adoption."""
        aid = getattr(sw, "adapter_id", 0)
        if aid and self.adapters is not None:
            with self._lock:
                self.adapters.release(aid)

    def migrate_in(self, ticket, on_token: Optional[Callable] = None
                   ) -> GenerationRequest:
        """Adopt a migrated sequence: validate the ticket (checksum +
        geometry — TicketError rejects it whole, nothing mutated), mint
        a fresh GenerationRequest continuing the SAME client stream
        (emitted prefix pre-loaded, so budget math and finish_reason
        land on the token a never-migrated run would), and park the
        sequence in the host swap pool, whose resume-first rule gives it
        strict priority over new admissions. The restored key row
        continues the per-token split chain, so the resumed stream is
        bit-identical wherever it lands. DRIVER-THREAD ONLY. Raises
        MigrationError while draining; an injected adopt-phase fault
        fires before any state changes."""
        from .migration import MigrationError

        if self._draining:
            raise MigrationError(
                "engine is draining; migrate_in refused — not adopting "
                "new residents")
        if self.faults is not None:
            self.faults.migration_phase("adopt")
        # a ticket whose KV dtype, scale plane, adapter (id and content
        # digest) or drafter rows do not fit this engine fails here
        # (TicketError), nothing mutated
        ticket.validate_for(self)
        aid = getattr(ticket, "adapter_id", 0)
        if aid:
            # validate_for proved residency and the digest; pin the row
            # for the adopted request's life, as submit does
            with self._lock:
                self.adapters.acquire(aid)
        req = GenerationRequest(
            ticket.prompt, ticket.max_new, ticket.temperature,
            ticket.seed, ticket.eos_id, on_token, self.config.clock,
            request_id=f"{self.metrics.engine_label}-"
                       f"{next(self._rid_counter)}",
            adapter_id=aid)
        req.tokens = list(ticket.tokens)
        req.state = "running"
        # adoption stamps: queue_wait/ttft here measure the handoff-to-
        # next-token gap; client-facing SLO cuts live on the router's
        # StreamHandle and span the whole migration
        req.metrics.mark_submitted()
        req.metrics.mark_admitted()
        self._swapped.append(ticket.to_swapped(req))
        self.metrics.swapped_slots = len(self._swapped)
        rlog = _request_log.get_request_log()
        if rlog is not None:
            rlog.event("migrate_in", request_id=req.request_id,
                       replica=self.metrics.engine_label,
                       rerouted_from=ticket.request_id,
                       bytes=ticket.swap_bytes,
                       produced=ticket.produced, adapter_id=aid)
        return req

    def _on_dispatch_launched(self) -> None:
        self.metrics.dispatches += 1

    def _on_prefill_chunk(self, seconds: float) -> None:
        self.metrics.prefill_chunks += 1
        self.metrics.observe_prefill_chunk(seconds)

    def _on_dispatch_timed(self, host_s: float, device_s: float) -> None:
        self.metrics.observe_dispatch_split(host_s, device_s)

    def _on_compile(self, family: str, seconds: float) -> None:
        self.metrics.observe_compile(family, seconds)

    @property
    def compile_journal(self):
        """The executable cost & compile journal (CompileJournal), or
        None unless ServingConfig(tick_profile=True)."""
        return self.scheduler.compile_journal

    def _tick_records(self) -> List[Dict[str, Any]]:
        """The /tickz perf-source provider: the bounded per-tick flight
        ring, oldest first (empty unless tick_profile)."""
        return list(self._tick_ring) if self._tick_ring is not None \
            else []

    tick_records = _tick_records

    def _compile_snapshot(self) -> Dict[str, Any]:
        """The /compilez perf-source provider: the journal's per-family
        attribution table plus the compile-event records."""
        journal = self.scheduler.compile_journal
        if journal is None:
            return {"families": {}, "records": []}
        snap = journal.snapshot()
        snap["records"] = list(journal.records)
        return snap

    def _finish_tick(self, step_no: int, emitted: int) -> None:
        """Publish one completed tick: per-phase histogram samples, a
        flight-ring record and the journal-derived gauges."""
        phases = self._tick.phases
        wall = 0.0
        for phase in _TICK_PHASES:
            seconds = phases[phase]
            wall += seconds
            self.metrics.observe_tick_phase(phase, seconds)
        self._tick_ring.append({
            "step": step_no, "t_mono": time.monotonic(),
            "wall_s": wall, "phases": dict(phases),
            "emitted": emitted, "active": self.kv.active_count,
            "queue": len(self._queue)})
        journal = self.scheduler.compile_journal
        if journal is not None:
            self.metrics.set_perf_gauges(journal.mfu_proxy(),
                                         journal.dispatch_hbm_bytes())
        if _TRACER.enabled:
            _TRACER.record_partition(
                "serving/tick", time.monotonic_ns(),
                [(phase, phases[phase]) for phase in _TICK_PHASES],
                "serving", {"step": step_no, "emitted": emitted})

    def run_until_drained(self, max_steps: Optional[int] = None) -> int:
        """Step until queue, slots and swap pool are empty; returns
        steps taken."""
        steps = 0
        while (self._queue or self.scheduler.active_count
               or self._swapped):
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return steps

    def generate(self, prompts: Sequence, max_new_tokens: int,
                 **kw) -> List[np.ndarray]:
        """Convenience batch call: submit + drive interleaved (steps the
        engine whenever the admission queue is full, so prompt lists
        longer than max_queue flow through instead of shedding), then
        drain. Returns each prompt's full (prompt + generated) array."""
        reqs = []
        for p in prompts:
            while len(self._queue) >= self.config.max_queue:
                self.step()
            reqs.append(self.submit(p, max_new_tokens, **kw))
        self.run_until_drained()
        return [r.output() for r in reqs]

    def cancel(self, req: GenerationRequest) -> bool:
        """Abandon a request (client disconnect): drop it from the queue,
        or mark a running request for the DRIVER thread to free at the
        start of its next step() — scheduler state is never touched from
        the calling thread."""
        cancelled_from = None
        with self._lock:
            if req.state == "queued":
                if req in self._queue:
                    self._queue.remove(req)
                    self.metrics.queue_depth = len(self._queue)
                req.state = "cancelled"
                cancelled_from = "queued"
            elif req.state == "running":
                req.state = "cancelled"
                self._pending_cancels.append(req)
                cancelled_from = "running"
            if cancelled_from is not None and req.adapter_id \
                    and self.adapters is not None:
                # terminal unpin (a cancelled request's emissions are
                # swallowed, so a row reassigned before the stepping
                # thread frees the slot only feeds discarded tokens)
                self.adapters.release(req.adapter_id)
        if cancelled_from is None:
            return False
        rlog = _request_log.get_request_log()
        if rlog is not None:
            rlog.event("cancelled", request_id=req.request_id,
                       was=cancelled_from, tokens=len(req.tokens))
        return True

    # -- multi-tenant adapters ----------------------------------------------

    def _require_adapters(self):
        if self.adapters is None:
            raise ValueError(
                "this engine has no adapter pool "
                "(ServingConfig(max_adapters=..., adapter_rank=...))")
        return self.adapters

    def _sync_adapter_metrics(self) -> None:
        """Mirror the pool's host bookkeeping into the registry series."""
        pool = self.adapters
        self.metrics.adapters_resident = pool.resident_count
        self.metrics.adapter_pool_bytes = pool.pool_bytes
        self.metrics.adapter_uploads = pool.uploads_total
        self.metrics.adapter_evictions = pool.evictions_total

    def upload_adapter(self, adapter_id: int, weights) -> int:
        """Install a LoRA adapter's A/B stack under `adapter_id`,
        validating its geometry against the base model and LRU-evicting
        the oldest unreferenced resident under pressure. Returns the pool
        row claimed. Typed AdapterError subclasses (all ValueError) on bad
        geometry, a referenced id, or a pool with every row pinned. An
        indexed copy into the pool's tensors: the next dispatch reads
        it."""
        pool = self._require_adapters()
        with self._lock:
            row = pool.upload(adapter_id, weights)
            self._sync_adapter_metrics()
        rlog = _request_log.get_request_log()
        if rlog is not None:
            rlog.event("adapter_upload", engine=self.metrics.engine_label,
                       adapter_id=int(adapter_id), row=row,
                       resident=pool.resident_count)
        return row

    def evict_adapter(self, adapter_id: int) -> None:
        """Explicitly drop a resident adapter, freeing its pool row.
        AdapterReferencedError while any live request pins it;
        UnknownAdapterError if it is not resident."""
        pool = self._require_adapters()
        with self._lock:
            pool.evict(adapter_id)
            self._sync_adapter_metrics()
        rlog = _request_log.get_request_log()
        if rlog is not None:
            rlog.event("adapter_evict", engine=self.metrics.engine_label,
                       adapter_id=int(adapter_id),
                       resident=pool.resident_count)

    # -- observability ------------------------------------------------------

    def close(self) -> None:
        """Retire the engine: remove its labeled series from the global
        metrics registry so scrapes stop reporting a dead engine, drop
        its /tickz + /compilez providers, and release its debug-server
        reference (inference.create_engine(debug_port=...)) — the shared
        server stops only when the last referencing engine closes.
        stats()/metrics keep working locally afterwards."""
        self.metrics.unregister()
        if self._tick is not None:
            from ..observability import debug_server as _dbg
            _dbg.unregister_perf_source("tick",
                                        self.metrics.engine_label)
            _dbg.unregister_perf_source("compile",
                                        self.metrics.engine_label)
        if self._debug_server_ref is not None:
            from ..observability.debug_server import release_debug_server
            token, self._debug_server_ref = self._debug_server_ref, None
            release_debug_server(token)

    def stats(self) -> Dict[str, Any]:
        s = self.metrics.snapshot()
        s.update(self.kv.occupancy())
        s["queue_depth"] = len(self._queue)
        s["weight_dtype"] = self._weight_dtype
        s["weight_bytes"] = self.weight_bytes
        # host memory the swap pool pins (0 when nothing is parked)
        s["swap_pool_bytes"] = sum(sw.swap_bytes for sw in self._swapped)
        # adapter pool occupancy: resident count, device bytes, uploads
        # and evictions
        if self.adapters is not None:
            s.update(self.adapters.occupancy())
        s["compiled_executables"] = self.scheduler.compile_count
        s["engine_label"] = self.metrics.engine_label
        return s
