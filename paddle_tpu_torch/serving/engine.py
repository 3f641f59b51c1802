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

The engine runs on its parameters' device (`inference.create_engine`
puts them on the card unless the Config says `disable_gpu()`).
`ServingConfig` keeps the JAX signature; each knob of a serving slice
not ported yet raises NotImplementedError at construction, naming its
ROADMAP item, and nothing falls back to another path.
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

    Not ported yet, each raising NotImplementedError when set:
    preempt/preempt_policy (ROADMAP A.1.2), speculate_k/speculate_ngram
    (A.1.3), weight_dtype/kv_dtype (A.1.4), max_adapters/adapter_rank
    (A.1.5), mesh_shape (A.8)."""

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
        for knob, set_, item in (
                ("preempt=True", preempt, "A.1.2"),
                (f"preempt_policy={preempt_policy!r}",
                 preempt_policy != "newest", "A.1.2"),
                (f"speculate_k={speculate_k}", speculate_k, "A.1.3"),
                (f"speculate_ngram={speculate_ngram}",
                 speculate_ngram != 512, "A.1.3"),
                (f"weight_dtype={weight_dtype!r}",
                 weight_dtype is not None, "A.1.4"),
                (f"kv_dtype={kv_dtype!r}", kv_dtype is not None, "A.1.4"),
                (f"max_adapters={max_adapters!r}",
                 max_adapters is not None, "A.1.5"),
                (f"adapter_rank={adapter_rank!r}",
                 adapter_rank is not None, "A.1.5"),
                (f"mesh_shape={mesh_shape!r}", mesh_shape is not None,
                 "A.8")):
            if set_:
                raise _not_ported(knob, item)
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
                 request_id: Optional[str] = None):
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
        self.weight_bytes = int(sum(t.numel() * t.element_size()
                                    for t in _gd.param_tensors(params)))
        self._weight_dtype = str(params["wte"].dtype).replace("torch.", "")
        self.kv = SlotKVCache(cfg, serving.num_slots, max_len,
                              _gd.compute_dtype(params),
                              block_size=serving.block_size,
                              num_blocks=serving.kv_blocks,
                              prefix_cache=serving.prefix_cache,
                              device=self.device)
        self.scheduler = ContinuousBatchingScheduler(
            params, cfg, self.kv, self.buckets, top_k=serving.top_k,
            decode_chunk=serving.decode_chunk, overlap=serving.overlap,
            prefill_chunk=serving.prefill_chunk)
        self.scheduler.on_prefill_chunk = self._on_prefill_chunk
        # launch-side heartbeat: bumped at dispatch ENQUEUE inside the
        # scheduler, so a device hang with the host blocked in the next
        # read still shows the last launch that went in
        self.scheduler.on_launch = self._on_dispatch_launched
        self.metrics = EngineMetrics(
            max_tokens_per_dispatch=(serving.num_slots
                                     * serving.decode_chunk),
            dispatch_timing=serving.dispatch_timing,
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
        self._sync_geometry_gauges()
        self._queue: List[GenerationRequest] = []
        self._pending_cancels: List[GenerationRequest] = []
        self.faults = serving.fault_plan
        self._step_no = 0
        self._lock = threading.Lock()
        self._rid_counter = itertools.count()

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

    # -- admission ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               seed: int = 0, eos_id: Optional[int] = None,
               on_token: Optional[Callable] = None,
               adapter_id: int = 0) -> GenerationRequest:
        """Enqueue one generate request. Raises ValueError for requests
        that can never be served (too long for the buckets/pool, an
        adapter id on this adapterless engine) and EngineOverloadError
        when the queue is full (backpressure: nothing queues
        unboundedly)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if int(adapter_id):
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
                       f"{next(self._rid_counter)}")
        if _TRACER.enabled:  # queue-wait anchor; no clock read when off
            req._submit_ns = time.monotonic_ns()
        rlog = _request_log.get_request_log()
        if rlog is not None:
            rlog.event("submitted", request_id=req.request_id,
                       engine=self.metrics.engine_label,
                       prompt_len=int(prompt.size),
                       max_new=int(max_new_tokens), adapter_id=0)
        with self._lock:
            self.metrics.submitted += 1
            if len(self._queue) >= self.config.max_queue:
                self.metrics.shed += 1
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
                self.scheduler.cancel(req)
            self._pending_cancels.clear()
        if tp is not None:
            tp.lap("bookkeeping")
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
                           adapter_id=0)
            if _TRACER.enabled and req._submit_ns is not None:
                _TRACER.record_complete(
                    "serving/queue_wait", req._submit_ns,
                    time.monotonic_ns(), "serving",
                    {"request_id": req.request_id})
            with request_scope(req.request_id):
                event = self.scheduler.admit(
                    req, req.prompt, req.max_new_tokens,
                    temperature=req.temperature, seed=req.seed,
                    eos_id=req.eos_id)
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
        self.metrics.active_slots = self.kv.active_count
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
        """Can `req` take a slot + pages RIGHT NOW? Injected page
        shortages first (requeue), then the real allocator check."""
        if self.faults is not None and self.faults.deny_pages(step_no):
            return False
        return self.scheduler.can_admit(req.prompt, req.max_new_tokens)

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

    def tick_records(self) -> List[Dict[str, Any]]:
        """The bounded per-tick flight ring, oldest first (empty unless
        tick_profile)."""
        return list(self._tick_ring) if self._tick_ring is not None \
            else []

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
        """Step until queue and slots are empty; returns steps taken."""
        steps = 0
        while self._queue or self.scheduler.active_count:
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
        if cancelled_from is None:
            return False
        rlog = _request_log.get_request_log()
        if rlog is not None:
            rlog.event("cancelled", request_id=req.request_id,
                       was=cancelled_from, tokens=len(req.tokens))
        return True

    # -- observability ------------------------------------------------------

    def close(self) -> None:
        """Retire the engine: remove its labeled series from the global
        metrics registry so scrapes stop reporting a dead engine.
        stats()/metrics keep working locally afterwards."""
        self.metrics.unregister()

    def stats(self) -> Dict[str, Any]:
        s = self.metrics.snapshot()
        s.update(self.kv.occupancy())
        s["queue_depth"] = len(self._queue)
        s["weight_dtype"] = self._weight_dtype
        s["weight_bytes"] = self.weight_bytes
        s["compiled_executables"] = self.scheduler.compile_count
        s["engine_label"] = self.metrics.engine_label
        return s
