"""Continuous-batching step loop over the PAGED KV pool.

Port of `paddle_tpu/serving/scheduler.py`. Orca/vLLM-style
iteration-level scheduling on top of gpt_decode's prefill/step split:
the scheduler keeps ONE batched decode dispatch hot over all slots and
admits new requests into free slots between dispatches:

    admit:  map exactly the PAGES the request needs (prompt + budget)
            into the slot's page-table row — leading prompt blocks that
            hash-hit the prefix cache are shared in, refcounted, instead
            of recomputed — then gpt_prefill_pages the remaining SUFFIX
            (padded to a shape bucket) into the fresh blocks and sample
            the first token from the last-position logits.
    step:   gpt_decode_chunk_pages over the WHOLE pool — `decode_chunk`
            decode iterations (fixed batch = num_slots, per-slot
            positions through the page table, sampling + EOS/budget
            masking on the device) per dispatch, returning a (chunk,
            slots) token block in one fetch.
    retire: finished sequences freeze on the device (the chunk loop's
            done mask, which also redirects their ride-along K/V writes
            to the scratch block) and just free their pages host-side;
            the batch never stalls.

The JAX engine's jitted families become plain callables here. A
"compile" event is a family's first call at a new shape key (the family
tags carry the shape: `prefill:L<bucket>`, `prefill_chunk:L<bucket>`,
`admit_sample`, `decode_chunk`, `release_slot`), so `compile_count` and
`compile_events` keep their meaning: len(prefill buckets) + 1 chunk loop
+ 1 admission sampler (+ 1 release on the first cancel).

Decode fast path:

  * IN-PLACE STATE — the block arena, the device page table, the
    per-slot sampler keys and the device-resident decode carry (current
    token, position, done, remaining budget, temperature, eos id, all
    per slot) live on the device between dispatches and are updated in
    place (the JAX engine donates them), never copied.
  * FUSED MULTI-TOKEN DECODE — one dispatch queues `decode_chunk`
    iterations with no host read inside, amortising the Python +
    launch + sync cost of fetching tokens by the chunk factor.
  * OVERLAPPED PIPELINE — `_launch` queues the chunk on the card,
    starts a non_blocking copy of its token block into pinned host
    memory and records a CUDA event; `_collect` waits on that event.
    With overlap on, dispatch k+1 is queued BEFORE dispatch k's block is
    read, so host post-processing (event fan-out, slot retire,
    admissions between chunks) runs while the card computes. On the CPU
    every op is synchronous and the copy is the block itself.

Greedy sequences reproduce the sequential `gpt_generate` path token for
token. Sampled sequences (temperature > 0) use the per-slot threefry2x32
Gumbel-max sampler (gpt_decode.make_sampler) keyed from the request
seed, one key split per decode iteration, frozen slots included: a
request's seeded stream is a pure function of (params, prompt, seed,
chain position), invariant to chunk size, slot placement, admission
timing and co-batched load, and bit-equal to the JAX engine's wherever
the logits agree.

CHUNKED PREFILL (prefill_chunk=N, None = monolithic): admission maps
pages as usual but the prompt suffix runs as a sequence of
budget-bounded chunk dispatches (gpt_prefill_chunk_pages, shapes from
the same suffix buckets), at most N prefill tokens per engine tick,
interleaved with the decode dispatches; the slot rides the decode loop
frozen meanwhile. Prefix-cache registration is deferred per block until
the chunk that fills it has been queued.

Not ported yet (ROADMAP A.1): speculative decoding, host-swap
preemption and migration (`sync`, `pick_victim`, `swap_out`,
`swap_in`, `SwappedSequence`), adapters and the tensor-parallel mesh.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import profiler
from ..models import gpt_decode as gd
from ..observability import request_log as _request_log
from ..observability.tracer import get_tracer
from .kv_cache import ShapeBuckets, SlotKVCache

_TRACER = get_tracer()

__all__ = ["CompileJournal", "ContinuousBatchingScheduler",
           "SequenceEvent", "PREFILL_PENDING"]

# admit()'s "admission succeeded, first token pending" sentinel
# (chunked prefill only): pages are mapped and the slot is prefilling,
# but the first-token event will surface from a later advance_prefill
# tick. Distinct from None, which still means "no slot/pages right now".
PREFILL_PENDING = object()


class SequenceEvent(NamedTuple):
    """One emitted token: (opaque request object, token id, finished)."""
    request: Any
    token: int
    finished: bool


class _Running:
    """Host-side state of the sequence occupying one slot. Only what the
    block walk needs lives here — the decode feed itself (current token,
    position, temperature, remaining budget) is device-resident carry,
    reset at admission."""

    __slots__ = ("req", "pos", "produced", "max_new", "eos_id",
                 "live_from", "seq")

    def __init__(self, req, pos, max_new, eos_id, live_from, seq=0):
        self.req = req
        self.pos = pos                    # absolute position fed next
        self.produced = 1                 # prefill already sampled one
        self.max_new = max_new
        self.eos_id = eos_id
        self.live_from = live_from        # first dispatch carrying tokens
        self.seq = seq                    # admission order


class _Prefill:
    """Host-side state of a slot mid-CHUNKED-PREFILL: pages are mapped,
    zero or more budget-bounded chunks have been dispatched, and the
    first token has not been sampled yet. `cursor` counts suffix tokens
    whose filling chunk is already queued; the next chunk starts at
    absolute position start + cursor."""

    __slots__ = ("req", "suffix", "start", "cursor", "p_len", "max_new",
                 "temperature", "seed", "eos_id", "pages", "seq",
                 "chunk_index")

    def __init__(self, req, suffix, start, p_len, max_new, temperature,
                 seed, eos_id, pages, seq):
        self.req = req
        self.suffix = suffix              # (suffix_len,) int32 host copy
        self.start = start                # pfx_len at admission
        self.cursor = 0                   # suffix tokens queued so far
        self.p_len = p_len
        self.max_new = max_new
        self.temperature = temperature
        self.seed = seed
        self.eos_id = eos_id
        self.pages = pages                # (max_pages,) page row
        self.seq = seq                    # admission order
        self.chunk_index = 0              # next chunk's journal index


# nominal single-card peak used by the MFU proxy when the operator
# hasn't told us the real one (PT_SERVING_PEAK_FLOPS): the gauge is a
# trend line, not an absolute utilization claim
_NOMINAL_PEAK_FLOPS = 1e12


class CompileJournal:
    """Executable cost & compile journal (ServingConfig(tick_profile=
    True) only — the engine installs one on the scheduler's
    `compile_journal` attribute; the None default is the bare path).
    Every family call flows through _call, which feeds this journal:
    per-family call counts and, on a family's first call at a shape,
    its wall seconds. A copy of the JAX journal; the port has no static
    cost analysis (see _cost_probe), so per-family FLOPs and bytes stay
    None and `mfu_proxy()` / `dispatch_hbm_bytes()` return None.

    Families are the scheduler's compile-event tags (prefill:L<bucket>,
    prefill_chunk:L<bucket>, admit_sample, decode_chunk, release_slot)
    — the same strings compile_events holds."""

    def __init__(self, clock=time.monotonic, peak_flops=None):
        if peak_flops is None:
            try:
                peak_flops = float(
                    os.environ.get("PT_SERVING_PEAK_FLOPS") or 0) or None
            except ValueError:
                peak_flops = None
        self.peak_flops = float(peak_flops if peak_flops
                                else _NOMINAL_PEAK_FLOPS)
        self._clock = clock
        self._t0 = clock()
        # one record per compile event, in dispatch order
        self.records: List[Dict[str, Any]] = []
        # family -> {calls, compiles, compile_s, flops, bytes_accessed}
        self.families: Dict[str, Dict[str, Any]] = {}
        # fired (family, compile seconds) per compile event
        self.on_compile = None

    def note_call(self, family: str, seconds: float, compiled: bool,
                  cost: Optional[Dict[str, float]]) -> None:
        fam = self.families.get(family)
        if fam is None:
            fam = self.families[family] = {
                "calls": 0, "compiles": 0, "compile_s": 0.0,
                "flops": None, "bytes_accessed": None}
        fam["calls"] += 1
        if not compiled:
            return
        fam["compiles"] += 1
        fam["compile_s"] += seconds
        flops = bytes_accessed = None
        if cost:
            flops = cost.get("flops")
            bytes_accessed = cost.get("bytes accessed")
        if flops is not None:
            fam["flops"] = float(flops)
        if bytes_accessed is not None:
            fam["bytes_accessed"] = float(bytes_accessed)
        self.records.append({
            "family": family, "compile_s": float(seconds),
            "flops": None if flops is None else float(flops),
            "bytes_accessed": (None if bytes_accessed is None
                               else float(bytes_accessed)),
            "t_mono": self._clock()})
        if self.on_compile is not None:
            self.on_compile(family, seconds)

    def mfu_proxy(self) -> Optional[float]:
        """FLOPs issued per second over the journal's lifetime, as a
        fraction of peak_flops. None until a family has a known cost."""
        elapsed = self._clock() - self._t0
        if elapsed <= 0:
            return None
        issued = 0.0
        known = False
        for fam in self.families.values():
            if fam["flops"] is not None:
                issued += fam["calls"] * fam["flops"]
                known = True
        if not known:
            return None
        return issued / elapsed / self.peak_flops

    def dispatch_hbm_bytes(self) -> Optional[float]:
        """Bytes accessed per decode dispatch; None while unknown."""
        fam = self.families.get("decode_chunk")
        if fam is None:
            return None
        return fam["bytes_accessed"]

    def snapshot(self) -> Dict[str, Any]:
        """Per-family attribution (count/cost/share of compile seconds)
        plus the derived gauges."""
        total_s = sum(f["compile_s"] for f in self.families.values())
        families = {}
        for name in sorted(self.families):
            fam = dict(self.families[name])
            fam["compile_share"] = (fam["compile_s"] / total_s
                                    if total_s > 0 else 0.0)
            families[name] = fam
        return {"families": families,
                "compiles_total": len(self.records),
                "compile_seconds_total": total_s,
                "peak_flops": self.peak_flops,
                "mfu_proxy": self.mfu_proxy(),
                "dispatch_hbm_bytes": self.dispatch_hbm_bytes()}


class _Inflight(NamedTuple):
    """One launched-but-unread chunk dispatch."""
    host: Any           # (chunk, S) int64 token block on the host: pinned
    #                     memory a non_blocking copy fills (CUDA), or the
    #                     block itself (CPU)
    event: Any          # CUDA event recorded after the copy, or None
    index: int          # dispatch index at launch (matches live_from)
    size: int           # chunk length
    begin_ns: int       # launch stamp; 0 = tracing was off at launch
    host_s: float = 0.0  # launch-side host seconds (dispatch_timing on)


class ContinuousBatchingScheduler:
    """Owns the device state (block arena, page table, per-slot sampler
    keys, decode carry) and the family callables; the engine above it
    owns queues and lifecycle."""

    def __init__(self, params, cfg, kv: SlotKVCache, buckets: ShapeBuckets,
                 top_k: int = 0, decode_chunk: int = 8,
                 overlap: bool = True,
                 prefill_chunk: Optional[int] = None):
        if int(decode_chunk) < 1:
            raise ValueError(
                f"decode_chunk must be >= 1, got {decode_chunk}")
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 or None, got {prefill_chunk}")
        self.params = params
        self.cfg = cfg
        self.kv = kv
        self.buckets = buckets
        self.top_k = int(top_k)
        self.decode_chunk = int(decode_chunk)
        self.overlap = bool(overlap)
        # chunked prefill (None = monolithic): the per-tick prefill
        # token budget AND the per-dispatch chunk ceiling
        self.prefill_chunk = int(prefill_chunk) \
            if prefill_chunk is not None else None
        self.device = kv.kv.device
        self._sample = gd.make_sampler(self.top_k)
        # slots mid-chunked-prefill (slot -> _Prefill)
        self._prefilling: Dict[int, _Prefill] = {}
        # fired once per dispatched prefill chunk with its launch-side
        # wall seconds (serving_prefill_chunks + its histogram)
        self.on_prefill_chunk = None
        self._running: Dict[int, _Running] = {}
        self._compile_events: List[str] = []
        self._families: set = set()
        s_dim, dev = kv.num_slots, self.device
        # (S, 2) sampler keys (int64 holding uint32 values); every row
        # is re-seeded at admission, so zeros are fine here
        self._keys = torch.zeros((s_dim, 2), dtype=torch.int64, device=dev)
        # device-resident decode carry: (tokens, ts, done, remaining,
        # temps, eos_ids), all (S,), every slot frozen until admitted
        self._state = (torch.zeros((s_dim,), dtype=torch.int64, device=dev),
                       torch.zeros((s_dim,), dtype=torch.int64, device=dev),
                       torch.ones((s_dim,), dtype=torch.bool, device=dev),
                       torch.zeros((s_dim,), dtype=torch.int64, device=dev),
                       torch.zeros((s_dim,), dtype=torch.float32,
                                   device=dev),
                       torch.full((s_dim,), -1, dtype=torch.int64,
                                  device=dev))
        # device page table: every row scratch until its slot admits
        self._pt = torch.zeros((s_dim, kv.max_pages), dtype=torch.int64,
                               device=dev)
        self._admit_counter = 0           # admission order for _Running.seq
        self._inflight: List[_Inflight] = []
        self._launches = 0
        # fired inside _launch, right at enqueue (the engine's
        # dispatches heartbeat)
        self.on_launch = None
        # host/device dispatch split (off by default — the disabled
        # path reads no clock): _launch times the launch-side host
        # segment and _collect the wait for this dispatch's block, then
        # fires on_dispatch_timed(host_s, device_s)
        self.dispatch_timing = False
        self.on_dispatch_timed = None
        # deterministic fault injection (serving.faults.FaultPlan or
        # None): scheduled dispatch delays fire at the launch site
        self.faults = None
        # per-bucket host staging buffers, reused across admissions
        self._staging: Dict[int, np.ndarray] = {}
        # executable cost & compile journal (CompileJournal, installed
        # by the engine under ServingConfig(tick_profile=True))
        self.compile_journal = None
        # fired ("launch"|"collect", host seconds) around the two
        # step() segments when the engine's tick profiler is on
        self.on_tick_phase = None

    # -- families -------------------------------------------------------------

    def _prefill_family(self, tokens, pfx_len, real_len, pages, slot):
        pages = torch.as_tensor(pages, dtype=torch.int64,
                                device=self.device)
        logits, _ = gd.gpt_prefill_pages(
            self.params, self.cfg, tokens, pfx_len, real_len, self.kv.kv,
            pages)
        self._pt[slot] = pages
        return logits[0]

    def _prefill_chunk_family(self, tokens, start_pos, real_len, pages,
                              slot):
        # per-position math shared with _prefill_family; the page-row
        # install is idempotent across a prompt's chunks
        pages = torch.as_tensor(pages, dtype=torch.int64,
                                device=self.device)
        logits, _ = gd.gpt_prefill_chunk_pages(
            self.params, self.cfg, tokens, start_pos, real_len, self.kv.kv,
            pages)
        self._pt[slot] = pages
        return logits[0]

    def _admit_family(self, slot, seed, logits, temp, pos, max_new,
                      eos_id):
        tokens, ts, done, remaining, temps, eos_ids = self._state
        temps[slot] = temp
        eos_ids[slot] = eos_id
        self._keys[slot] = gd.sample_key(seed, self.device)
        first, key_next = self._sample(self._keys[slot:slot + 1],
                                       logits[None], temps[slot:slot + 1])
        first = first[0]
        self._keys[slot] = key_next[0]
        tokens[slot] = first
        ts[slot] = pos
        # finished-at-admission mirrors the host rule exactly so the
        # device-side done mask never disagrees with _running (sampled
        # ids are >= 0, so eos_id -1 never matches)
        done[slot] = (first == eos_id) | (max_new <= 1)
        remaining[slot] = max_new - 1
        return first

    def _chunk_family(self):
        tokens, ts, done, remaining, temps, eos_ids = self._state
        block, tokens, _, ts, self._keys, done, remaining = \
            gd.gpt_decode_chunk_pages(
                self.params, self.cfg, tokens, self.kv.kv, self._pt, ts,
                self._keys, temps, done, remaining, eos_ids,
                self.decode_chunk, sample_fn=self._sample)
        self._state = (tokens, ts, done, remaining, temps, eos_ids)
        return block

    def _release_family(self, slot):
        # cancel path: the host verdict the device's done mask can't
        # know — freeze the slot and point its page row at scratch so its
        # ride-along writes stop touching blocks admission may reallocate
        _tokens, _ts, done, remaining, _temps, _eos = self._state
        self._pt[slot] = 0
        done[slot] = True
        remaining[slot] = 0

    # -- compile-counter hook ----------------------------------------------

    def _call(self, family: str, fn, *args):
        """Run a family callable. Its first call at this family tag (the
        tags carry the shape) is a compile event. Without a journal (the
        default) no clock is read; with one, the call is timed and
        journaled under `family`."""
        compiled = family not in self._families
        if compiled:
            self._families.add(family)
            self._compile_events.append(family)
        journal = self.compile_journal
        if journal is None:
            with torch.no_grad():
                return fn(*args)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fn(*args)
        seconds = time.perf_counter() - t0
        cost = self._cost_probe(fn, args) if compiled else None
        journal.note_call(family, seconds, compiled, cost)
        return out

    def _cost_probe(self, fn, args) -> Optional[Dict[str, float]]:
        """Static cost of `fn` at these argument shapes. The JAX engine
        reads XLA's cost_analysis(); eager torch has no such analysis,
        so this returns None — the case the JAX journal already handles:
        the compile is recorded, and mfu_proxy() and
        dispatch_hbm_bytes() stay None."""
        return None

    @property
    def compile_count(self) -> int:
        return len(self._compile_events)

    @property
    def compile_events(self) -> Tuple[str, ...]:
        return tuple(self._compile_events)

    # -- lifecycle ----------------------------------------------------------

    @property
    def active_count(self) -> int:
        """Slots owing work: decoding sequences plus slots still
        mid-chunked-prefill (drain loops must count both)."""
        return len(self._running) + len(self._prefilling)

    @property
    def prefilling_count(self) -> int:
        """Slots currently mid-chunked-prefill (0 on a monolithic
        engine)."""
        return len(self._prefilling)

    @property
    def dispatch_count(self) -> int:
        """Chunk dispatches launched so far."""
        return self._launches

    @property
    def inflight_count(self) -> int:
        return len(self._inflight)

    def _staging_for(self, bucket: int) -> np.ndarray:
        buf = self._staging.get(bucket)
        if buf is None:
            buf = self._staging[bucket] = np.zeros((1, bucket), np.int64)
        return buf

    def can_admit(self, prompt: np.ndarray, max_new: int) -> bool:
        """True when admit() would succeed RIGHT NOW: a page-table row
        is free and the arena can supply the pages the request needs
        (prefix-cache hits counted, LRU blocks evictable)."""
        if self.kv.free_count < 1:
            return False
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        return self.kv.can_map(prompt, prompt.size + int(max_new))

    def admit(self, req, prompt: np.ndarray, max_new: int,
              temperature: float = 0.0, seed: int = 0,
              eos_id: Optional[int] = None) -> Optional[SequenceEvent]:
        """Claim a slot, map the pages the request needs (hash-hit
        prefix blocks shared in, refcounted), prefill the prompt SUFFIX
        into the fresh blocks (padded to its shape bucket), sample the
        first token, and reset the slot's entries in the device decode
        carry + page table. Returns the first-token event, or None when
        no slot is free OR the arena is out of pages.

        With a dispatch in flight, the prefill queues behind it on the
        device; the first-token read at the end waits for both.

        CHUNKED PREFILL (prefill_chunk set): pages are mapped as above,
        but no prefill dispatch runs here — the slot is registered as
        mid-prefill and PREFILL_PENDING is returned."""
        slot = self.kv.alloc()
        if slot is None:
            return None
        prompt = np.asarray(prompt, np.int32).reshape(1, -1)
        p_len = prompt.shape[1]
        mapped = self.kv.map_slot(slot, prompt[0], p_len + int(max_new),
                                  register=self.prefill_chunk is None)
        if mapped is None:
            self.kv.free(slot)           # page shortage: slot untouched
            return None
        pages, pfx_len = mapped
        if self.prefill_chunk is not None:
            self._prefilling[slot] = _Prefill(
                req, np.ascontiguousarray(prompt[0, pfx_len:]),
                int(pfx_len), p_len, int(max_new), float(temperature),
                int(seed), eos_id, pages, self._admit_counter)
            self._admit_counter += 1
            return PREFILL_PENDING
        suffix_len = p_len - pfx_len
        bucket = self.buckets.bucket_for(suffix_len)
        padded = self._staging_for(bucket)
        padded[0, :suffix_len] = prompt[0, pfx_len:]
        padded[0, suffix_len:] = 0
        with profiler.RecordEvent("serving/prefill", bucket=bucket,
                                  prompt_len=p_len, slot=slot,
                                  prefix_len=pfx_len,
                                  request_id=getattr(req, "request_id",
                                                     None)):
            logits = self._call(
                f"prefill:L{bucket}", self._prefill_family,
                padded, int(pfx_len), suffix_len, pages, slot)
        event = self._sample_first(
            slot, req, logits, p_len, max_new, temperature, seed,
            eos_id, self._admit_counter)
        self._admit_counter += 1
        rlog = _request_log.get_request_log()
        if rlog is not None:
            rlog.event("prefill",
                       request_id=getattr(req, "request_id", None),
                       slot=slot, bucket=bucket, prompt_len=p_len,
                       prefix_len=int(pfx_len), suffix_len=suffix_len)
        return event

    def _sample_first(self, slot, req, logits, p_len, max_new,
                      temperature, seed, eos_id, seq) -> SequenceEvent:
        """Sample the first token from last-position prefill logits and
        promote the slot to _running — the shared tail of monolithic
        admit() and the final prefill chunk."""
        first = self._call(
            "admit_sample", self._admit_family, slot, int(seed), logits,
            float(temperature), int(p_len), int(max_new),
            -1 if eos_id is None else int(eos_id))
        first = int(first)
        st = _Running(req, pos=p_len, max_new=max_new, eos_id=eos_id,
                      live_from=self._launches, seq=seq)
        finished = (st.produced >= max_new
                    or (eos_id is not None and first == eos_id))
        if finished:
            self.kv.free(slot)
        else:
            self._running[slot] = st
        return SequenceEvent(req, first, finished)

    def advance_prefill(self) -> List[SequenceEvent]:
        """One CHUNKED-PREFILL tick: dispatch budget-bounded prefill
        chunks — at most `prefill_chunk` suffix tokens in total — for
        the oldest-admitted mid-prefill slots, oldest first. Returns the
        first-token events of sequences whose FINAL chunk completed this
        tick. No-op on a monolithic engine."""
        if not self._prefilling:
            return []
        events: List[SequenceEvent] = []
        budget = self.prefill_chunk
        while self._prefilling and budget > 0:
            slot = min(self._prefilling,
                       key=lambda s: self._prefilling[s].seq)
            pf = self._prefilling[slot]
            n = min(self.prefill_chunk, pf.suffix.size - pf.cursor)
            if n > budget:
                break                    # per-tick token budget spent
            budget -= n
            event = self._prefill_step(slot, n)
            if event is not None:
                events.append(event)
        return events

    def _prefill_step(self, slot: int, n: int) -> Optional[SequenceEvent]:
        """Dispatch ONE prefill chunk of `n` suffix tokens for `slot`
        (padded to its shape bucket). On the final chunk, sample the
        first token, promote the slot to _running, and return its
        event; None otherwise."""
        pf = self._prefilling[slot]
        bucket = self.buckets.bucket_for(n)
        padded = self._staging_for(bucket)
        padded[0, :n] = pf.suffix[pf.cursor:pf.cursor + n]
        padded[0, n:] = 0
        start = pf.start + pf.cursor
        t0 = time.perf_counter()
        with profiler.RecordEvent("serving/prefill_chunk", bucket=bucket,
                                  prompt_len=pf.p_len, slot=slot,
                                  start_pos=start, chunk_len=n,
                                  chunk_index=pf.chunk_index,
                                  request_id=getattr(pf.req,
                                                     "request_id", None)):
            logits = self._call(
                f"prefill_chunk:L{bucket}", self._prefill_chunk_family,
                padded, start, n, pf.pages, slot)
        pf.cursor += n
        # publish this prompt's full blocks whose fill is now queued
        self.kv.register_prefix(slot, pf.start + pf.cursor)
        if self.on_prefill_chunk is not None:
            self.on_prefill_chunk(time.perf_counter() - t0)
        rlog = _request_log.get_request_log()
        if rlog is not None:
            rlog.event("prefill",
                       request_id=getattr(pf.req, "request_id", None),
                       slot=slot, bucket=bucket, prompt_len=pf.p_len,
                       prefix_len=pf.start, suffix_len=n,
                       chunk_index=pf.chunk_index,
                       budget=self.prefill_chunk)
        pf.chunk_index += 1
        if pf.cursor < pf.suffix.size:
            return None
        del self._prefilling[slot]
        return self._sample_first(
            slot, pf.req, logits, pf.p_len, pf.max_new, pf.temperature,
            pf.seed, pf.eos_id, pf.seq)

    def step(self) -> List[SequenceEvent]:
        """One pipeline tick: launch the next chunk dispatch over the
        whole pool (free/finished slots ride along frozen), then read
        and fan out the OLDEST in-flight block. With overlap on, one
        dispatch is always left in flight while sequences are active, so
        this tick's host work runs under the NEXT dispatch's device
        compute."""
        if not self._running and not self._inflight:
            return []
        launched = False
        hook = self.on_tick_phase   # tick profiler (None = no clock reads)
        if self._running and self._needs_dispatch():
            if hook is None:
                self._launch()
            else:
                t0 = time.perf_counter()
                self._launch()
                hook("launch", time.perf_counter() - t0)
            launched = True
        if self._inflight and (len(self._inflight) > 1 or not launched
                               or not self.overlap):
            fl = self._inflight.pop(0)
            if hook is None:
                return self._collect(fl)
            t0 = time.perf_counter()
            events = self._collect(fl)
            hook("collect", time.perf_counter() - t0)
            return events
        return []

    def _needs_dispatch(self) -> bool:
        """Launch only when some running slot still needs tokens BEYOND
        what already-launched dispatches will deliver (every in-flight
        block whose index >= its live_from carries `chunk` of them), so
        dispatches-per-token stays at 1/chunk in the steady state."""
        for st in self._running.values():
            covered = sum(fl.size for fl in self._inflight
                          if fl.index >= st.live_from)
            if st.max_new - st.produced > covered:
                return True
        return False

    def _launch(self) -> None:
        if self.faults is not None:
            self.faults.before_dispatch(self._launches)
        begin_ns = time.monotonic_ns() if _TRACER.enabled else 0
        host_t0 = time.perf_counter() if self.dispatch_timing else 0.0
        with profiler.RecordEvent("serving/decode_dispatch",
                                  active=len(self._running),
                                  slots=self.kv.num_slots,
                                  chunk=self.decode_chunk,
                                  index=self._launches):
            block = self._call("decode_chunk", self._chunk_family)
            event = None
            if block.is_cuda:
                # the token block's copy to pinned host memory queues
                # behind the chunk; _collect waits on the event
                host = torch.empty(block.shape, dtype=block.dtype,
                                   pin_memory=True)
                host.copy_(block, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host = block
        host_s = (time.perf_counter() - host_t0) if self.dispatch_timing \
            else 0.0
        self._inflight.append(_Inflight(host, event, self._launches,
                                        self.decode_chunk, begin_ns,
                                        host_s))
        self._launches += 1
        if self.on_launch is not None:
            self.on_launch()

    def _collect(self, fl: _Inflight) -> List[SequenceEvent]:
        dev_t0 = time.perf_counter() if self.dispatch_timing else 0.0
        if fl.event is not None:
            fl.event.synchronize()
        block = fl.host.numpy()
        if self.dispatch_timing and self.on_dispatch_timed is not None:
            self.on_dispatch_timed(fl.host_s,
                                   time.perf_counter() - dev_t0)
        end_ns = time.monotonic_ns() if fl.begin_ns else 0
        rlog = _request_log.get_request_log()
        # per-(request, dispatch) token attribution for the event log
        emitted: Optional[Dict[int, List[Any]]] = \
            {} if rlog is not None else None
        events: List[SequenceEvent] = []
        # iteration-major walk: token i of every slot before token i+1
        # of any, the same time order the per-step path emits
        for i in range(fl.size):
            for slot in sorted(self._running):
                st = self._running[slot]
                if st.live_from > fl.index:
                    # admitted after this dispatch launched: its tokens
                    # start in a later block
                    continue
                tok = int(block[i, slot])
                st.produced += 1
                st.pos += 1
                self.kv.advance(slot)
                finished = (st.produced >= st.max_new
                            or (st.eos_id is not None
                                and tok == st.eos_id))
                if finished:
                    # retire-without-stall: the slot froze on the device
                    # at this exact token; its frozen repeats later in
                    # this block are skipped because it leaves _running
                    del self._running[slot]
                    self.kv.free(slot)
                if fl.begin_ns:
                    # chunk-interpolated retroactive span: iteration i
                    # of a C-iteration dispatch window gets [i/C,
                    # (i+1)/C) of it
                    w = end_ns - fl.begin_ns
                    _TRACER.record_complete(
                        "serving/decode_iter",
                        fl.begin_ns + (i * w) // fl.size,
                        fl.begin_ns + ((i + 1) * w) // fl.size,
                        "serving",
                        {"request_id": getattr(st.req, "request_id",
                                               None),
                         "slot": slot, "pos": st.pos, "token": tok,
                         "finished": finished, "chunk_index": i,
                         "dispatch": fl.index})
                events.append(SequenceEvent(st.req, tok, finished))
                if emitted is not None:
                    ent = emitted.get(slot)
                    if ent is None:
                        ent = emitted[slot] = [st.req, 0, False]
                    ent[1] += 1
                    ent[2] = finished
        if emitted:
            for slot in sorted(emitted):
                req, n, fin = emitted[slot]
                rlog.event("decode",
                           request_id=getattr(req, "request_id", None),
                           slot=slot, dispatch=fl.index, tokens=n,
                           finished=fin)
        return events

    def cancel(self, req) -> bool:
        """Drop a running or mid-prefill sequence (client disconnect):
        free its pages without emitting further tokens. Tokens the
        in-flight dispatch already produced for it are discarded at
        collect. The release family freezes the device-side slot and
        points its page row at scratch BEFORE the freed blocks can be
        reallocated (device order puts it after every launched chunk and
        before the next admission's prefill)."""
        for table in (self._running, self._prefilling):
            for slot, st in list(table.items()):
                if st.req is req:
                    del table[slot]
                    self._call("release_slot", self._release_family,
                               slot)
                    self.kv.free(slot)
                    return True
        return False
