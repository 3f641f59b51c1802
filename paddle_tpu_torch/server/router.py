"""Multi-replica front tier: least-loaded admission, quotas, deadlines.

A copy of `paddle_tpu/server/router.py` (pure Python) over the port's
`ServingEngine`. Each replica's driver thread steps its engine; the
engine's scheduler runs every device call on the stream it was built on
and under `torch.no_grad()`, so a driver thread needs no set-up of its
own. Two replicas on one card share the parameter tensors and hold an
arena each. Tenants bind to LoRA adapters through `AdapterConfig`; a
request's explicit `adapter_id` (0 included) overrides its binding.

The reference saturates inference hardware by fanning requests over many
trainer/DeviceWorker instances around AnalysisPredictor (PAPER.md layer
map); this router is that front tier for N `ServingEngine` replicas.
One wire request flows

    Router.submit() -> tenant token-bucket check  (QuotaExceededError)
                    -> least-loaded replica pick  (live slot/queue
                       gauges from EngineMetrics, round-robin ties)
                    -> replica.engine.submit()    (EngineOverloadError
                       when EVERY replica sheds)
                    -> StreamHandle               (the handler thread
                       consumes events() while the replica's driver
                       thread produces tokens)

Each replica owns a driver thread stepping its engine (the engines'
submit()/cancel() are lock-protected exactly for this split: producer
threads feed a single driver loop). Per-request deadlines are enforced
by the driver between steps — an expired request is cancelled through
the engine's cancel path, so its KV pages free and co-batched streams
never notice. Graceful drain stops admission (DrainingError), lets
every queued/in-flight stream finish, then tears engines down via the
refcounted close() path.

Backpressure is structured, never parsed from messages: quota sheds
carry the bucket-computed retry hint, engine sheds carry the queue-wait
p50 hint the engine stamps on EngineOverloadError, and both shed paths
fire the watchdog overload hook so shed storms leave flight records.

Metrics land in the process-wide observability registry under the
router's label: `server_requests_total{router,tenant,code}`,
`server_quota_rejections_total{router,tenant}`,
`server_client_disconnects_total{router,tenant}`, and gauges
`server_active_streams` / `server_replicas` / `server_draining`.

Per-tenant SLO objectives (`SLOConfig`, wired like quotas) are scored
once per closed stream: `server_slo_{met,missed}_total{tenant,
objective}` counters, goodput accounting (`server_goodput_tokens_total`
vs `server_slo_tokens_total` + the `server_goodput_ratio` gauge), and
`Router.slo_report()` — the `/slozv` payload aggregating cross-replica
attainment per tenant. With no SLOConfig set, none of those series
exist.

CROSS-REPLICA MIGRATION: `SwappedSequence` generalized into
an engine-independent `MigrationTicket` lets the router REBALANCE live
sequences instead of only failing over dead ones. One migration flows

    order (rebalancer / restart drain / Router.migrate())
      -> source driver: pipeline fence -> migrate_out -> ticket
         (the stream handle detaches; the client's SSE connection
          stays open — its event queue simply pauses)
      -> transfer: router picks a compatible healthy target
      -> target driver: migrate_in -> strict-priority resume (the
         swap-in rule) -> handle re-attaches, tokens continue
         BIT-IDENTICALLY (the ticket's PRNG key row continues the
         per-token split chain)

Every phase is exactly-once under injected faults (FaultPlan migration
phases): an extract fault leaves the sequence running on the source, a
transfer/adopt fault re-adopts it at home or re-places the ticket, and
exhausted recovery falls back to failover semantics — with the
tenant's quota refunded EXACTLY ONCE when the migration plane kills a
stream its ticket had already detached. The rebalancer thread
(`RebalanceConfig`) orders migrations on sustained pressure imbalance
(block/queue/swap gauges, with hysteresis and a fleet-wide concurrency
cap) and on fresh tenant SLO misses; `restart_replica()` drains ONE
replica by migrating its queued and running sequences to peers, then
rebuilds it via the engine factory — a zero-downtime rolling restart.
With `rebalance=None` and no migrate/restart calls, none of the
migration machinery runs and no migration registry families exist.
"""

from __future__ import annotations

import itertools
import math
import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..observability import request_log as _request_log
from ..observability import watchdog as _watchdog
from ..observability.alerts import FleetHealth, HealthConfig
from ..observability.metrics import MetricsRegistry, get_registry
from ..serving.engine import EngineOverloadError, ServingEngine
from ..serving.migration import MigrationError

__all__ = ["Router", "StreamHandle", "TokenBucket", "QuotaConfig",
           "QuotaExceededError", "DrainingError", "RouterMetrics",
           "SLOConfig", "RebalanceConfig", "AdapterConfig"]


class QuotaExceededError(RuntimeError):
    """Tenant token bucket empty: the request was shed at the router.

    Structured fields (`tenant`, `retry_after_s`) so callers map it to
    a 429 + Retry-After without parsing the message."""

    def __init__(self, tenant: str, retry_after_s: float):
        super().__init__(
            f"tenant {tenant!r} quota exhausted; retry in "
            f"{retry_after_s:.3f}s")
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class DrainingError(RuntimeError):
    """The router is draining (or closed): not admitting new requests."""


class QuotaConfig:
    """Per-tenant token-bucket shape. A request costs its total token
    budget (prompt length + max_new_tokens) — work-proportional, so one
    giant request can't ride a per-request count. `capacity` is the
    burst allowance, `refill_per_s` the sustained tokens/second."""

    def __init__(self, capacity: float, refill_per_s: float):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        if refill_per_s < 0:
            raise ValueError(
                f"refill_per_s must be >= 0, got {refill_per_s}")
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)


class SLOConfig:
    """Per-tenant service-level objectives, in seconds (None = the
    objective is not tracked; at least one must be set):

    * ``ttft_s`` — submit -> first token out
    * ``tpot_s`` — mean inter-token time after the first
    * ``e2e_s``  — submit -> finish

    Wired through the router like QuotaConfig (``slos`` per tenant +
    ``default_slo`` for unlisted tenants): when a routed stream closes,
    each configured objective is scored against the stream's
    CLIENT-observed cuts (router-clock stamps spanning every failover
    attempt and the backoff between them) and counted in
    ``server_slo_{met,missed}_total{tenant,objective}``; a request whose
    every scored objective was met contributes its tokens to the
    tenant's GOODPUT (``server_goodput_tokens_total`` vs
    ``server_slo_tokens_total``, ratio gauge ``server_goodput_ratio``).
    With no SLOConfig anywhere, none of those series exist (pinned
    no-op)."""

    def __init__(self, ttft_s: Optional[float] = None,
                 tpot_s: Optional[float] = None,
                 e2e_s: Optional[float] = None):
        for name, v in (("ttft_s", ttft_s), ("tpot_s", tpot_s),
                        ("e2e_s", e2e_s)):
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0, got {v}")
        if ttft_s is None and tpot_s is None and e2e_s is None:
            raise ValueError(
                "SLOConfig needs at least one objective "
                "(ttft_s / tpot_s / e2e_s)")
        self.ttft_s = None if ttft_s is None else float(ttft_s)
        self.tpot_s = None if tpot_s is None else float(tpot_s)
        self.e2e_s = None if e2e_s is None else float(e2e_s)

    def objectives(self) -> Dict[str, float]:
        """{objective name: target seconds} for the configured ones."""
        return {name: v for name, v in (("ttft", self.ttft_s),
                                        ("tpot", self.tpot_s),
                                        ("e2e", self.e2e_s))
                if v is not None}


class AdapterConfig:
    """Per-tenant LoRA adapter binding, wired through the router like
    QuotaConfig (``adapters`` per tenant + ``default_adapter`` for
    unlisted tenants): every request the tenant routes is submitted
    under ``adapter_id``, pinning that adapter's pool row on the chosen
    replica for the request's lifetime. ``adapter_id=0`` is the base
    model (an explicit binding to "no adapter"). A tenant bound to an
    adapter nobody uploaded fails at engine admission with
    UnknownAdapterError — a ValueError, so the HTTP tier's existing
    400 mapping is the typed 4xx — and burns no quota (the router's
    not-granted refund path covers engine validation errors)."""

    def __init__(self, adapter_id: int):
        if not isinstance(adapter_id, int) or isinstance(adapter_id, bool) \
                or adapter_id < 0:
            raise ValueError(
                f"adapter_id must be an int >= 0, got {adapter_id!r}")
        self.adapter_id = int(adapter_id)


class RebalanceConfig:
    """Pressure-driven cross-replica rebalancing knobs. With no
    RebalanceConfig on the router (the default), the rebalancer does
    not exist: no thread, no migration registry families — behavior
    bit-identical to a router without the migration plane.

    * ``interval_s`` — rebalancer poll period.
    * ``pressure_gap`` — minimum (hot − cold) pressure-score gap that
      counts as imbalance. A replica's score is
      blocks_used/blocks_total + queue_depth/max_queue +
      swapped_slots/num_slots, each term clamped to [0, 1] (score
      spans 0..3), read from the live EngineMetrics gauges.
    * ``hysteresis`` — consecutive polls the gap must persist before a
      migration is ordered; the streak resets after every order, so a
      one-poll spike never moves a sequence and rebalancing cannot
      thrash.
    * ``max_concurrent`` — fleet-wide cap on simultaneously in-flight
      migrations; imbalance beyond it waits for the next poll.
    * ``slo_pressure`` — when True, a tenant SLO objective missed
      since the last poll (scored by the SLO plane) triggers a
      migration off the hottest replica immediately, reason="slo",
      even below ``pressure_gap`` — provided the hot replica actually
      has queued work to relieve."""

    def __init__(self, interval_s: float = 0.05,
                 pressure_gap: float = 0.75, hysteresis: int = 3,
                 max_concurrent: int = 1, slo_pressure: bool = True):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if pressure_gap <= 0:
            raise ValueError(
                f"pressure_gap must be > 0, got {pressure_gap}")
        if hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
        if max_concurrent < 1:
            raise ValueError(
                f"max_concurrent must be >= 1, got {max_concurrent}")
        self.interval_s = float(interval_s)
        self.pressure_gap = float(pressure_gap)
        self.hysteresis = int(hysteresis)
        self.max_concurrent = int(max_concurrent)
        self.slo_pressure = bool(slo_pressure)


class _MigrationOrder:
    """One sequence hand-off in flight between replicas. Created by
    the router (rebalancer, restart drain, or the manual ``migrate()``
    API), executed on the SOURCE replica's driver thread (pipeline
    fence + ticket extraction) and then the TARGET's driver (adoption)
    — scheduler state is only ever touched by its owning driver. The
    order owns the stream handle between the source's ``forget`` and
    the target's ``watch``, so a failure sweep on either side cannot
    double-disposition it. ``done``/``outcome`` report the terminal
    disposition: "migrated", "readopted" (recovered back onto the
    source), "aborted:*" (clean refusal, sequence untouched), or
    "failed:*" (failover semantics applied)."""

    def __init__(self, router: "Router", source: "Replica",
                 target: Optional["Replica"], reason: str,
                 handle: Optional["StreamHandle"] = None):
        self.router = router
        self.source = source
        self.target = target
        self.reason = reason
        self.handle = handle
        self.ticket = None
        self.attempts = 0              # adoption attempts so far
        self.t0 = router._clock()
        self.outcome: Optional[str] = None
        self.done = threading.Event()

    def finish(self, outcome: str) -> None:
        self.outcome = outcome
        self.router._migration_done(self)
        self.done.set()


class TokenBucket:
    """Classic token bucket with an injectable clock (tests pin exact
    grant/deny/retry math with a fake clock). Thread-safe."""

    def __init__(self, capacity: float, refill_per_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._clock = clock
        self._tokens = float(capacity)
        self._stamp = clock()
        self._lock = threading.Lock()

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens

    def _refill_locked(self) -> None:
        now = self._clock()
        elapsed = now - self._stamp
        self._stamp = now
        if elapsed > 0:
            self._tokens = min(self.capacity,
                               self._tokens + elapsed * self.refill_per_s)

    def try_take(self, n: float = 1.0) -> float:
        """Take `n` tokens if available; returns 0.0 on grant, else the
        seconds until the bucket could grant `n` (inf when the bucket
        can NEVER grant it: n > capacity or no refill)."""
        with self._lock:
            self._refill_locked()
            if n <= self._tokens:
                self._tokens -= n
                return 0.0
            if n > self.capacity or self.refill_per_s <= 0:
                return math.inf
            return (n - self._tokens) / self.refill_per_s

    def refund(self, n: float) -> None:
        """Credit tokens back — a take whose request was never served
        (every replica shed, or validation failed downstream) must not
        burn the tenant's budget. Capped at capacity."""
        with self._lock:
            self._refill_locked()
            self._tokens = min(self.capacity, self._tokens + float(n))


class StreamHandle:
    """One routed request in flight. The submitting (handler) thread
    consumes `events()` / `result()`; the replica's driver thread
    produces into the internal queue via the engine's on_token callback.
    Exactly one terminal ("done", reason) event is ever emitted — reason
    is one of "stop" (EOS), "length" (budget), "cancelled" (client went
    away), "deadline_exceeded", "replica_failed" (the serving replica
    died after the stream had emitted tokens — the prefix cannot be
    transparently replayed; retry with backoff), or "error".

    The submit arguments are retained on the handle so a replica
    failure can transparently re-submit a ZERO-token stream to a
    healthy replica (same prompt, seed, and deadline — the retried
    stream is bit-identical to what the dead replica would have
    produced)."""

    def __init__(self, router: "Router", replica: "Replica", tenant: str,
                 deadline: Optional[float]):
        self._router = router
        self.replica = replica
        self.tenant = tenant
        self.deadline = deadline            # absolute router-clock stamp
        self.request = None                 # GenerationRequest, set post-submit
        self.finish_reason: Optional[str] = None
        # retained submit args + failover bookkeeping
        self.prompt = None
        self.submit_kw: dict = {}
        self.emitted = 0                    # tokens streamed so far
        self.retries = 0                    # failover re-submissions
        # migration bookkeeping: the engine-minted ids this stream has
        # worn (the ticket's rerouted_from chain), and whether a failed
        # migration already refunded the tenant's quota — the refund is
        # exactly-once however many failure paths observe the corpse
        self.rid_history: List[str] = []
        self.quota_refunded = False
        # client-observed SLO cuts (router clock): unlike the engine's
        # RequestMetrics — which a failover RESETS (the retried request
        # re-marks submission) — these span every attempt plus the
        # backoff between them, so attainment reflects what the client
        # actually waited. Stamped only when the SLO plane is on (the
        # dormant path stays clock-read-free).
        self.submitted_t: Optional[float] = \
            router._clock() if router.slo_enabled else None
        self.first_token_t: Optional[float] = None
        self.finished_t: Optional[float] = None
        self._flock = threading.Lock()
        self._events: "queue.Queue" = queue.Queue()
        self._done = threading.Event()

    @property
    def request_id(self) -> Optional[str]:
        return self.request.request_id if self.request is not None else None

    # driver-thread side ----------------------------------------------------

    def _on_token(self, req, token: int) -> None:
        # the engine's streaming callback: runs on the replica's driver
        # thread, with req.state already advanced for this emission
        if self.finish_reason is not None:
            # a late emission after the stream already terminated (a
            # failover race lost to a cancel): the consumer is gone
            return
        self.request = req
        self.emitted += 1
        if self.emitted == 1 and self.submitted_t is not None:
            self.first_token_t = self._router._clock()
        self._events.put(("token", int(token)))
        if req.finished:
            reason = ("stop" if (req.eos_id is not None
                                 and int(token) == req.eos_id)
                      else "length")
            self._finish(reason)

    def _finish(self, reason: str) -> bool:
        """First finisher wins (natural finish on the driver vs cancel
        from a handler thread race here); emits the terminal event and
        detaches from the router exactly once."""
        with self._flock:
            if self.finish_reason is not None:
                return False
            self.finish_reason = reason
            if self.submitted_t is not None:
                self.finished_t = self._router._clock()
        self._events.put(("done", reason))
        self._done.set()
        self._router._stream_closed(self)
        return True

    # handler-thread side ---------------------------------------------------

    def events(self, timeout: Optional[float] = None):
        """Yield ("token", id) events then one final ("done", reason).
        `timeout` bounds the wait per event (TimeoutError past it)."""
        while True:
            try:
                kind, payload = self._events.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"no stream event within {timeout}s "
                    f"(request {self.request_id})")
            yield kind, payload
            if kind == "done":
                return

    def result(self, timeout: Optional[float] = None):
        """Block until the stream finishes; returns (tokens, reason)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} unfinished after {timeout}s")
        tokens = list(self.request.tokens) if self.request is not None \
            else []
        return tokens, self.finish_reason


class Replica:
    """One ServingEngine plus the SUPERVISED driver thread stepping it.
    The driver is the only thread touching scheduler/slot state (the
    engine's documented contract); handler threads only submit/cancel.

    The driver runs under a supervisor: an exception escaping
    ``engine.step()`` marks the replica FAILED — its stranded work is
    handed back to the router (queued + zero-token streams re-admitted
    to healthy replicas, mid-emission streams terminated with
    ``replica_failed``), a flight record fires through the watchdog
    overload hook, and, when the router has an engine factory, the
    replica REBUILDS: a fresh engine from the same params after an
    exponential backoff, then state returns to OK and the replica
    rejoins admission. Without a factory the replica parks FAILED and
    the router routes around it. States: ``ok`` / ``failed`` /
    ``restarting``."""

    def __init__(self, engine: ServingEngine,
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self._clock = clock
        self._router: Optional["Router"] = None   # set by Router.__init__
        self.state = "ok"
        self.failures = 0                  # consecutive failed rebuilds
        self.failures_total = 0
        self.restarts_total = 0
        # cross-replica migration: completed hand-offs this replica
        # sourced / adopted (host mirrors for /healthz), the order
        # inboxes its driver serves, and the planned-restart flag
        self.migrations_out = 0
        self.migrations_in = 0
        self._migrations_out: List["_MigrationOrder"] = []
        self._migrations_in: List["_MigrationOrder"] = []
        self._restart = False
        self._handles: set = set()
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    @property
    def label(self) -> str:
        return self.engine.metrics.engine_label

    @property
    def mesh_shape(self):
        """The replica engine's serving mesh geometry, (tp,) — (1,)
        for a single-chip engine. Heterogeneous-mesh fleets are first-
        class: admission routes on the LOGICAL gauges (queue depth,
        slots, blocks), which are mesh-oblivious, and migration
        tickets carry the full-head layout, so a tp=2 replica's
        sequences rebalance onto tp=4 or single-chip peers like any
        other handoff (ticket.compatible pre-screens geometry). The
        field exists so /healthz and the rebalance journal can SHOW
        which replicas are tensor-parallel."""
        return self.engine.mesh_shape

    def load(self) -> int:
        """Live queue + slot occupancy, read from the engine's registry
        gauges (the same numbers a /metrics scrape sees)."""
        m = self.engine.metrics
        return int(m.queue_depth) + int(m.active_slots)

    @property
    def busy(self) -> bool:
        if self.state not in ("ok", "draining"):
            # a broken engine's queues are abandoned state, not work;
            # counting them busy would wedge drain forever (a replica
            # DRAINING for a planned restart still owns live work)
            return False
        with self._lock:
            if self._migrations_out or self._migrations_in:
                return True
        return bool(self.engine._queue
                    or self.engine.scheduler.active_count
                    or self.engine._pending_cancels
                    or self.engine.swapped_count)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._drive, name=f"pt-serve-drive-{self.label}",
            daemon=True)
        self._thread.start()

    def kick(self) -> None:
        self._work.set()

    def watch(self, handle: StreamHandle) -> None:
        with self._lock:
            self._handles.add(handle)

    def adopt(self, handle: StreamHandle, engine: ServingEngine) -> bool:
        """watch() plus a post-hoc health check closing the submit/watch
        race: if the supervisor failed this replica between the handler's
        engine.submit and here, the failure sweep may have snapshotted
        ``_handles`` before the handle was added — leaving it parked on a
        dead replica where nothing would ever disposition it. `engine` is
        the instance the caller submitted to: a state=='ok' read alone
        is defeated by a full failed→rebuilt→ok cycle inside the window
        (the request would sit queued on the discarded engine forever),
        so the identity must match too. The sweep and this reclaim both
        mutate ``_handles`` under ``_lock``, so exactly one of them sees
        the handle: returns False when the caller must disposition it
        (reroute), True when this replica — or its failure sweep — owns
        it."""
        with self._lock:
            self._handles.add(handle)
        # "draining" (planned restart) is ALIVE: the engine accepted the
        # submit and the restart drain will displace/migrate this handle
        # — returning False here would make the caller re-submit a
        # duplicate stream next to the one already queued
        if self.state in ("ok", "draining") and self.engine is engine:
            return True
        with self._lock:
            if handle in self._handles:
                self._handles.discard(handle)
                return False
        return True

    def forget(self, handle: StreamHandle) -> None:
        with self._lock:
            self._handles.discard(handle)

    def _drive(self) -> None:
        while not self._stop:
            if self.state in ("failed", "restarting"):
                self._rebuild_or_park()
                continue
            # migration order inboxes first: an adoption or extraction
            # waiting behind a long step would stretch the handoff gap
            # (the client's stream is paused while the ticket travels)
            self._process_migrations_in()
            self._process_migrations_out()
            self._expire_deadlines()
            if self.state == "draining" and self._restart:
                # only a PLANNED RESTART drains toward a rebuild; a bare
                # state="draining" (operator cordon, bench admission
                # hold) just keeps the replica out of _healthy_order
                # while its work runs out normally
                self._restart_turn()
                if self.state != "draining":
                    continue            # rebuilt (or parked failed)
            if self.busy:
                try:
                    self.engine.step()
                except Exception:
                    self._on_failure()
            else:
                # idle: sleep until a submit kicks us (the timeout only
                # bounds shutdown latency — deadline checks matter only
                # while requests are in flight, which keeps the loop hot)
                self._work.wait(timeout=0.02)
                self._work.clear()

    # -- cross-replica migration (driver-thread halves) ----------------------

    def _handle_for(self, req) -> Optional[StreamHandle]:
        with self._lock:
            return next((h for h in self._handles
                         if h.request is req), None)

    def _pick_migratable(self) -> Optional[StreamHandle]:
        """The sequence this replica would hand off next: a PARKED one
        first (its swap-pool record is already serialized — the handoff
        is a pure host-side wrap), else the NEWEST running one (the
        preemption default: least work in flight, shortest re-wait).
        Only router-watched streams qualify — a library-submitted
        request has no handle to re-attach and simply finishes here."""
        eng = self.engine
        for sw in eng._swapped:
            h = self._handle_for(sw.req)
            if h is not None and h.finish_reason is None:
                return h
        running = eng.scheduler._running
        for slot in sorted(running,
                           key=lambda s: (running[s].seq, s),
                           reverse=True):
            h = self._handle_for(running[slot].req)
            if h is not None and h.finish_reason is None:
                return h
        return None

    def _process_migrations_out(self) -> None:
        while True:
            with self._lock:
                if not self._migrations_out:
                    return
                order = self._migrations_out.pop(0)
            self._migrate_out_one(order)

    def _migrate_out_one(self, order: "_MigrationOrder") -> None:
        """SOURCE-driver half of one migration: pick/validate the
        victim, extract the ticket (pipeline fence inside migrate_out —
        fenced tokens stream to the client normally), run the transfer
        phase, and deliver to the target's adoption inbox. Every
        failure leaves the sequence running on the source, re-adopted
        on the source, or handed to failover — never duplicated, never
        in limbo."""
        router = self._router
        handle = order.handle
        if handle is None:
            handle = order.handle = self._pick_migratable()
        if (handle is None or handle.finish_reason is not None
                or handle.request is None or handle.replica is not self):
            order.finish("aborted:no-candidate")
            return
        if router._draining or router._closed:
            # last pre-extraction check on the driver itself: a drain
            # that began after the order was created must not see a
            # ticket extracted that no engine will adopt
            order.finish("aborted:router-draining")
            return
        try:
            ticket = self.engine.migrate_out(handle.request)
        except MigrationError as e:
            # clean refusal (draining / finished during the fence /
            # not migratable): nothing moved, the stream stays here
            order.finish(f"aborted:{e}")
            return
        except Exception:
            # injected/organic extract fault: migrate_out mutates
            # nothing before its extract hook fires, so the sequence
            # is still running here and the stream continues
            traceback.print_exc()
            router.metrics.observe_migration_failure("extract")
            order.finish("failed:extract")
            return
        # the order owns the handle from here: a source failure sweep
        # must not double-disposition a stream whose state just left
        self.forget(handle)
        # router-side annotations ride OUTSIDE the ticket checksum
        ticket.tenant = handle.tenant
        ticket.rerouted_from = tuple(handle.rid_history)
        if handle.submitted_t is not None:
            ticket.slo_stamps = {"submitted_t": handle.submitted_t,
                                 "first_token_t": handle.first_token_t}
        handle.rid_history.append(ticket.request_id)
        order.ticket = ticket
        try:
            if self.engine.faults is not None:
                self.engine.faults.migration_phase("transfer")
        except Exception:
            # transfer fault: the sequence is OFF the source — recovery
            # re-adopts it at home (through this driver's own adoption
            # inbox) or falls over; either way the request stays
            # terminal-bound and pages stay balanced
            traceback.print_exc()
            router.metrics.observe_migration_failure("transfer")
            router._route_home_or_failover(order)
            return
        router._deliver_ticket(order)

    def _process_migrations_in(self) -> None:
        while True:
            with self._lock:
                if not self._migrations_in:
                    return
                order = self._migrations_in.pop(0)
            self._adopt_one(order)

    def _adopt_one(self, order: "_MigrationOrder") -> None:
        """TARGET-driver half: adopt the ticket into this engine (an
        injected adopt fault or a geometry surprise hands the ticket
        back to the router for re-placement) and re-attach the stream.
        Runs on the owning driver thread, so the submit/watch failure
        race `adopt()` closes cannot occur here — a plain watch()
        suffices, and a concurrent planned-restart flip to "draining"
        just means the next restart turn migrates the sequence out
        again."""
        router = self._router
        handle = order.handle
        if handle.finish_reason is not None:
            order.finish("aborted:terminal")
            return
        try:
            req = self.engine.migrate_in(order.ticket,
                                         on_token=handle._on_token)
        except Exception:
            traceback.print_exc()
            router.metrics.observe_migration_failure("adopt")
            order.attempts += 1
            router._adoption_failed(order, failed_on=self)
            return
        # replica before request: cancel() reads request then replica,
        # so a new request must never pair with the old replica
        handle.replica = self
        handle.request = req
        if handle.finish_reason is not None:
            # a cancel/deadline won during the handoff gap: reap the
            # adopted request so it never burns a slot
            self.engine.cancel(req)
            self.kick()
            order.finish("aborted:terminal")
            return
        self.watch(handle)
        self.kick()
        if self is order.source:
            # home re-adoption after a transfer/adopt failure: the
            # sequence recovered in place — not a completed migration
            order.finish("readopted")
            return
        self.migrations_in += 1
        order.source.migrations_out += 1
        router.metrics.observe_migration(
            order.reason, max(0.0, router._clock() - order.t0))
        order.finish("migrated")

    # -- planned rolling restart (driver-thread half) ------------------------

    def _displace_queued(self) -> None:
        """Hand every router-watched QUEUED request to a healthy peer
        (a fresh submit is bit-identical — nothing was emitted). Used
        only by the restart drain; sequences no peer can take fall back
        to failover semantics inside _reroute."""
        router = self._router
        with self.engine._lock:
            queued = list(self.engine._queue)
        for req in queued:
            handle = self._handle_for(req)
            if handle is None or handle.finish_reason is not None:
                continue               # library-submitted: finishes here
            self.engine.cancel(req)    # drops it from the queue only
            self.forget(handle)
            router._reroute(handle, exclude=self, count_retry=False)

    def _restart_turn(self) -> None:
        """One planned-restart drain turn (state == "draining"): hand
        queued requests to peers (no ticket needed), migrate
        running/parked sequences out ONE order at a time — the engine
        keeps stepping between orders, so resident streams keep
        producing tokens throughout the drain — and rebuild once
        nothing is left."""
        router = self._router
        if router is None:
            self._planned_rebuild()
            return
        if router._draining or router._closed:
            # a router-wide drain overrides a planned restart: peers
            # refuse adoptions while draining, so migrating would spin
            # — finish residents in place instead and skip the rebuild
            self._restart = False
            self.state = "ok"
            return
        self._displace_queued()
        with self._lock:
            if self._migrations_out or self._migrations_in:
                return                 # an order is already in flight
        if router._has_orders_involving(self):
            return
        handle = self._pick_migratable()
        if handle is not None:
            router._order_migration(self, None, "restart", handle=handle)
            return
        if not self.busy:
            with self._lock:
                leftovers = bool(self._handles)
            if not leftovers:
                self._planned_rebuild()

    def _planned_rebuild(self) -> None:
        """The zero-downtime tail of restart_replica: the engine is
        empty (every sequence migrated, displaced, or finished) — build
        the fresh engine via the router's factory (build BEFORE closing
        the old one: a failed build must not destroy a working engine's
        registry series for nothing), retire the old engine's series,
        count the restart, and rejoin admission. With no factory the
        drained engine itself rejoins — a soft restart."""
        router = self._router
        factory = router._engine_factory if router is not None else None
        dead_label = self.label
        if factory is not None:
            try:
                engine = factory()
            except Exception:
                # the planned rebuild failed to build: park FAILED —
                # the supervisor's backoff path owns it from here
                traceback.print_exc()
                self.failures += 1
                self.failures_total += 1
                self._restart = False
                self.state = "failed"
                return
            try:
                self.engine.close()    # retire the drained engine's series
            except Exception:
                traceback.print_exc()
            self.engine = engine
        # counters BEFORE the state flip (the failover rule): a poller
        # seeing a healthy replica must never read a stale restart count
        self.restarts_total += 1
        if router is not None:
            router.metrics.observe_replica_restart(dead_label)
        self._restart = False
        self.state = "ok"

    def _on_failure(self) -> None:
        """Supervisor path, on the driver thread: the engine threw out
        of step(). Its internal state is untrustworthy from here — no
        further engine calls; stranded work is rerouted or terminated,
        in-flight migration orders are dissolved (outbound: the
        sequence is still in the stranded sweep) or re-placed (inbound
        tickets stay adoptable elsewhere — replica death mid-migration
        must not entomb a sequence), and the loop moves to
        rebuild/park."""
        traceback.print_exc()
        self.state = "failed"
        self.failures += 1
        self.failures_total += 1
        self._restart = False          # a crash aborts a planned restart
        router = self._router
        with self._lock:
            stranded = list(self._handles)
            self._handles.clear()
            mig_in = list(self._migrations_in)
            self._migrations_in.clear()
            mig_out = list(self._migrations_out)
            self._migrations_out.clear()
        for order in mig_out:
            # not yet extracted: the sequence (and its handle) is still
            # in the stranded sweep below — the order just dissolves
            order.finish("aborted:source-failed")
        if router is not None:
            for order in mig_in:
                order.attempts += 1
                router._adoption_failed(order, failed_on=self)
            router._replica_failed(self, stranded)
        else:
            for order in mig_in:
                order.finish("failed:target-failed")
            for h in stranded:
                h._finish("replica_failed")

    def _rebuild_or_park(self) -> None:
        """FAILED-state driver turn: rebuild a fresh engine when the
        router has a factory (exponential backoff between consecutive
        failures), else park until stop — the router routes around a
        parked replica."""
        router = self._router
        factory = router._engine_factory if router is not None else None
        if factory is None:
            self._work.wait(timeout=0.05)
            self._work.clear()
            return
        self.state = "restarting"
        delay = min(router._restart_backoff_cap_s,
                    router._restart_backoff_s
                    * (2 ** min(self.failures - 1, 10)))
        deadline = time.monotonic() + delay
        while not self._stop and time.monotonic() < deadline:
            time.sleep(min(0.01, delay))
        if self._stop:
            self.state = "failed"
            return
        dead_label = self.label       # attribute the restart to the
        #                               replica that failed, matching
        #                               observe_replica_failure — the
        #                               fresh engine's label is a new
        #                               series nobody has scraped yet
        try:
            self.engine.close()       # retire the dead engine's series
        except Exception:
            traceback.print_exc()
        try:
            engine = factory()
        except Exception:
            # the factory itself failed (e.g. an injected build fault):
            # stay failed, back off longer next turn
            traceback.print_exc()
            self.failures += 1
            self.failures_total += 1
            self.state = "failed"
            return
        self.engine = engine
        self.failures = 0
        # counters BEFORE the state flip: anyone polling for state ==
        # "ok" (healthz, tests) must never read a stale restart count
        # once the replica looks healthy
        self.restarts_total += 1
        if router is not None:
            router.metrics.observe_replica_restart(dead_label)
        self.state = "ok"

    def _expire_deadlines(self) -> None:
        now = self._clock()
        with self._lock:
            expired = [h for h in self._handles
                       if h.deadline is not None and now >= h.deadline
                       and h.finish_reason is None]
        for h in expired:
            # cancel through the engine (queued -> dropped, running ->
            # freed at the top of the next step, pages released) BEFORE
            # emitting the terminal event
            self.engine.cancel(h.request)
            h._finish("deadline_exceeded")

    def stop(self, join: bool = True) -> None:
        self._stop = True
        self._work.set()
        if join and self._thread is not None:
            self._thread.join(timeout=10.0)


class RouterMetrics:
    """Router-labeled series in the process registry. Per-tenant label
    sets are created on first use and tracked so unregister() can retire
    every series this router minted (a recreated router must not leave
    dead labels behind — same discipline as EngineMetrics)."""

    _ids = itertools.count()

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 label: Optional[str] = None):
        self._registry = registry or get_registry()
        self.label = str(label if label is not None
                         else next(RouterMetrics._ids))
        r = self._registry
        self._requests = r.counter(
            "server_requests_total",
            "wire requests by tenant and HTTP response code")
        self._quota = r.counter(
            "server_quota_rejections_total",
            "requests shed by a tenant token-bucket quota")
        self._disconnects = r.counter(
            "server_client_disconnects_total",
            "streams dropped by the client before completion")
        self._replica_failures = r.counter(
            "server_replica_failures_total",
            "replica driver failures (exceptions escaping engine.step)")
        self._replica_restarts = r.counter(
            "server_replica_restarts_total",
            "replica engines successfully rebuilt after a failure")
        # host-side mirrors for /healthz (int reads without a registry
        # snapshot walk)
        self.replica_failures = 0
        self.replica_restarts = 0
        self._gauge_fams = {
            "active_streams": r.gauge(
                "server_active_streams", "wire streams currently open"),
            "replicas": r.gauge(
                "server_replicas", "engine replicas behind the router"),
            "draining": r.gauge(
                "server_draining",
                "1 while the router refuses new admissions"),
        }
        base = {"router": self.label}
        self.active_streams = self._gauge_fams["active_streams"].labels(
            **base)
        self.replicas = self._gauge_fams["replicas"].labels(**base)
        self.draining = self._gauge_fams["draining"].labels(**base)
        # (family, sorted label items) pairs created lazily per tenant
        self._dynamic: set = set()
        self._dyn_lock = threading.Lock()
        # SLO/goodput host mirrors for slo_report() (/slozv reads these
        # without a registry snapshot walk): tenant -> counts
        self._slo: Dict[str, Dict[str, Any]] = {}

    def _inc(self, fam, amount: float = 1.0, **labels) -> None:
        labels["router"] = self.label
        fam.labels(**labels).inc(amount)
        with self._dyn_lock:
            self._dynamic.add((fam, tuple(sorted(labels.items()))))

    def _set(self, fam, value: float, **labels) -> None:
        labels["router"] = self.label
        fam.labels(**labels).set(value)
        with self._dyn_lock:
            self._dynamic.add((fam, tuple(sorted(labels.items()))))

    def _observe(self, fam, value: float, **labels) -> None:
        labels["router"] = self.label
        fam.labels(**labels).observe(value)
        with self._dyn_lock:
            self._dynamic.add((fam, tuple(sorted(labels.items()))))

    def observe_request(self, tenant: str, code: int) -> None:
        self._inc(self._requests, tenant=tenant, code=str(code))

    def observe_quota_rejection(self, tenant: str) -> None:
        self._inc(self._quota, tenant=tenant)

    def observe_disconnect(self, tenant: str) -> None:
        self._inc(self._disconnects, tenant=tenant)

    def observe_replica_failure(self, replica: str) -> None:
        # host mirror under the same lock the dynamic set uses:
        # concurrent driver threads can fail replicas simultaneously,
        # and an unsynchronized += would let /healthz drift under the
        # locked registry counters /metrics reports
        with self._dyn_lock:
            self.replica_failures += 1
        self._inc(self._replica_failures, replica=replica)

    def observe_replica_restart(self, replica: str) -> None:
        with self._dyn_lock:
            self.replica_restarts += 1
        self._inc(self._replica_restarts, replica=replica)

    # -- cross-replica migration (families created lazily, the SLO
    # -- discipline: rebalancer off + no migrate/restart calls = ZERO
    # -- migration series, registry family set bit-identical to
    # -- pre-migration — the pinned no-op) ------------------------------------

    def observe_migration(self, reason: str, seconds: float) -> None:
        """One COMPLETED cross-replica migration (order created ->
        sequence adopted on the target), by trigger."""
        fam = self._registry.counter(
            "server_migrations_total",
            "sequences migrated across replicas, by trigger "
            "(rebalance / restart / slo)")
        hist = self._registry.histogram(
            "serving_migration_seconds",
            "end-to-end cross-replica migration latency: order "
            "created -> sequence adopted on the target "
            "(default latency buckets, 0.5ms..10s)")
        self._inc(fam, reason=reason)
        self._observe(hist, seconds)

    def observe_migration_failure(self, phase: str) -> None:
        """One migration attempt failed at `phase` (extract / transfer
        / adopt). The sequence is never lost — it stays on the source,
        re-adopts, or fails over — this counts the incident."""
        fam = self._registry.counter(
            "server_migration_failures_total",
            "migration attempts failed, by phase "
            "(extract / transfer / adopt)")
        self._inc(fam, phase=phase)

    def slo_missed_total(self) -> int:
        """Total objective misses across tenants (host mirror, no
        registry walk) — the rebalancer's SLO-pressure delta signal."""
        with self._dyn_lock:
            return sum(sum(e["missed"].values())
                       for e in self._slo.values())

    # -- SLO / goodput (families created lazily: with no SLOConfig the
    # -- registry carries ZERO slo/goodput series — the pinned no-op) --------

    def _slo_entry_locked(self, tenant: str) -> Dict[str, Any]:
        ent = self._slo.get(tenant)
        if ent is None:
            ent = self._slo[tenant] = {"met": {}, "missed": {},
                                       "tokens": 0, "goodput_tokens": 0}
        return ent

    def observe_slo(self, tenant: str,
                    results: Dict[str, bool]) -> None:
        """One closed stream's objective verdicts ({objective: met})."""
        met_fam = self._registry.counter(
            "server_slo_met_total",
            "closed streams meeting a tenant SLO objective, by "
            "objective")
        missed_fam = self._registry.counter(
            "server_slo_missed_total",
            "closed streams missing a tenant SLO objective, by "
            "objective")
        with self._dyn_lock:
            ent = self._slo_entry_locked(tenant)
            for obj, ok in results.items():
                key = "met" if ok else "missed"
                ent[key][obj] = ent[key].get(obj, 0) + 1
        for obj, ok in results.items():
            self._inc(met_fam if ok else missed_fam,
                      tenant=tenant, objective=obj)

    def observe_goodput(self, tenant: str, tokens: int,
                        good: bool) -> None:
        """One closed stream delivered `tokens`; `good` = every scored
        objective met (the tokens count toward goodput)."""
        if tokens <= 0:
            return
        tok_fam = self._registry.counter(
            "server_slo_tokens_total",
            "tokens delivered to SLO-tracked tenants")
        good_fam = self._registry.counter(
            "server_goodput_tokens_total",
            "tokens delivered within every scored SLO objective")
        ratio_fam = self._registry.gauge(
            "server_goodput_ratio",
            "goodput tokens / delivered tokens per tenant")
        with self._dyn_lock:
            ent = self._slo_entry_locked(tenant)
            ent["tokens"] += tokens
            if good:
                ent["goodput_tokens"] += tokens
            ratio = ent["goodput_tokens"] / ent["tokens"]
        self._inc(tok_fam, amount=tokens, tenant=tenant)
        if good:
            self._inc(good_fam, amount=tokens, tenant=tenant)
        self._set(ratio_fam, ratio, tenant=tenant)

    def slo_report(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant SLO attainment + goodput rollup (the /slozv
        payload): objective-level met/missed/attainment, the cross-
        objective attainment ratio, and goodput tokens vs total."""
        with self._dyn_lock:
            snapshot = {t: {"met": dict(e["met"]),
                            "missed": dict(e["missed"]),
                            "tokens": e["tokens"],
                            "goodput_tokens": e["goodput_tokens"]}
                        for t, e in self._slo.items()}
        out: Dict[str, Dict[str, Any]] = {}
        for tenant, e in sorted(snapshot.items()):
            objectives = {}
            for obj in sorted(set(e["met"]) | set(e["missed"])):
                m, x = e["met"].get(obj, 0), e["missed"].get(obj, 0)
                objectives[obj] = {
                    "met": m, "missed": x,
                    "attainment": round(m / (m + x), 4) if m + x
                    else None}
            m = sum(e["met"].values())
            x = sum(e["missed"].values())
            t, g = e["tokens"], e["goodput_tokens"]
            out[tenant] = {
                "objectives": objectives,
                "met": m, "missed": x,
                "slo_attainment": round(m / (m + x), 4) if m + x
                else None,
                "tokens": t, "goodput_tokens": g,
                "goodput_ratio": round(g / t, 4) if t else None,
            }
        return out

    def unregister(self) -> None:
        """Retire every series this router registered."""
        for name, fam in self._gauge_fams.items():
            fam.remove(router=self.label)
        with self._dyn_lock:
            dynamic, self._dynamic = self._dynamic, set()
        for fam, items in dynamic:
            fam.remove(**dict(items))


class Router:
    """Front tier over N ServingEngine replicas: least-loaded admission,
    per-tenant token-bucket quotas, per-request deadlines, graceful
    drain. Construct over already-built engines (they must not be
    driven by any other thread once start() runs)."""

    def __init__(self, engines: Sequence[ServingEngine],
                 quotas: Optional[Dict[str, QuotaConfig]] = None,
                 default_quota: Optional[QuotaConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 label: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 engine_factory: Optional[
                     Callable[[], ServingEngine]] = None,
                 max_stream_retries: int = 1,
                 restart_backoff_s: float = 0.05,
                 restart_backoff_cap_s: float = 2.0,
                 slos: Optional[Dict[str, SLOConfig]] = None,
                 default_slo: Optional[SLOConfig] = None,
                 rebalance: Optional[RebalanceConfig] = None,
                 adapters: Optional[Dict[str, AdapterConfig]] = None,
                 default_adapter: Optional[AdapterConfig] = None,
                 health: Optional[HealthConfig] = None):
        engines = list(engines)
        if not engines:
            raise ValueError("router needs at least one engine replica")
        if max_stream_retries < 0:
            raise ValueError(
                f"max_stream_retries must be >= 0, got "
                f"{max_stream_retries}")
        self._clock = clock
        self.metrics = RouterMetrics(registry=registry, label=label)
        # failover knobs: a FAILED replica rebuilds via engine_factory
        # (None = park failed, route around it); zero-token streams
        # stranded by a failure re-submit up to max_stream_retries
        # times; consecutive rebuild failures back off exponentially
        # from restart_backoff_s up to the cap
        self._engine_factory = engine_factory
        self._max_stream_retries = int(max_stream_retries)
        self._restart_backoff_s = float(restart_backoff_s)
        self._restart_backoff_cap_s = float(restart_backoff_cap_s)
        self.replicas = [Replica(e, clock) for e in engines]
        for r in self.replicas:
            r._router = self
        self.metrics.replicas.set(len(self.replicas))
        self._quota_cfg = dict(quotas or {})
        self._default_quota = default_quota
        # per-tenant SLO objectives (the quota-layer wiring pattern):
        # scored at stream close; with neither set the whole SLO plane
        # is dormant — zero registry series, zero per-close work
        self._slo_cfg = dict(slos or {})
        self._default_slo = default_slo
        # per-tenant adapter bindings (same wiring pattern): resolved at
        # submit, riding submit_kw so failover re-submissions and the
        # migration plane keep the same adapter without re-resolution
        self._adapter_cfg = dict(adapters or {})
        self._default_adapter = default_adapter
        self._buckets: Dict[str, Optional[TokenBucket]] = {}
        self._bucket_lock = threading.Lock()
        self._admit_lock = threading.Lock()
        self._draining = False
        self._closed = False
        self._started = False
        self._rr = itertools.count()
        # cross-replica migration plane: in-flight orders (drain waits
        # for them — a ticket stranded by teardown would strand its
        # stream) and the optional pressure-driven rebalancer thread
        self._rebalance = rebalance
        self._rebalance_thread: Optional[threading.Thread] = None
        self._rebalance_stop = threading.Event()
        self._migrations: set = set()
        self._mig_lock = threading.Lock()
        # fleet health & alerting plane (HealthConfig): store + sampler
        # + alert engine over this router's registry. Families mint at
        # construction — health=None keeps the registry family set and
        # the thread list byte-identical to a plane-less build
        self._health: Optional[FleetHealth] = None
        if health is not None:
            self._health = FleetHealth(
                config=health, registry=self.metrics._registry,
                label=self.metrics.label)

    # adoption attempts (initial target + re-placements) before a
    # migration falls back to failover semantics
    _MAX_ADOPTION_ATTEMPTS = 3

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Start one driver thread per replica, plus the rebalancer
        thread when a RebalanceConfig is set (idempotent)."""
        self._started = True
        for r in self.replicas:
            r.start()
        if self._rebalance is not None and self._rebalance_thread is None:
            self._rebalance_thread = threading.Thread(
                target=self._rebalance_loop,
                name=f"pt-serve-rebalance-{self.metrics.label}",
                daemon=True)
            self._rebalance_thread.start()
        if self._health is not None:
            self._health.start()

    @property
    def health(self) -> Optional[FleetHealth]:
        """The fleet health plane, when this router was built with a
        HealthConfig (None otherwise)."""
        return self._health

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def inflight(self) -> int:
        return int(self.metrics.active_streams.value)

    @property
    def slo_enabled(self) -> bool:
        return bool(self._slo_cfg or self._default_slo)

    def slo_report(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant SLO attainment + goodput (the /slozv payload,
        aggregated across every replica this router fronts — objective
        scoring happens here, so one report covers the fleet)."""
        return self.metrics.slo_report()

    def prometheus_text(self, aggregate: bool = True) -> str:
        """Prometheus text exposition of the process registry this
        router's replicas publish into. With ``aggregate=True`` (the
        default) every per-replica series — anything carrying an
        ``engine`` label — merges into fleet totals by dropping the
        label (counters/gauges sum; histograms sum their cumulative
        buckets), so ONE scrape of the router covers every replica
        without per-replica series cardinality; failed-and-rebuilt
        replicas never leave half-dead labels in the scrape.
        ``aggregate=False`` passes per-replica series through
        unchanged (the /metricz?raw=1 escape hatch)."""
        return self.metrics._registry.to_prometheus(
            aggregate_label="engine" if aggregate else None)

    # -- admission ----------------------------------------------------------

    def _bucket_for(self, tenant: str) -> Optional[TokenBucket]:
        with self._bucket_lock:
            if tenant in self._buckets:
                return self._buckets[tenant]
            cfg = self._quota_cfg.get(tenant, self._default_quota)
            bucket = None if cfg is None else TokenBucket(
                cfg.capacity, cfg.refill_per_s, clock=self._clock)
            self._buckets[tenant] = bucket
            return bucket

    def _healthy_order(self) -> List[int]:
        """Admission order over the live registry gauges: healthy
        replicas only (FAILED/RESTARTING ones are routed around until
        their supervisor rebuilds them), least-loaded first, with a
        round-robin offset breaking ties so equal-load replicas share
        cold-start traffic instead of replica 0 taking all. Shared by
        first admission (submit) and failover re-admission (_reroute)."""
        rr = next(self._rr)
        n = len(self.replicas)
        return sorted(
            (i for i in range(n) if self.replicas[i].state == "ok"),
            key=lambda i: (self.replicas[i].load(), (i - rr) % n))

    def submit(self, prompt, max_new_tokens: int, tenant: str = "default",
               deadline_s: Optional[float] = None,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None,
               adapter_id: Optional[int] = None) -> StreamHandle:
        """Route one request. Raises DrainingError (draining/closed),
        QuotaExceededError (tenant bucket empty), EngineOverloadError
        (EVERY replica shed — the least-loaded replica's structured
        error propagates), or ValueError (request can never be served,
        straight from engine validation — including UnknownAdapterError
        for an adapter nobody uploaded, the typed 4xx).

        `adapter_id=None` (the default) resolves the tenant's
        AdapterConfig binding (`adapters`/`default_adapter`, the quota
        wiring pattern); an explicit int — including 0 — overrides the
        binding for this request."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._admit_lock:
            if self._draining or self._closed:
                raise DrainingError(
                    "router is draining; not admitting new requests")
            bucket = self._bucket_for(tenant)
            cost = prompt.size + int(max_new_tokens)
            if bucket is not None:
                retry = bucket.try_take(cost)
                if retry > 0:
                    self.metrics.observe_quota_rejection(tenant)
                    rlog = _request_log.get_request_log()
                    if rlog is not None:   # no request_id yet: the shed
                        # happened before any engine minted one
                        rlog.event("quota_rejected", tenant=tenant,
                                   retry_after_s=retry)
                    # quota shed storms leave flight records, exactly
                    # like engine-queue sheds (engine.submit fires this
                    # hook itself on its own shed path)
                    _watchdog.notify_overload(
                        f"router-{self.metrics.label}")
                    raise QuotaExceededError(tenant, retry)
            if adapter_id is None:
                adapter_cfg = self._adapter_cfg.get(tenant,
                                                    self._default_adapter)
                adapter_id = 0 if adapter_cfg is None \
                    else adapter_cfg.adapter_id
            adapter_id = int(adapter_id)
            order = self._healthy_order()
            last_err: Optional[EngineOverloadError] = None
            granted = False
            try:
                if not order:
                    raise EngineOverloadError(
                        "no healthy replicas (all failed or "
                        "restarting); retry after the supervisor "
                        "rebuilds one",
                        retry_after_s=self._restart_backoff_s)
                for i in order:
                    replica = self.replicas[i]
                    handle = StreamHandle(
                        self, replica, tenant,
                        None if deadline_s is None
                        else self._clock() + float(deadline_s))
                    handle.prompt = prompt
                    handle.submit_kw = dict(
                        max_new_tokens=max_new_tokens,
                        temperature=temperature, seed=seed,
                        eos_id=eos_id, adapter_id=adapter_id)
                    engine = replica.engine
                    try:
                        req = engine.submit(
                            prompt, max_new_tokens,
                            temperature=temperature,
                            seed=seed, eos_id=eos_id,
                            on_token=handle._on_token,
                            adapter_id=adapter_id)
                    except EngineOverloadError as e:
                        last_err = e
                        continue
                    handle.request = req
                    self.metrics.active_streams.inc()
                    granted = True
                    rlog = _request_log.get_request_log()
                    if rlog is not None:
                        rlog.event("routed", request_id=req.request_id,
                                   tenant=tenant, replica=replica.label,
                                   adapter_id=adapter_id)
                    if not replica.adopt(handle, engine):
                        # the replica died between submit and watch and
                        # its stranded-stream sweep missed this handle:
                        # disposition it ourselves (re-admit elsewhere
                        # or terminate) instead of stranding the stream
                        self._reroute(handle)
                        return handle
                    replica.kick()
                    return handle
                assert last_err is not None
                raise last_err
            finally:
                # a request that was never admitted (every replica shed,
                # or engine validation raised) must not burn the
                # tenant's quota: refund the tokens taken above
                if not granted and bucket is not None:
                    bucket.refund(cost)

    def cancel(self, handle: StreamHandle,
               reason: str = "cancelled") -> bool:
        """Abandon a routed request (client disconnect): cancel through
        the engine so its KV pages free on the replica's next step, and
        finish the stream with `reason`. Safe from any thread, safe to
        call after natural completion (returns False then)."""
        req = handle.request
        if req is not None:
            handle.replica.engine.cancel(req)
        finished = handle._finish(reason)
        # a concurrent failover _reroute may have re-submitted this
        # handle to another replica in the window above; its own
        # finish_reason re-check only catches cancels that completed
        # before it ran, so re-read and reap a swapped-in request
        # (engine.cancel is idempotent — both sides reaping is fine)
        req2 = handle.request
        if req2 is not None and req2 is not req:
            handle.replica.engine.cancel(req2)
        if finished and reason == "cancelled":
            self.metrics.observe_disconnect(handle.tenant)
        handle.replica.kick()
        return finished

    def _slo_for(self, tenant: str) -> Optional[SLOConfig]:
        return self._slo_cfg.get(tenant, self._default_slo)

    def _stream_closed(self, handle: StreamHandle) -> None:
        handle.replica.forget(handle)
        self.metrics.active_streams.dec()
        self._finalize_stream(handle)

    def _finalize_stream(self, handle: StreamHandle) -> None:
        """Exactly-once per stream (rides _finish): score the tenant's
        SLO objectives against the stream's client-observed latency
        cuts, account goodput, and journal the terminal event. Client cancels are
        excluded from SLO scoring (the client walked away — not a
        service miss); deadline/replica/error terminations miss every
        configured objective."""
        reason = handle.finish_reason
        req = handle.request
        tokens = len(req.tokens) if req is not None else 0
        cfg = self._slo_for(handle.tenant) if self.slo_enabled else None
        slo_missed: List[str] = []
        if cfg is not None and reason != "cancelled":
            delivered = reason in ("stop", "length")
            # client-observed cuts from the handle's own stamps, NOT the
            # engine's RequestMetrics: a failover re-submission resets
            # the engine-side marks, which would score the retried
            # attempt alone and report attainment healthiest exactly
            # when replicas are failing
            t_sub, t_first, t_end = (handle.submitted_t,
                                     handle.first_token_t,
                                     handle.finished_t)
            cuts = {
                "ttft": (t_first - t_sub
                         if t_first is not None and t_sub is not None
                         else None),
                "e2e": (t_end - t_sub
                        if t_end is not None and t_sub is not None
                        else None),
                "tpot": ((t_end - t_first) / (tokens - 1)
                         if tokens > 1 and t_end is not None
                         and t_first is not None else None),
            }
            results: Dict[str, bool] = {}
            for obj, target in cfg.objectives().items():
                if not delivered:
                    results[obj] = False
                    continue
                actual = cuts[obj]
                if actual is None or actual < 0:
                    continue    # unscorable (tpot of a 1-token
                    #             generation, a non-monotonic injected
                    #             clock): neither met nor missed
                results[obj] = actual <= target
            if results:
                self.metrics.observe_slo(handle.tenant, results)
                slo_missed = sorted(o for o, ok in results.items()
                                    if not ok)
            self.metrics.observe_goodput(
                handle.tenant, tokens,
                good=bool(reason in ("stop", "length")
                          and not slo_missed))
        rlog = _request_log.get_request_log()
        if rlog is not None:
            fields: Dict[str, Any] = dict(
                tenant=handle.tenant, reason=reason, tokens=tokens,
                replica=handle.replica.label)
            if cfg is not None:
                fields["slo_missed"] = slo_missed
            rlog.event("stream_closed", request_id=handle.request_id,
                       **fields)

    # -- replica failover ----------------------------------------------------

    def _replica_failed(self, replica: Replica,
                        stranded: Sequence[StreamHandle]) -> None:
        """Supervisor callback (on the FAILED replica's driver thread):
        count + flight-record the failure, then disposition every
        stranded stream — zero-token streams (queued or admitted but
        not yet emitting) re-submit transparently to a healthy replica
        (bounded by max_stream_retries; the retried stream is
        bit-identical since prompt/seed/deadline ride the handle),
        mid-emission streams terminate with ``replica_failed`` (their
        prefix cannot be replayed without duplicate tokens)."""
        self.metrics.observe_replica_failure(replica.label)
        # shed storms and replica deaths leave the same evidence trail:
        # a flight record through the watchdog overload hook
        _watchdog.notify_overload(f"replica-{replica.label}")
        for handle in stranded:
            self._reroute(handle)

    def _reroute(self, handle: StreamHandle,
                 exclude: Optional["Replica"] = None,
                 count_retry: bool = True) -> None:
        """Re-submit a ZERO-token stream to a healthy replica.
        `count_retry=False` is the planned-displacement flavor (restart
        drain hands queued requests to peers): it neither burns the
        handle's failover-retry budget nor journals a `failover` event
        — the `routed{rerouted_from=}` link still chains the ids.
        `exclude` skips one replica (the one being drained)."""
        if handle.finish_reason is not None:
            return                          # already terminal (cancel won)
        if (handle.emitted > 0
                or (count_retry
                    and handle.retries >= self._max_stream_retries)
                or self._draining or self._closed):
            handle._finish("replica_failed")
            return
        if count_retry:
            handle.retries += 1
        rlog = _request_log.get_request_log()
        stranded_rid = handle.request_id
        if rlog is not None:
            if count_retry:
                rlog.event("failover", request_id=stranded_rid,
                           tenant=handle.tenant, retries=handle.retries)
            else:
                # planned displacement (restart drain), not a failure:
                # its own kind so serving_summary renders the move
                # without a FAILOVER annotation
                rlog.event("displaced", request_id=stranded_rid,
                           tenant=handle.tenant)
        for i in self._healthy_order():
            replica = self.replicas[i]
            if replica is exclude:
                continue
            engine = replica.engine
            try:
                req = engine.submit(
                    handle.prompt, on_token=handle._on_token,
                    **handle.submit_kw)
            except (EngineOverloadError, ValueError):
                continue
            if rlog is not None:
                # the retried stream carries a NEW engine-minted id;
                # rerouted_from chains the timelines (and retires the
                # superseded id from the in-flight set — including a
                # prior attempt whose adopt() lost to a replica death)
                rlog.event("routed", request_id=req.request_id,
                           tenant=handle.tenant, replica=replica.label,
                           rerouted_from=stranded_rid)
                stranded_rid = req.request_id
            # replica before request: cancel() re-reads request then
            # replica, so a new request must never pair with the old
            # replica
            handle.replica = replica
            handle.request = req
            if handle.finish_reason is not None:
                # a cancel won between our entry check and the submit:
                # nothing else knows about the fresh request — reap it
                # so it doesn't burn a slot generating dropped tokens
                engine.cancel(req)
                replica.kick()
                return
            if not replica.adopt(handle, engine):
                continue        # this one died in the window too
            replica.kick()
            return
        # nowhere to go (every healthy replica shed, or none left)
        handle._finish("replica_failed")

    # -- cross-replica migration ---------------------------------------------

    def migrate(self, handle: StreamHandle,
                target: Optional[Any] = None,
                reason: str = "rebalance") -> "_MigrationOrder":
        """Migrate one routed stream to another replica: pipeline fence
        + ticket extraction on the source driver, adoption on the
        target driver, the client's SSE stream held open throughout and
        token-identical across the move. `target` is a replica index or
        Replica (None = the router picks the least-loaded compatible
        peer at delivery time). Returns the order — wait on
        ``order.done`` and read ``order.outcome``. Raises DrainingError
        while draining/closed."""
        if self._draining or self._closed:
            raise DrainingError("router is draining; not migrating")
        source = handle.replica
        if isinstance(target, int):
            if not 0 <= target < len(self.replicas):
                raise ValueError(
                    f"replica index {target} out of range "
                    f"[0, {len(self.replicas)})")
            tgt = self.replicas[target]
        else:
            tgt = target
        if tgt is source:
            raise ValueError("migration target is the source replica")
        return self._order_migration(source, tgt, reason, handle=handle)

    def _order_migration(self, source: "Replica",
                         target: Optional["Replica"], reason: str,
                         handle: Optional[StreamHandle] = None
                         ) -> "_MigrationOrder":
        order = _MigrationOrder(self, source, target, reason, handle)
        if self._draining or self._closed:
            # an order created after drain began could extract a ticket
            # nobody will adopt (every engine is — or is about to be —
            # flagged draining) and get a healthy stream killed by the
            # failover fallback; refuse instead, the drain finishes the
            # sequence in place
            order.finish("aborted:router-draining")
            return order
        with self._mig_lock:
            self._migrations.add(order)
        # state re-checked UNDER the inbox lock: _on_failure flips state
        # before sweeping the inboxes under this same lock, so an order
        # appended while the state still reads alive is guaranteed to be
        # seen by the sweep — it can never land in a just-cleared inbox
        with source._lock:
            if source.state not in ("ok", "draining"):
                alive = False
            else:
                source._migrations_out.append(order)
                alive = True
        if not alive:
            order.finish("aborted:source-unhealthy")
            return order
        source.kick()
        return order

    def _enqueue_adoption(self, replica: "Replica",
                          order: "_MigrationOrder") -> bool:
        """Append `order` to a replica's adoption inbox iff the replica
        is still alive — re-checked under the inbox lock (the lock
        _on_failure's sweep holds, with the state flipped first), so a
        ticket can never be entombed in a dead replica's cleared inbox.
        False = the caller must re-place the order."""
        with replica._lock:
            if replica.state not in ("ok", "draining"):
                return False
            replica._migrations_in.append(order)
        replica.kick()
        return True

    def _migration_done(self, order: "_MigrationOrder") -> None:
        with self._mig_lock:
            self._migrations.discard(order)

    def _migrations_active(self) -> bool:
        with self._mig_lock:
            return bool(self._migrations)

    def _has_orders_involving(self, replica: "Replica") -> bool:
        with self._mig_lock:
            return any(o.source is replica or o.target is replica
                       for o in self._migrations)

    def _candidate_targets(self, order: "_MigrationOrder",
                           exclude=()) -> List["Replica"]:
        """Healthy, geometry-compatible adoption targets, least-loaded
        first (ticket.compatible only reads immutable engine geometry,
        so the pre-screen is safe cross-thread)."""
        out = []
        for i in self._healthy_order():
            r = self.replicas[i]
            if r is order.source or r in exclude:
                continue
            if order.ticket.compatible(r.engine):
                out.append(r)
        return out

    def _deliver_ticket(self, order: "_MigrationOrder") -> None:
        """SOURCE-driver: hand an extracted ticket to its target's
        adoption inbox (re-picking when the chosen target went
        unhealthy or can't host the geometry). No peer can host it ->
        the sequence re-adopts at home (it simply stays) — except under
        a planned restart, where home is going away, so failover
        semantics apply."""
        target = order.target
        if (target is None or target.state != "ok"
                or not order.ticket.compatible(target.engine)):
            targets = self._candidate_targets(order)
            target = targets[0] if targets else None
        while target is not None:
            order.target = target
            if self._enqueue_adoption(target, order):
                return
            # the picked target died between the pre-screen and the
            # append: try the next one
            targets = self._candidate_targets(order, exclude=(target,))
            target = targets[0] if targets else None
        if order.reason == "restart":
            self._migration_failover(order)
        else:
            self._route_home_or_failover(order)

    def _route_home_or_failover(self, order: "_MigrationOrder") -> None:
        """Recovery for a ticket that cannot reach a peer: re-adopt on
        the SOURCE (routed through its own adoption inbox so the
        migrate_in runs on the owning driver thread). A source that is
        gone — or going away for a restart — leaves only failover."""
        src = order.source
        if order.reason != "restart":
            order.target = src
            if self._enqueue_adoption(src, order):
                return
        self._migration_failover(order)

    def _adoption_failed(self, order: "_MigrationOrder",
                         failed_on: "Replica") -> None:
        """An adoption attempt failed (injected fault, geometry
        surprise, or the target died first): re-place the ticket —
        another peer, then home — bounded by _MAX_ADOPTION_ATTEMPTS,
        then failover. The ticket is never lost and never adopted
        twice: exactly one inbox (or the failover path) holds the
        order at any moment."""
        if order.attempts < self._MAX_ADOPTION_ATTEMPTS:
            exclude = [failed_on]
            while True:
                targets = self._candidate_targets(order,
                                                  exclude=tuple(exclude))
                if not targets:
                    break
                order.target = targets[0]
                if self._enqueue_adoption(targets[0], order):
                    return
                exclude.append(targets[0])
            src = order.source
            if order.reason != "restart" and src is not failed_on:
                self._route_home_or_failover(order)
                return
        self._migration_failover(order)

    def _migration_failover(self, order: "_MigrationOrder") -> None:
        """Terminal migration disposition — failover semantics: a
        zero-token stream re-submits transparently to a healthy replica
        (a fresh submit is bit-identical), a mid-emission stream
        terminates with replica_failed. Either way, when the stream
        dies OF the migration (its ticket had already detached it), the
        tenant's quota is refunded EXACTLY ONCE — the tokens it paid
        for will never be delivered by this request."""
        handle = order.handle
        if handle.finish_reason is None:
            if handle.emitted:
                self._refund_once(handle)
                handle._finish("replica_failed")
            else:
                self._reroute(handle)
                if handle.finish_reason == "replica_failed":
                    self._refund_once(handle)
        order.finish("failed:" + ("terminal"
                                  if handle.finish_reason
                                  == "replica_failed" else "rerouted"))

    def _refund_once(self, handle: StreamHandle) -> None:
        """Credit the tenant's bucket back for a stream the migration
        plane killed after its ticket detached it — exactly once, no
        matter how many failure paths observe the same corpse."""
        with handle._flock:
            if handle.quota_refunded:
                return
            handle.quota_refunded = True
        bucket = self._bucket_for(handle.tenant)
        if bucket is not None and handle.prompt is not None:
            bucket.refund(handle.prompt.size
                          + int(handle.submit_kw.get(
                                "max_new_tokens", 0)))

    # -- pressure-driven rebalancer ------------------------------------------

    def _pressure(self, replica: "Replica") -> float:
        """Replica pressure score in [0, 3] off the live registry
        gauges: block occupancy + queue backlog + swap-pool depth, each
        normalized and clamped (see RebalanceConfig)."""
        eng = replica.engine
        m = eng.metrics
        blocks = min(1.0, int(m.kv_blocks_used)
                     / max(1, int(m.kv_blocks_total)))
        queue = min(1.0, int(m.queue_depth)
                    / max(1, eng.config.max_queue))
        swapped = min(1.0, int(m.swapped_slots)
                      / max(1, eng.config.num_slots))
        return blocks + queue + swapped

    def _rebalance_loop(self) -> None:
        """The rebalancer thread: poll replica pressure, order ONE
        migration from the hottest to the coldest replica when the gap
        persists past the hysteresis window (reason="rebalance") or a
        tenant scored a fresh SLO miss while the hot replica has queued
        work (reason="slo"). The max_concurrent cap and the
        streak-reset-after-order rule make thrash impossible: pressure
        must re-prove itself between moves."""
        cfg = self._rebalance
        streak = 0
        last_missed = self.metrics.slo_missed_total()
        while not self._rebalance_stop.wait(cfg.interval_s):
            if self._draining or self._closed:
                return
            ok = [r for r in self.replicas if r.state == "ok"]
            if len(ok) < 2:
                streak = 0
                continue
            scores = {r: self._pressure(r) for r in ok}
            hot = max(ok, key=lambda r: scores[r])
            cold = min(ok, key=lambda r: scores[r])
            gap = scores[hot] - scores[cold]
            reason = None
            if gap >= cfg.pressure_gap:
                streak += 1
                if streak >= cfg.hysteresis:
                    reason = "rebalance"
            else:
                streak = 0
            missed = self.metrics.slo_missed_total()
            if (reason is None and cfg.slo_pressure
                    and missed > last_missed and gap > 0
                    and int(hot.engine.metrics.queue_depth) > 0):
                reason = "slo"
            last_missed = missed
            # health-plane hint: a page-severity alert firing (burn
            # rate, throughput collapse) is fleet-level evidence the
            # hot replica should shed NOW — skip the hysteresis streak
            # the raw pressure gap would still be accumulating
            if (reason is None and cfg.slo_pressure
                    and self._health is not None
                    and self._health.pressure_hint() >= 1.0
                    and gap > 0
                    and int(hot.engine.metrics.queue_depth) > 0):
                reason = "slo"
            if reason is None:
                continue
            with self._mig_lock:
                inflight = len(self._migrations)
            if inflight >= cfg.max_concurrent:
                continue
            self._order_migration(hot, cold, reason)
            streak = 0

    def _stop_rebalancer(self) -> None:
        self._rebalance_stop.set()
        thread, self._rebalance_thread = self._rebalance_thread, None
        if thread is not None:
            thread.join(timeout=5.0)

    # -- zero-downtime rolling restart ---------------------------------------

    def restart_replica(self, i: int,
                        timeout: Optional[float] = None,
                        force: bool = False) -> bool:
        """Rolling restart of ONE replica with zero dropped tokens:
        drain it by MIGRATING its queued and running/parked sequences
        to healthy peers (client SSE streams stay open and
        token-identical throughout; sequences no peer can host fall
        back to failover semantics), then rebuild via the engine
        factory (no factory: the drained engine rejoins as-is) and
        return it to admission. Blocks until the rebuild completed
        (True) or `timeout` wall-seconds elapsed / the restart was
        overridden by a router drain (False — a timed-out drain keeps
        going in the background; poll /healthz). Raises DrainingError
        while the router drains/closes and ValueError for an index out
        of range, a replica that is not ok, or — unless `force=True` —
        the LAST healthy replica (with no peer, every stream would
        fail over instead of migrating: that is a wipeout, not a
        rolling restart). The peer check and the state flip are atomic
        under the admission lock, so two concurrent restarts can never
        drain the whole fleet at once."""
        if not 0 <= i < len(self.replicas):
            raise ValueError(
                f"replica index {i} out of range "
                f"[0, {len(self.replicas)})")
        replica = self.replicas[i]
        with self._admit_lock:
            if self._draining or self._closed:
                raise DrainingError(
                    "router is draining; not restarting replicas")
            if replica.state != "ok":
                raise ValueError(
                    f"replica {replica.label} is {replica.state}; "
                    "rolling restart needs a healthy replica")
            if not force and not any(
                    r.state == "ok" for r in self.replicas
                    if r is not replica):
                raise ValueError(
                    f"replica {replica.label} is the only healthy "
                    "replica; restarting it would fail over every "
                    "stream instead of migrating (pass force=True to "
                    "do it anyway)")
            restarts_before = replica.restarts_total
            replica._restart = True
            replica.state = "draining"
        replica.kick()
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        while replica._restart or replica.state == "draining":
            if replica.state == "failed":
                return False        # the planned rebuild's factory failed
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.005)
        # the restart counter is the truth, not the state flip: a
        # router-wide drain overriding the planned restart returns the
        # replica to "ok" WITHOUT rebuilding — that is not a restart
        return replica.restarts_total > restarts_before

    # -- drain / teardown ---------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: stop admitting (submit raises DrainingError),
        then wait until every queued and in-flight request has finished
        streaming. Returns True when fully drained, False when `timeout`
        (wall seconds) elapsed first — nothing is cancelled either way;
        close() decides what happens to leftovers.

        Migration interplay: in-flight migrations are allowed to LAND
        first (a ticket stranded by the drain would strand its stream —
        drain's contract is zero dropped tokens), THEN every engine is
        flagged draining so late migrate calls refuse cleanly instead
        of parking sequences nobody will resume."""
        with self._admit_lock:
            self._draining = True
        self.metrics.draining.set(1)
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        while self._migrations_active():
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.002)
        for r in self.replicas:
            r.engine.begin_drain()
            r.kick()
        while True:
            if (not self._migrations_active()
                    and all(not r.busy and not r._handles
                            for r in self.replicas)):
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.005)

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Tear down: optional graceful drain, force-cancel whatever is
        left, stop the driver threads, then close every engine through
        the refcounted close() path (registry series retired, shared
        debug server released by the last holder)."""
        if self._closed:
            return
        self._stop_rebalancer()
        if self._health is not None:
            self._health.close()
        if drain:
            self.drain(timeout=timeout)
        with self._admit_lock:
            self._draining = True
            self._closed = True
        self.metrics.draining.set(1)
        for r in self.replicas:
            with r._lock:
                leftovers = list(r._handles)
            for h in leftovers:
                if h.request is not None:
                    r.engine.cancel(h.request)
                h._finish("cancelled")
            r.kick()
        for r in self.replicas:
            r.stop()
        # disposition streams stranded mid-migration (drain=False, or a
        # timed-out drain): their tickets die with the process — the
        # streams must still reach a terminal event. The replica inboxes
        # empty too: the drivers are stopped, and a pending order left
        # behind would keep `busy` true forever under the step loop
        # below
        with self._mig_lock:
            orders = list(self._migrations)
        for o in orders:
            if o.handle is not None:
                o.handle._finish("cancelled")
            o.finish("aborted:closed")
        for r in self.replicas:
            with r._lock:
                r._migrations_out.clear()
                r._migrations_in.clear()
        for r in self.replicas:
            if r._thread is None or not r._thread.is_alive():
                # driver joined: apply any still-pending cancels from
                # THIS thread so device pages are freed before close
                try:
                    while r.busy:
                        r.engine.step()
                except Exception:
                    traceback.print_exc()
            # else: the driver outlived its join timeout (wedged in a
            # dispatch) and still owns scheduler state — never step
            # under it; close() below only retires registry series
            r.engine.close()
        self.metrics.unregister()
