"""Deterministic fault injection for the serving stack.

A copy of `paddle_tpu/serving/faults.py` (pure Python). The port's
engine calls `begin_step`, `deny_pages` and `before_dispatch`; the
migration hook waits for the migration slice (ROADMAP A.1.2).

The reference's production layers assume components fail (pserver
retry semantics, multi-trainer supervision); testing the matching
recovery paths here — replica failover, host-swap preemption, queue
requeue under page shortage — must not depend on soak-test luck. A
`FaultPlan` is a SEEDED, REPLAYABLE schedule of faults threaded
through the engine's step loop and the scheduler's dispatch hook:

* step exceptions   — ``engine.step()`` raises `InjectedFault` at the
                      scheduled engine-step indices (exactly once per
                      index: the step counter advances before the
                      raise, so a supervisor that retries the driver
                      loop moves past the fault). This is the replica-
                      failover trigger.
* page shortages    — admission at the scheduled steps behaves as if
                      the arena had no pages (the engine requeues the
                      head-of-line request at the queue FRONT),
                      exercising queue-then-flow and the preemption
                      decision deterministically.
* slow steps        — ``{step: seconds}`` delays injected at the top
                      of the step (watchdog/deadline territory) or, via
                      ``slow_dispatches``, right before a chunk launch.
* migration faults  — ``{phase: {attempt indices}}`` over the three
                      cross-replica migration phases: ``extract``
                      (inside ``migrate_out``, after the pipeline fence
                      and before the sequence leaves the source — a
                      fault leaves it running there), ``transfer`` (the
                      router's hand-off of a produced ticket — the
                      sequence is OFF the source, recovery must re-adopt
                      or fail over), and ``adopt`` (inside
                      ``migrate_in``, before the target mutates any
                      state — the ticket survives for retry elsewhere).
                      Attempt counters are per phase per plan, so
                      ``{"adopt": {0}}`` fails exactly the first
                      adoption this engine attempts.
                      ``migration_delays={phase: {index: seconds}}``
                      injects latency at the same points.

Plans are built either explicitly (exact step indices — unit tests pin
exact recovery sequences) or via `FaultPlan.chaos()` (a seeded random
schedule over N steps — the soak test's mixed-fault storm; the same
seed always yields the same storm). Install with
``ServingConfig(fault_plan=plan)`` or by assigning ``engine.faults``;
a plan observes one engine's step stream, so give each engine its own
instance. Counters (`injected_exceptions`, `denied_steps`,
`slept_steps`) let tests assert the plan actually fired.
"""

from __future__ import annotations

import random
import time
from typing import Dict, Iterable, Optional

__all__ = ["FaultPlan", "InjectedFault"]


class InjectedFault(RuntimeError):
    """A scheduled fault from a FaultPlan — the exception the replica
    supervisor (and any test) can positively identify as injected, not
    organic. Carries the engine-step index it fired at (for migration-
    phase faults: the per-phase attempt index, with `phase` naming the
    phase)."""

    def __init__(self, step: int, phase: Optional[str] = None):
        if phase is None:
            msg = f"injected fault at engine step {step}"
        else:
            msg = (f"injected {phase}-phase migration fault "
                   f"(attempt {step})")
        super().__init__(msg)
        self.step = step
        self.phase = phase


class FaultPlan:
    """One engine's deterministic fault schedule (see module doc)."""

    MIGRATION_PHASES = ("extract", "transfer", "adopt")

    def __init__(self, step_exceptions: Iterable[int] = (),
                 page_shortages: Iterable[int] = (),
                 slow_steps: Optional[Dict[int, float]] = None,
                 slow_dispatches: Optional[Dict[int, float]] = None,
                 migration_faults: Optional[
                     Dict[str, Iterable[int]]] = None,
                 migration_delays: Optional[
                     Dict[str, Dict[int, float]]] = None,
                 sleep=time.sleep):
        self.step_exceptions = frozenset(int(s) for s in step_exceptions)
        self.page_shortages = frozenset(int(s) for s in page_shortages)
        self.slow_steps = {int(k): float(v)
                           for k, v in (slow_steps or {}).items()}
        self.slow_dispatches = {int(k): float(v)
                                for k, v in (slow_dispatches or {}).items()}
        self.migration_faults = {
            p: frozenset(int(i) for i in ids)
            for p, ids in (migration_faults or {}).items()}
        self.migration_delays = {
            p: {int(k): float(v) for k, v in d.items()}
            for p, d in (migration_delays or {}).items()}
        bad = (set(self.migration_faults) | set(self.migration_delays)) \
            - set(self.MIGRATION_PHASES)
        if bad:
            raise ValueError(
                f"unknown migration phase(s) {sorted(bad)}; valid: "
                f"{list(self.MIGRATION_PHASES)}")
        self._sleep = sleep               # injectable (tests stub it)
        # per-phase attempt counters: each migration_phase() call at a
        # phase advances its counter BEFORE any raise, so a scheduled
        # fault fires exactly once and retries proceed past it
        self._migration_attempts: Dict[str, int] = {}
        # fired-fault telemetry so tests assert the plan actually ran
        self.injected_exceptions = 0
        self.denied_steps = 0
        self.slept_steps = 0
        self.injected_migration_faults = 0

    @classmethod
    def chaos(cls, seed: int, steps: int, p_exception: float = 0.02,
              p_shortage: float = 0.05, p_slow: float = 0.02,
              slow_s: float = 0.005,
              p_migration: float = 0.0) -> "FaultPlan":
        """A seeded random storm over `steps` engine steps: each step
        independently draws an exception / forced page shortage / delay.
        Same seed, same storm — the chaos soak replays exactly.
        `p_migration` > 0 additionally schedules migration-phase faults
        over attempt indices 0..steps (per phase, independently) so a
        rebalancing/restarting fleet's hand-offs fail mid-flight too."""
        rng = random.Random(seed)
        exc, short, slow = [], [], {}
        for s in range(int(steps)):
            if rng.random() < p_exception:
                exc.append(s)
            if rng.random() < p_shortage:
                short.append(s)
            if rng.random() < p_slow:
                slow[s] = slow_s
        migration: Dict[str, list] = {}
        if p_migration > 0:
            for phase in cls.MIGRATION_PHASES:
                hits = [s for s in range(int(steps))
                        if rng.random() < p_migration]
                if hits:
                    migration[phase] = hits
        return cls(step_exceptions=exc, page_shortages=short,
                   slow_steps=slow, migration_faults=migration)

    # -- engine-side hooks ---------------------------------------------------

    def begin_step(self, step: int) -> None:
        """Called by the engine at the top of every step, AFTER its step
        counter advanced: sleeps a scheduled delay, then raises the
        scheduled InjectedFault — so the fault fires exactly once and a
        rebuilt/retrying driver proceeds to the next step."""
        delay = self.slow_steps.get(step)
        if delay:
            self.slept_steps += 1
            self._sleep(delay)
        if step in self.step_exceptions:
            self.injected_exceptions += 1
            raise InjectedFault(step)

    def deny_pages(self, step: int) -> bool:
        """True when admission at `step` must act page-starved (the
        engine requeues head-of-line instead of admitting — the forced-
        shortage path; preemption is deliberately NOT triggered by a
        forced shortage, which simulates transient pressure, not a
        resident sequence to evict)."""
        if step in self.page_shortages:
            self.denied_steps += 1
            return True
        return False

    # -- migration-side hook ---------------------------------------------------

    def migration_phase(self, phase: str) -> None:
        """Called at each cross-replica migration phase this engine
        participates in (`extract` inside migrate_out, `adopt` inside
        migrate_in, `transfer` by the router against the SOURCE plan):
        sleeps a scheduled delay, then raises the scheduled
        InjectedFault. The per-phase attempt counter advances before
        the raise, so each scheduled index fires exactly once and a
        retried migration proceeds past it."""
        n = self._migration_attempts.get(phase, 0)
        self._migration_attempts[phase] = n + 1
        delay = self.migration_delays.get(phase, {}).get(n)
        if delay:
            self.slept_steps += 1
            self._sleep(delay)
        if n in self.migration_faults.get(phase, ()):
            self.injected_migration_faults += 1
            raise InjectedFault(n, phase=phase)

    # -- scheduler-side hook -------------------------------------------------

    def before_dispatch(self, index: int) -> None:
        """Called by the scheduler right before chunk launch `index`:
        injects the scheduled dispatch delay (a device-side slowdown as
        the watchdog sees it — the launch heartbeat fires late)."""
        delay = self.slow_dispatches.get(index)
        if delay:
            self.slept_steps += 1
            self._sleep(delay)

    def summary(self) -> Dict[str, int]:
        return {"injected_exceptions": self.injected_exceptions,
                "denied_steps": self.denied_steps,
                "slept_steps": self.slept_steps,
                "injected_migration_faults":
                    self.injected_migration_faults,
                "scheduled_exceptions": len(self.step_exceptions),
                "scheduled_shortages": len(self.page_shortages),
                "scheduled_delays": (len(self.slow_steps)
                                     + len(self.slow_dispatches)),
                "scheduled_migration_faults": sum(
                    len(v) for v in self.migration_faults.values())}
