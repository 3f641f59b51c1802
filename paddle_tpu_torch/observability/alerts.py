"""Declarative alerting over the time-series store: SLO burn rate,

A copy of `paddle_tpu/observability/alerts.py` (pure Python).
anomaly detectors, fleet health.

Production serving treats windowed rates and burn-rate alerting as the
control input for admission and scaling, not an afterthought (the
multi-window multi-burn-rate recipe from the SRE workbook): this module
closes that loop in-process, on top of `observability.timeseries`:

* `AlertRule` — name + `expr(ctx) -> Optional[float]` over windowed
  series (return a measurement while the condition is violated, None
  while it is not), `for_s` hold-down before firing, `clear_for_s`
  hold-down before resolving, severity ("warn"/"page"), static labels.
* `AlertEngine` — evaluates rules against an `AlertContext` (windowed
  `rate`/`delta`/`value`/`p_quantile`/`error_ratio` reads of the
  store), runs the ok → pending → firing state machine, and on every
  transition: flips the `server_alerts_firing{rule,severity}` gauge,
  counts `server_alert_transitions_total{rule,state}`, appends to a
  bounded transition ring (the /alertz payload), and — once per firing
  episode — triggers a watchdog flight record (`notify_alert`, the
  overload-cooldown discipline). `pressure_hint()` collapses the
  firing set into a [0, 1] scalar the router's rebalancer consumes.
* built-in rules (`builtin_rules()`): multi-window SLO error-budget
  burn rate fed from `server_slo_{met,missed}_total` — page at 14.4×
  budget over 1h AND 5m, warn at 6× over 6h AND 30m — plus
  throughput-collapse, queue-growth, compile-storm
  (`serving_compiles_total`), and prefix-hit-ratio-drop detectors.
* `FleetHealth` — the one-call plane: store + sampler thread + engine
  + store-stat series (`timeseries_*`), registered as an "alerts"
  source with the debug server so `/alertz` and `/statusz` serve it
  without holding references; `close()` tears all of it down
  (sampler joined, source deregistered, every minted series retired).

Everything is off-by-default: importing this module registers nothing
and starts nothing; a process that never builds a FleetHealth/
AlertEngine keeps its registry family set and thread list
byte-identical (pinned in tests).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from collections import deque

from .metrics import MetricsRegistry, get_registry
from .timeseries import Sampler, TimeSeriesStore
from . import debug_server as _debug_server
from . import watchdog as _watchdog

__all__ = ["AlertRule", "AlertContext", "AlertEngine", "HealthConfig",
           "FleetHealth", "builtin_rules", "slo_burn_rate_rules",
           "SEVERITIES"]

# ranked mildest-first; pressure_hint()/health() weigh by rank
SEVERITIES = ("warn", "page")

# families the built-in rules read; FleetHealth tracks them by default
DEFAULT_TRACKED = (
    "server_slo_met_total", "server_slo_missed_total",
    "serving_tokens_out_total", "serving_active_slots",
    "serving_queue_depth", "serving_compiles_total",
    "serving_prefix_cache_hits_total",
    "serving_prefix_cache_misses_total",
)


class AlertRule:
    """One declarative rule. `expr(ctx)` returns a float measurement
    while the condition is VIOLATED (its value lands in the transition
    ring) and None while it is not — thresholds live inside the expr,
    the state machine lives in the engine."""

    def __init__(self, name: str,
                 expr: Callable[["AlertContext"], Optional[float]],
                 for_s: float = 0.0, clear_for_s: float = 0.0,
                 severity: str = "warn",
                 labels: Optional[Dict[str, str]] = None,
                 description: str = ""):
        if severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {severity!r}")
        if for_s < 0 or clear_for_s < 0:
            raise ValueError("for_s/clear_for_s must be >= 0")
        self.name = str(name)
        self.expr = expr
        self.for_s = float(for_s)
        self.clear_for_s = float(clear_for_s)
        self.severity = severity
        self.labels = dict(labels or {})
        self.description = description


class AlertContext:
    """What a rule expr sees: windowed reads of the store at one
    evaluation instant (every rule in a pass shares `now`)."""

    def __init__(self, store: TimeSeriesStore, now: float):
        self.store = store
        self.now = float(now)

    def rate(self, family: str, window_s: float,
             labels: Optional[Dict[str, Any]] = None,
             field: str = "value") -> Optional[float]:
        return self.store.rate(family, window_s, labels=labels,
                               field=field, now=self.now)

    def delta(self, family: str, window_s: float,
              labels: Optional[Dict[str, Any]] = None,
              field: str = "value") -> Optional[float]:
        return self.store.delta(family, window_s, labels=labels,
                                field=field, now=self.now)

    def value(self, family: str,
              labels: Optional[Dict[str, Any]] = None,
              field: str = "value") -> Optional[float]:
        return self.store.latest(family, labels=labels, field=field)

    def p_quantile(self, family: str, q: float, window_s: float,
                   labels: Optional[Dict[str, Any]] = None,
                   field: str = "value") -> Optional[float]:
        return self.store.p_quantile(family, q, window_s, labels=labels,
                                     field=field, now=self.now)

    def error_ratio(self, err_family: str, ok_family: str,
                    window_s: float) -> Optional[float]:
        """errors / (errors + successes) over the window, from two
        counter families; None until both rates exist and the total is
        positive — a ratio with no observations is unknown, not 0."""
        err = self.rate(err_family, window_s)
        ok = self.rate(ok_family, window_s)
        if err is None or ok is None:
            return None
        total = err + ok
        if total <= 0:
            return None
        return err / total


class AlertEngine:
    """Rule evaluation + alert state machine + export surfaces.

    Registry families (`server_alerts_firing`,
    `server_alert_transitions_total`, `server_health_score`) are
    created at CONSTRUCTION — an engine only exists when the health
    plane is on, so the disabled family set stays pinned. `label`
    scopes the series (`source="<label>"`) so two routers' planes in
    one process never fight over a gauge; `unregister()` retires every
    series this engine minted."""

    def __init__(self, store: TimeSeriesStore,
                 rules: Sequence[AlertRule] = (),
                 registry: Optional[MetricsRegistry] = None,
                 clock: Optional[Callable[[], float]] = None,
                 label: str = "0", transitions: int = 256,
                 on_fire: Optional[Callable[[str, str], Any]] = None,
                 flight_records: bool = True):
        self.store = store
        self._registry = registry or get_registry()
        self._clock = clock if clock is not None else store.clock
        self.label = str(label)
        self._on_fire = on_fire
        self.flight_records = bool(flight_records)
        self._lock = threading.Lock()
        self._rules: List[AlertRule] = []
        # rule name -> {"state", "since", "pending_since", "ok_since",
        #               "value"}
        self._states: Dict[str, Dict[str, Any]] = {}
        self._transitions: deque = deque(maxlen=int(transitions))
        self.transitions_total = 0
        self._firing_fam = self._registry.gauge(
            "server_alerts_firing",
            "1 while the named alert rule is firing, by severity")
        self._trans_fam = self._registry.counter(
            "server_alert_transitions_total",
            "alert state transitions, by rule and new state")
        self._score_fam = self._registry.gauge(
            "server_health_score",
            "fleet health score in [0, 100]: 100 minus severity-"
            "weighted firing-alert penalties")
        self._score = self._score_fam.labels(source=self.label)
        self._score.set(100.0)
        self._minted: set = set()   # (fam, label items) for unregister()
        for r in rules:
            self.add_rule(r)

    # -- rule management -----------------------------------------------------

    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            if any(r.name == rule.name for r in self._rules):
                raise ValueError(
                    f"alert rule {rule.name!r} already registered")
            self._rules.append(rule)
            self._states[rule.name] = {
                "state": "ok", "since": self._clock(),
                "pending_since": None, "ok_since": None, "value": None}

    def rules(self) -> List[AlertRule]:
        with self._lock:
            return list(self._rules)

    # -- state machine -------------------------------------------------------

    def _series(self, fam, **labels):
        key = (fam, tuple(sorted(labels.items())))
        self._minted.add(key)
        return fam.labels(**labels)

    def _record(self, now: float, rule: AlertRule, old: str, new: str,
                value: Optional[float]) -> None:
        self._transitions.append({
            "ts_monotonic": round(now, 6), "ts_unix": time.time(),
            "rule": rule.name, "severity": rule.severity,
            "from": old, "to": new,
            "value": value, "labels": dict(rule.labels)})
        self.transitions_total += 1
        self._series(self._trans_fam, source=self.label,
                     rule=rule.name, state=new).inc()

    def evaluate(self, now: Optional[float] = None) -> List[str]:
        """One evaluation pass over every rule; returns the names
        currently firing. Fire/resolve hold-downs: a violation must
        persist `for_s` before firing, and a firing rule must stay
        clean `clear_for_s` before resolving — flapping near a
        threshold cannot page."""
        ts = self._clock() if now is None else float(now)
        ctx = AlertContext(self.store, ts)
        fired: List[Tuple[AlertRule, Optional[float]]] = []
        with self._lock:
            for rule in self._rules:
                st = self._states[rule.name]
                try:
                    value = rule.expr(ctx)
                except Exception:
                    value = None     # a broken expr must not page
                violating = value is not None
                st["value"] = value
                if st["state"] == "ok":
                    if violating:
                        st["pending_since"] = ts
                        if rule.for_s <= 0:
                            self._to_firing(ts, rule, st, value, fired)
                        else:
                            st["state"], st["since"] = "pending", ts
                            self._record(ts, rule, "ok", "pending",
                                         value)
                elif st["state"] == "pending":
                    if not violating:
                        st["state"], st["since"] = "ok", ts
                        st["pending_since"] = None
                        self._record(ts, rule, "pending", "ok", value)
                    elif ts - st["pending_since"] >= rule.for_s:
                        self._to_firing(ts, rule, st, value, fired)
                else:   # firing
                    if violating:
                        st["ok_since"] = None
                    else:
                        if st["ok_since"] is None:
                            st["ok_since"] = ts
                        if ts - st["ok_since"] >= rule.clear_for_s:
                            st["state"], st["since"] = "ok", ts
                            st["pending_since"] = None
                            st["ok_since"] = None
                            self._record(ts, rule, "firing", "ok",
                                         value)
                            self._series(
                                self._firing_fam, source=self.label,
                                rule=rule.name,
                                severity=rule.severity).set(0)
            firing = [r.name for r in self._rules
                      if self._states[r.name]["state"] == "firing"]
            self._score.set(self._score_locked())
        # episode hooks OUTSIDE the lock: a flight record serializes
        # stacks + registry and must not block concurrent evaluates
        for rule, value in fired:
            if self._on_fire is not None:
                self._on_fire(rule.name, rule.severity)
            elif self.flight_records:
                _watchdog.notify_alert(rule.name, rule.severity)
        return firing

    def _to_firing(self, ts: float, rule: AlertRule,
                   st: Dict[str, Any], value: Optional[float],
                   fired: List) -> None:
        old = st["state"]
        st["state"], st["since"] = "firing", ts
        st["ok_since"] = None
        self._record(ts, rule, old, "firing", value)
        self._series(self._firing_fam, source=self.label,
                     rule=rule.name, severity=rule.severity).set(1)
        fired.append((rule, value))

    # -- export --------------------------------------------------------------

    def firing(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [self._rule_row_locked(r) for r in self._rules
                    if self._states[r.name]["state"] == "firing"]

    def _rule_row_locked(self, rule: AlertRule) -> Dict[str, Any]:
        st = self._states[rule.name]
        return {"rule": rule.name, "severity": rule.severity,
                "state": st["state"],
                "since_s": round(max(0.0, self._clock() - st["since"]),
                                 3),
                "for_s": rule.for_s, "clear_for_s": rule.clear_for_s,
                "value": st["value"], "labels": dict(rule.labels),
                "description": rule.description}

    def transitions(self, limit: Optional[int] = None) \
            -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._transitions)
        if limit is not None:
            out = out[-limit:] if limit else []
        return out

    def _score_locked(self) -> float:
        score = 100.0
        for r in self._rules:
            if self._states[r.name]["state"] != "firing":
                continue
            score -= 40.0 if r.severity == "page" else 10.0
        return max(0.0, score)

    def health(self) -> Dict[str, Any]:
        """The /statusz rollup for this engine: worst firing severity
        as status + the penalty score."""
        with self._lock:
            firing = [r for r in self._rules
                      if self._states[r.name]["state"] == "firing"]
            score = self._score_locked()
        status = "ok"
        for r in firing:
            if r.severity == "page":
                status = "page"
                break
            status = "warn"
        return {"status": status, "score": score,
                "firing": [r.name for r in firing]}

    def pressure_hint(self) -> float:
        """Firing severity collapsed to [0, 1] for the rebalancer:
        1.0 while a page-severity rule fires, 0.5 for warn, 0.0
        clean."""
        with self._lock:
            worst = 0.0
            for r in self._rules:
                if self._states[r.name]["state"] != "firing":
                    continue
                worst = max(worst,
                            1.0 if r.severity == "page" else 0.5)
            return worst

    def snapshot(self) -> Dict[str, Any]:
        """The per-source /alertz payload."""
        with self._lock:
            rules = [self._rule_row_locked(r) for r in self._rules]
            transitions = list(self._transitions)
        return {"label": self.label, "rules": rules,
                "firing": [r["rule"] for r in rules
                           if r["state"] == "firing"],
                "transitions_total": self.transitions_total,
                "transitions": transitions,
                "health": self.health()}

    def unregister(self) -> None:
        """Retire every series this engine minted (close()
        discipline)."""
        self._score_fam.remove(source=self.label)
        minted, self._minted = self._minted, set()
        for fam, items in minted:
            fam.remove(**dict(items))


# ---------------------------------------------------------------------------
# built-in rules
# ---------------------------------------------------------------------------

def _burn_expr(slo_target: float, factor: float, long_s: float,
               short_s: float):
    """Multi-window burn-rate condition: error budget consumption must
    exceed `factor`× budget over BOTH windows (the long window carries
    significance, the short one proves it is still happening — the SRE
    workbook recipe). Returns the short-window burn rate while
    violated."""
    budget = 1.0 - float(slo_target)
    if budget <= 0:
        raise ValueError(
            f"slo_target must be < 1.0, got {slo_target}")

    def expr(ctx: AlertContext) -> Optional[float]:
        long_r = ctx.error_ratio("server_slo_missed_total",
                                 "server_slo_met_total", long_s)
        short_r = ctx.error_ratio("server_slo_missed_total",
                                  "server_slo_met_total", short_s)
        if long_r is None or short_r is None:
            return None
        long_b, short_b = long_r / budget, short_r / budget
        if long_b >= factor and short_b >= factor:
            return round(short_b, 4)
        return None
    return expr


def slo_burn_rate_rules(slo_target: float = 0.99) -> List[AlertRule]:
    """The two-tier multi-window burn-rate pair over the
    `server_slo_{met,missed}_total` counters: page at 14.4× budget
    over 1h+5m (2% of a 30-day budget in one hour), warn at 6× over
    6h+30m (5% in six hours)."""
    return [
        AlertRule(
            "slo_burn_rate_page",
            _burn_expr(slo_target, 14.4, 3600.0, 300.0),
            severity="page", clear_for_s=300.0,
            labels={"slo_target": str(slo_target)},
            description="SLO error budget burning at >= 14.4x over "
                        "1h and 5m"),
        AlertRule(
            "slo_burn_rate_warn",
            _burn_expr(slo_target, 6.0, 21600.0, 1800.0),
            severity="warn", clear_for_s=1800.0,
            labels={"slo_target": str(slo_target)},
            description="SLO error budget burning at >= 6x over "
                        "6h and 30m"),
    ]


def _throughput_collapse_expr(window_s: float):
    def expr(ctx: AlertContext) -> Optional[float]:
        tokens_rate = ctx.rate("serving_tokens_out_total", window_s)
        active = ctx.value("serving_active_slots")
        if tokens_rate is None or active is None or active <= 0:
            return None
        if tokens_rate <= 0:
            return float(active)   # slots stuck with zero emission
        return None
    return expr


def _queue_growth_expr(window_s: float, min_growth: float):
    def expr(ctx: AlertContext) -> Optional[float]:
        growth = ctx.delta("serving_queue_depth", window_s)
        if growth is None or growth < min_growth:
            return None
        return float(growth)
    return expr


def _compile_storm_expr(window_s: float, max_per_s: float):
    def expr(ctx: AlertContext) -> Optional[float]:
        r = ctx.rate("serving_compiles_total", window_s)
        if r is None or r <= max_per_s:
            return None
        return round(r, 6)
    return expr


def _prefix_hit_drop_expr(window_s: float, min_ratio: float):
    def expr(ctx: AlertContext) -> Optional[float]:
        hits = ctx.rate("serving_prefix_cache_hits_total", window_s)
        misses = ctx.rate("serving_prefix_cache_misses_total", window_s)
        if hits is None or misses is None:
            return None
        total = hits + misses
        if total <= 0:
            return None
        hit_ratio = hits / total
        if hit_ratio >= min_ratio:
            return None
        return round(hit_ratio, 4)
    return expr


def builtin_rules(slo_target: float = 0.99,
                  throughput_window_s: float = 60.0,
                  queue_window_s: float = 120.0,
                  queue_min_growth: float = 4.0,
                  compile_window_s: float = 300.0,
                  compile_max_per_s: float = 0.1,
                  prefix_window_s: float = 600.0,
                  prefix_min_ratio: float = 0.5) -> List[AlertRule]:
    """The default detector set: SLO burn-rate pair + anomaly
    detectors. Every rule degrades to silent (expr returns None) while
    its input families are absent — an engine without the SLO plane or
    the tick profiler simply never evaluates those rules hot."""
    rules = slo_burn_rate_rules(slo_target)
    rules += [
        AlertRule("throughput_collapse",
                  _throughput_collapse_expr(throughput_window_s),
                  for_s=30.0, clear_for_s=30.0, severity="page",
                  description="active slots held tokens but emitted "
                              "none over the window"),
        AlertRule("queue_growth",
                  _queue_growth_expr(queue_window_s, queue_min_growth),
                  for_s=60.0, clear_for_s=60.0, severity="warn",
                  description="admission queue grew monotonically "
                              "over the window"),
        AlertRule("compile_storm",
                  _compile_storm_expr(compile_window_s,
                                      compile_max_per_s),
                  clear_for_s=300.0, severity="warn",
                  description="steady-state compile rate — shape "
                              "churn is defeating the bucketing"),
        AlertRule("prefix_hit_ratio_drop",
                  _prefix_hit_drop_expr(prefix_window_s,
                                        prefix_min_ratio),
                  for_s=60.0, clear_for_s=120.0, severity="warn",
                  description="prefix-cache hit ratio fell below the "
                              "floor while traffic flowed"),
    ]
    return rules


# ---------------------------------------------------------------------------
# the one-call plane
# ---------------------------------------------------------------------------

class HealthConfig:
    """Knobs for a FleetHealth plane. `interval_s`/`capacity` bound the
    history window (capacity × interval seconds of lookback; the 6h
    warn-tier burn window wants interval_s × capacity ≥ 21600);
    `rules` appends custom AlertRules after the built-ins (or replaces
    them with `builtin=False`); `track` adds registry families to the
    store beyond the built-in rule inputs."""

    def __init__(self, interval_s: float = 30.0, capacity: int = 1024,
                 max_series: int = 1024, slo_target: float = 0.99,
                 builtin: bool = True,
                 rules: Sequence[AlertRule] = (),
                 track: Sequence[str] = (),
                 transitions: int = 256,
                 flight_records: bool = True):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.max_series = int(max_series)
        self.slo_target = float(slo_target)
        self.builtin = bool(builtin)
        self.rules = tuple(rules)
        self.track = tuple(track)
        self.transitions = int(transitions)
        self.flight_records = bool(flight_records)


class FleetHealth:
    """Store + sampler + alert engine, wired: construct (families
    registered), `start()` (sampler thread up, /alertz//statusz source
    registered), `close()` (thread joined, source deregistered, series
    retired). `tick()` drives one sample+evaluate pass by hand — the
    fake-clock test path, and exactly what the sampler thread runs."""

    def __init__(self, config: Optional[HealthConfig] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 label: str = "0"):
        self.config = config or HealthConfig()
        self._registry = registry or get_registry()
        self.label = str(label)
        self.store = TimeSeriesStore(
            registry=self._registry, capacity=self.config.capacity,
            max_series=self.config.max_series, clock=clock)
        self.store.track(*DEFAULT_TRACKED)
        if self.config.track:
            self.store.track(*self.config.track)
        rules: List[AlertRule] = []
        if self.config.builtin:
            rules += builtin_rules(self.config.slo_target)
        rules += list(self.config.rules)
        self.engine = AlertEngine(
            self.store, rules, registry=self._registry, clock=clock,
            label=self.label, transitions=self.config.transitions,
            flight_records=self.config.flight_records)
        self.sampler = Sampler(self.store, self.config.interval_s,
                               on_sample=self._after_sample)
        # store-stat series (the "timeseries_*" families): lifetime
        # churn counters + occupancy gauge, refreshed per tick
        lbl = {"source": self.label}
        self._stat_fams = {
            "points": self._registry.counter(
                "timeseries_points_total",
                "points appended into the health-plane history rings"),
            "dropped": self._registry.counter(
                "timeseries_dropped_series_total",
                "series refused by the history cardinality cap"),
            "evicted": self._registry.counter(
                "timeseries_evicted_series_total",
                "history rings evicted for retired registry labels"),
            "series": self._registry.gauge(
                "timeseries_tracked_series",
                "history rings currently held by the health plane"),
        }
        self._stats = {k: f.labels(**lbl)
                       for k, f in self._stat_fams.items()}
        # last store-stat values mirrored into the counters (counters
        # advance by delta; only tick() writes, so no lock needed)
        self._stat_last = {"points": 0, "dropped": 0, "evicted": 0}
        self._closed = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetHealth":
        if self._closed:
            raise RuntimeError("FleetHealth was closed; build a new one")
        _debug_server.register_perf_source("alerts", self.label,
                                           self.snapshot)
        self.sampler.start()
        return self

    def close(self) -> None:
        """Idempotent teardown: sampler joined, debug-server source
        deregistered, every series (alert gauges + stat series)
        retired from the registry."""
        if self._closed:
            return
        self._closed = True
        self.sampler.stop()
        _debug_server.unregister_perf_source("alerts", self.label)
        self.engine.unregister()
        for fam in self._stat_fams.values():
            fam.remove(source=self.label)

    # -- one pass ------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> List[str]:
        """sample + evaluate + refresh stat series; returns the firing
        rule names. The sampler thread's body and the test/fake-clock
        entry point."""
        self.store.sample(now=now)
        firing = self.engine.evaluate(now=now)
        self._refresh_stats()
        return firing

    def _after_sample(self) -> None:
        """The sampler thread's post-sample hook (the thread already
        sampled; tick() is the by-hand equivalent of one period)."""
        self.engine.evaluate()
        self._refresh_stats()

    def _refresh_stats(self) -> None:
        s = self.store.stats()
        for key, cur in (("points", s["points_total"]),
                         ("dropped", s["dropped_series"]),
                         ("evicted", s["evicted_series"])):
            delta = cur - self._stat_last[key]
            if delta > 0:
                self._stats[key].inc(delta)
                self._stat_last[key] = cur
        self._stats["series"].set(s["series"])

    # -- export --------------------------------------------------------------

    def pressure_hint(self) -> float:
        return self.engine.pressure_hint()

    def health(self) -> Dict[str, Any]:
        return self.engine.health()

    def snapshot(self) -> Dict[str, Any]:
        """The /alertz source payload: engine snapshot + store stats
        + sampler state."""
        snap = self.engine.snapshot()
        snap["store"] = self.store.stats()
        snap["sampler"] = {"running": self.sampler.running,
                           "interval_s": self.sampler.interval_s}
        return snap
