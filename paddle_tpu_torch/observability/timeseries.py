"""Bounded in-process time-series history over the metrics registry.

A copy of `paddle_tpu/observability/timeseries.py` (pure Python).

The registry (`observability.metrics`) answers "what is the value NOW";
nothing in the process can answer "is this replica getting worse" — the
windowed-rate signal burn-rate alerting, autoscaling, and the
rebalancer's pressure hints all need. This module is that layer, kept
deliberately tiny (no external TSDB, no persistence):

* `TimeSeriesStore` — registry families opt in by name (`track()`);
  each `sample()` poll appends one `(monotonic_ts, value)` point per
  live series into a fixed ring of `capacity` points. Counters and
  gauges record their `value`; histogram series record their
  cumulative `count` and `sum` sub-series (enough to derive windowed
  event rates and mean-latency trends without storing raw samples).
  Cardinality is capped at `max_series` rings — series past the cap
  are counted in `dropped_series`, never stored — and series whose
  labels retire from the registry (EngineMetrics/RouterMetrics
  `unregister()`/`close()` discipline) are evicted on the next poll,
  so a long-lived process recreating engines cannot accumulate dead
  rings.
* windowed derivations — `rate()` (per-second counter increase,
  reset-aware), `delta()` (last − first), `p_quantile()`
  (nearest-rank over the windowed point values). With `labels=None`
  they aggregate across every series of the family (rates/deltas sum,
  quantiles pool) — the fleet-level view the built-in alert rules
  evaluate.
* `Sampler` — a daemon thread calling `store.sample()` every
  `interval_s` (plus an optional `on_sample` hook — the alert engine
  evaluates there, so one thread runs the whole health plane). The
  store clock is injectable (`clock=`), so tests drive `sample()` by
  hand under a fake clock and never need the thread.

Nothing here registers metric families or starts threads at import:
the disabled path of every consumer stays byte-identical.
"""

from __future__ import annotations

import math
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .metrics import MetricsRegistry, get_registry

__all__ = ["TimeSeriesStore", "Sampler"]

# histogram series are decomposed into these cumulative sub-series —
# rate(count) is the event rate, rate(sum)/rate(count) the windowed mean
_HIST_FIELDS = ("count", "sum")


class TimeSeriesStore:
    """Fixed-ring point history for opted-in registry families."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 capacity: int = 512, max_series: int = 1024,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2 (rate/delta need "
                             f"two points), got {capacity}")
        if max_series < 1:
            raise ValueError(f"max_series must be >= 1, got {max_series}")
        self._registry = registry or get_registry()
        self.capacity = int(capacity)
        self.max_series = int(max_series)
        self.clock = clock
        self._lock = threading.Lock()
        # (family, sorted label items, field) -> deque[(ts, value)]
        self._rings: Dict[Tuple[str, tuple, str], deque] = {}
        self._tracked: Dict[str, None] = {}   # insertion-ordered set
        self.samples_total = 0      # sample() polls run
        self.points_total = 0       # points appended across all polls
        self.dropped_series = 0     # series refused by the cap
        self.evicted_series = 0     # rings dropped for retired labels

    # -- family opt-in -------------------------------------------------------

    def track(self, *families: str) -> "TimeSeriesStore":
        """Opt registry families into history (chainable). Unknown
        names are fine — a family that does not exist yet simply
        contributes no points until something registers it."""
        with self._lock:
            for f in families:
                self._tracked[str(f)] = None
        return self

    def untrack(self, family: str) -> None:
        """Drop a family and every ring it grew."""
        with self._lock:
            self._tracked.pop(family, None)
            for key in [k for k in self._rings if k[0] == family]:
                del self._rings[key]

    def tracked(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._tracked)

    # -- sampling ------------------------------------------------------------

    def sample(self, now: Optional[float] = None) -> int:
        """One poll: append a point per live series of every tracked
        family, evict rings whose series left the registry. Returns the
        number of points appended."""
        ts = self.clock() if now is None else float(now)
        snap = self._registry.snapshot()
        with self._lock:
            live: set = set()
            written = 0
            for family in self._tracked:
                fam = snap.get(family)
                if fam is None:
                    continue
                is_hist = fam.get("type") == "histogram"
                fields = _HIST_FIELDS if is_hist else ("value",)
                for row in fam.get("series", []):
                    lkey = tuple(sorted(row["labels"].items()))
                    for field in fields:
                        key = (family, lkey, field)
                        live.add(key)
                        ring = self._rings.get(key)
                        if ring is None:
                            if len(self._rings) >= self.max_series:
                                self.dropped_series += 1
                                continue
                            ring = self._rings[key] = deque(
                                maxlen=self.capacity)
                        ring.append((ts, float(row.get(field) or 0.0)))
                        written += 1
            # retired labels: a series gone from the snapshot loses its
            # ring NOW — history must not outlive the series identity
            # (a rebuilt engine reusing the label starts clean)
            for key in [k for k in self._rings if k not in live]:
                del self._rings[key]
                self.evicted_series += 1
            self.samples_total += 1
            self.points_total += written
            return written

    # -- point access --------------------------------------------------------

    def _match(self, family: str, labels: Optional[Dict[str, Any]],
               field: str) -> List[deque]:
        """Rings for `family`/`field`; labels=None matches every series,
        a dict matches series carrying AT LEAST those label pairs."""
        want = None if labels is None else {
            (k, str(v)) for k, v in labels.items()}
        out = []
        for (f, lkey, fld), ring in self._rings.items():
            if f != family or fld != field:
                continue
            if want is not None and not want <= set(lkey):
                continue
            out.append(ring)
        return out

    def points(self, family: str, labels: Optional[Dict[str, Any]] = None,
               field: str = "value") -> List[Tuple[float, float]]:
        """All stored points for matching series, time-ordered."""
        with self._lock:
            pts = [p for ring in self._match(family, labels, field)
                   for p in ring]
        return sorted(pts)

    def latest(self, family: str, labels: Optional[Dict[str, Any]] = None,
               field: str = "value") -> Optional[float]:
        """Sum of each matching series' newest point (None if no
        series has any) — the 'current value' read for gauges."""
        with self._lock:
            newest = [ring[-1][1]
                      for ring in self._match(family, labels, field)
                      if ring]
        return sum(newest) if newest else None

    # -- windowed derivations ------------------------------------------------

    def _windowed(self, ring: deque, since: float) -> List[Tuple[float,
                                                                 float]]:
        return [p for p in ring if p[0] >= since]

    def rate(self, family: str, window_s: float,
             labels: Optional[Dict[str, Any]] = None,
             field: str = "value",
             now: Optional[float] = None) -> Optional[float]:
        """Per-second counter increase over the window, reset-aware (a
        decrease reads as a counter restart from zero, Prometheus-style).
        Summed across matching series; None until some series has two
        in-window points."""
        ts = self.clock() if now is None else float(now)
        since = ts - float(window_s)
        total = None
        with self._lock:
            rings = self._match(family, labels, field)
            windows = [self._windowed(r, since) for r in rings]
        for pts in windows:
            if len(pts) < 2:
                continue
            span = pts[-1][0] - pts[0][0]
            if span <= 0:
                continue
            increase = 0.0
            for (_, prev), (_, cur) in zip(pts, pts[1:]):
                increase += cur - prev if cur >= prev else cur
            total = (total or 0.0) + increase / span
        return total

    def delta(self, family: str, window_s: float,
              labels: Optional[Dict[str, Any]] = None,
              field: str = "value",
              now: Optional[float] = None) -> Optional[float]:
        """last − first over the window (gauge growth), summed across
        matching series; None until some series has two in-window
        points."""
        ts = self.clock() if now is None else float(now)
        since = ts - float(window_s)
        total = None
        with self._lock:
            rings = self._match(family, labels, field)
            windows = [self._windowed(r, since) for r in rings]
        for pts in windows:
            if len(pts) < 2:
                continue
            total = (total or 0.0) + (pts[-1][1] - pts[0][1])
        return total

    def p_quantile(self, family: str, q: float, window_s: float,
                   labels: Optional[Dict[str, Any]] = None,
                   field: str = "value",
                   now: Optional[float] = None) -> Optional[float]:
        """Nearest-rank quantile over the pooled in-window point values
        of matching series; None when the window is empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        ts = self.clock() if now is None else float(now)
        since = ts - float(window_s)
        with self._lock:
            values = [v for ring in self._match(family, labels, field)
                      for t, v in ring if t >= since]
        if not values:
            return None
        values.sort()
        return values[max(0, math.ceil(q * len(values)) - 1)]

    # -- introspection -------------------------------------------------------

    def series_count(self) -> int:
        with self._lock:
            return len(self._rings)

    def stats(self) -> Dict[str, Any]:
        """The /statusz store block: occupancy + lifetime churn."""
        with self._lock:
            return {
                "tracked_families": list(self._tracked),
                "series": len(self._rings),
                "max_series": self.max_series,
                "capacity": self.capacity,
                "samples_total": self.samples_total,
                "points_total": self.points_total,
                "dropped_series": self.dropped_series,
                "evicted_series": self.evicted_series,
            }


class Sampler:
    """Daemon thread driving `store.sample()` every `interval_s`, with
    an optional post-sample hook (the alert engine's evaluate — one
    thread runs sampling AND alerting, and zero threads exist until
    start())."""

    def __init__(self, store: TimeSeriesStore, interval_s: float = 5.0,
                 on_sample: Optional[Callable[[], Any]] = None):
        if interval_s <= 0:
            raise ValueError(
                f"interval_s must be > 0, got {interval_s}")
        self.store = store
        self.interval_s = float(interval_s)
        self.on_sample = on_sample
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "Sampler":
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="pt-health-sampler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.store.sample()
                if self.on_sample is not None:
                    self.on_sample()
            except Exception:
                # the health plane must never take the service down
                traceback.print_exc()
