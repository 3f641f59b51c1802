"""Process-wide metrics registry: counters and gauges.

A copy of the counter and gauge half of `paddle_tpu/observability/
metrics.py`: every subsystem registers labeled series under stable names
(`executor_runs_total`, ...) in one registry. The histograms and the
JSON / Prometheus exports come over with the slice that first reads them.

Semantics follow the Prometheus data model:

* `Counter` — monotonically increasing (`inc`). `set()` exists for
  adapters that mirror an externally-maintained count; application code
  should only `inc`.
* `Gauge` — set/inc/dec to the current value.

Each metric family (name + type + help) holds one series per distinct
label set; the family object itself proxies the empty-label series so
unlabeled use reads naturally (`registry.counter("steps").inc()`).
All mutation is lock-protected.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Tuple

__all__ = ["Counter", "Gauge", "MetricsRegistry", "get_registry"]

class Counter:
    """One monotonic series."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter can only increase, got {amount}")
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        """Adapter hook: mirror an externally-kept count. Prefer inc()."""
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """One point-in-time series."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


_KINDS = {"counter": Counter, "gauge": Gauge}


class MetricFamily:
    """name + type + help, holding one series per distinct label set.
    Proxies the empty-label series for unlabeled use."""

    def __init__(self, name: str, kind: str, help: str = ""):
        self.name = name
        self.kind = kind
        self.help = help
        self._series: Dict[Tuple[Tuple[str, str], ...], Any] = {}
        self._lock = threading.Lock()

    def labels(self, **labels: Any):
        """Get or create the series for this label set."""
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = _KINDS[self.kind]()
                self._series[key] = series
            return series

    # unlabeled convenience: family.inc() == family.labels().inc()
    def inc(self, amount: float = 1.0):
        return self.labels().inc(amount)

    def dec(self, amount: float = 1.0):
        return self.labels().dec(amount)

    def set(self, value: float):
        return self.labels().set(value)

    @property
    def value(self):
        return self.labels().value


class MetricsRegistry:
    """Process-wide name -> MetricFamily map."""

    def __init__(self):
        self._families: Dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    def _family(self, name: str, kind: str, help: str) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(name, kind, help)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            return fam

    def counter(self, name: str, help: str = "") -> MetricFamily:
        return self._family(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> MetricFamily:
        return self._family(name, "gauge", help)

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return list(self._families.values())


_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry all subsystems publish into."""
    return _GLOBAL
