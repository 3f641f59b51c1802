"""Process-wide metrics registry: counters, gauges, histograms.

A copy of `paddle_tpu/observability/metrics.py` (pure Python; the port
keeps its own so it never imports the JAX package).

The reference framework's operational numbers live in scattered places
(profiler event tables, per-module counters); a serving deployment needs
ONE scrape surface. This registry is that surface: every subsystem
registers labeled series under stable names (`serving_ttft_seconds`,
`serving_queue_depth`, ...) and an operator reads them either as a JSON
snapshot (`registry.snapshot()` — what `ServingEngine.stats()` and the
benches consume) or as Prometheus text exposition (`to_prometheus()` —
what a scraper consumes). No external metrics framework: the container
has none, and the formats are tiny.

Semantics follow the Prometheus data model:

* `Counter` — monotonically increasing (`inc`). `set()` exists for
  adapters that mirror an externally-maintained count (the serving
  engine's `metrics.submitted += 1` style); application code should
  only `inc`.
* `Gauge` — set/inc/dec to the current value.
* `Histogram` — fixed cumulative buckets (for Prometheus) plus a
  bounded ring of recent raw observations (for p50/p99 quantiles —
  the registry-sourced TTFT/TPOT percentiles the serving bench
  reports). The ring keeps the most recent `max_samples` values, so
  quantiles reflect the current window, deterministically (no
  reservoir randomness).

Each metric family (name + type + help) holds one series per distinct
label set; the family object itself proxies the empty-label series so
unlabeled use reads naturally (`registry.counter("steps").inc()`).
All mutation is lock-protected — series are updated from serving
threads, the communicator's send/recv threads, and test threads at
once.
"""

from __future__ import annotations

import bisect
import json
import math
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "DEFAULT_BUCKETS"]

# latency-flavored default buckets, in seconds (sub-ms to 10 s)
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


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


class Histogram:
    """Cumulative-bucket histogram + bounded recent-sample ring.

    Buckets serve the Prometheus exposition; the sample ring serves
    `quantile()` (nearest-rank over the most recent `max_samples`
    observations)."""

    __slots__ = ("_lock", "_bounds", "_bucket_counts", "_sum", "_count",
                 "_min", "_max", "_samples", "_max_samples")

    def __init__(self, buckets: Optional[Sequence[float]] = None,
                 max_samples: int = 4096):
        self._lock = threading.Lock()
        self._bounds = tuple(sorted(buckets if buckets is not None
                                    else DEFAULT_BUCKETS))
        self._bucket_counts = [0] * (len(self._bounds) + 1)  # +Inf last
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._samples: List[float] = []
        self._max_samples = int(max_samples)

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._bucket_counts[bisect.bisect_left(self._bounds, value)] += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value
            if len(self._samples) < self._max_samples:
                self._samples.append(value)
            else:  # ring: overwrite oldest — quantiles track the recent window
                self._samples[self._count % self._max_samples] = value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> Optional[float]:
        return self._sum / self._count if self._count else None

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile over the recent-sample window; None when
        empty. q in [0, 1]."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if not self._samples:
                return None
            ordered = sorted(self._samples)
        rank = max(0, math.ceil(q * len(ordered)) - 1)
        return ordered[rank]

    def _cumulative(self, counts: List[int]) -> List[Tuple[str, int]]:
        out: List[Tuple[str, int]] = []
        cum = 0
        for bound, c in zip(self._bounds, counts[:-1]):
            cum += c
            out.append((repr(bound), cum))
        out.append(("+Inf", cum + counts[-1]))
        return out

    def cumulative_buckets(self) -> List[Tuple[str, int]]:
        """[(le, cumulative count)] ending with ("+Inf", count)."""
        with self._lock:
            counts = list(self._bucket_counts)
        return self._cumulative(counts)

    def describe(self) -> Dict[str, Any]:
        """One internally-consistent scrape row: every field comes from a
        SINGLE critical section (interleaved observes can't make count
        disagree with the buckets), and the sample window is sorted once
        for all three quantiles."""
        with self._lock:
            count, total = self._count, self._sum
            mn = self._min if self._count else None
            mx = self._max if self._count else None
            ordered = sorted(self._samples)
            counts = list(self._bucket_counts)

        def q(p: float) -> Optional[float]:
            if not ordered:
                return None
            return ordered[max(0, math.ceil(p * len(ordered)) - 1)]

        return {"count": count, "sum": total, "min": mn, "max": mx,
                "p50": q(0.5), "p90": q(0.9), "p99": q(0.99),
                "buckets": dict(self._cumulative(counts))}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """name + type + help, holding one series per distinct label set.
    Proxies the empty-label series for unlabeled use."""

    def __init__(self, name: str, kind: str, help: str = "", **series_kw):
        self.name = name
        self.kind = kind
        self.help = help
        self._series_kw = series_kw
        self._series: Dict[Tuple[Tuple[str, str], ...], Any] = {}
        self._lock = threading.Lock()

    def labels(self, _buckets: Optional[Sequence[float]] = None,
               **labels: Any):
        """Get or create the series for this label set. `_buckets`
        (histogram families only) overrides the family bucket layout for
        THIS series at creation — for count-scaled histograms whose
        natural range is a per-creator parameter (e.g. tokens-per-
        dispatch scales with an engine's decode_chunk × speculation
        factor, and engines with different settings share one process
        registry). The override is explicit per series, so the family-
        level conflict check below still guards against two creators
        silently misfiling into each other's layout; a later labels()
        call for an existing series ignores `_buckets`."""
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                kw = dict(self._series_kw)
                if _buckets is not None:
                    kw["buckets"] = tuple(_buckets)
                series = _KINDS[self.kind](**kw)
                self._series[key] = series
            return series

    def remove(self, **labels: Any) -> bool:
        """Drop the series for this label set (e.g. a retired serving
        engine) so scrapes stop reporting a dead label forever. Returns
        whether a series existed."""
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            return self._series.pop(key, None) is not None

    # unlabeled convenience: family.inc() == family.labels().inc()
    def inc(self, amount: float = 1.0):
        return self.labels().inc(amount)

    def dec(self, amount: float = 1.0):
        return self.labels().dec(amount)

    def set(self, value: float):
        return self.labels().set(value)

    def observe(self, value: float):
        return self.labels().observe(value)

    @property
    def value(self):
        return self.labels().value

    def quantile(self, q: float):
        return self.labels().quantile(q)

    def series_items(self) -> List[Tuple[Dict[str, str], Any]]:
        with self._lock:
            return [(dict(k), s) for k, s in self._series.items()]


class MetricsRegistry:
    """Process-wide name -> MetricFamily map with snapshot/export."""

    def __init__(self):
        self._families: Dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    def _family(self, name: str, kind: str, help: str,
                **series_kw) -> MetricFamily:
        # None means "caller didn't specify" — only explicit settings are
        # stored, and only explicit settings can conflict
        requested = {k: v for k, v in series_kw.items() if v is not None}
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(name, kind, help, **requested)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            else:
                for k, v in requested.items():
                    if fam._series_kw.get(k) != v:
                        # silently handing back a family with different
                        # buckets would misfile every observation
                        raise ValueError(
                            f"metric {name!r} already registered with "
                            f"{k}={fam._series_kw.get(k)!r}, requested "
                            f"{v!r}")
            return fam

    def counter(self, name: str, help: str = "") -> MetricFamily:
        return self._family(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> MetricFamily:
        return self._family(name, "gauge", help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  max_samples: Optional[int] = None) -> MetricFamily:
        """buckets/max_samples apply on first registration; a later call
        passing DIFFERENT explicit values raises (a silently ignored
        bucket layout would misfile observations). None = defaults."""
        return self._family(
            name, "histogram", help,
            buckets=tuple(buckets) if buckets is not None else None,
            max_samples=max_samples)

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return list(self._families.values())

    def reset(self) -> None:
        """Drop every family (tests / process reuse)."""
        with self._lock:
            self._families.clear()

    # -- export --------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view: {name: {type, help, series: [...]}}. Counter and
        gauge series carry `value`; histogram series carry count/sum/min/
        max/p50/p90/p99 and the cumulative buckets."""
        out: Dict[str, Any] = {}
        for fam in self.families():
            rows = []
            for labels, series in fam.series_items():
                if fam.kind == "histogram":
                    row: Dict[str, Any] = {"labels": labels}
                    row.update(series.describe())
                else:
                    row = {"labels": labels, "value": series.value}
                rows.append(row)
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": rows}
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self, aggregate_label: Optional[str] = None) -> str:
        """Prometheus text exposition format 0.0.4.

        `aggregate_label` merges every series carrying that label by
        dropping it: counters and gauges sum their values; histograms
        merge only when the colliding series share an identical bucket
        layout (cumulative per-bucket counts sum elementwise, `_sum`
        and `_count` add — cumulative counts are summable because each
        input is already cumulative over the same bounds). Series NOT
        carrying the label, and histogram series whose layouts differ,
        pass through unmerged. One scrape of a router with
        aggregate_label="engine" reads as fleet totals."""
        lines: List[str] = []
        for fam in self.families():
            name = _prom_name(fam.name)
            if fam.help:
                lines.append(f"# HELP {name} {_prom_escape(fam.help)}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for labels, series in self._export_series(fam, aggregate_label):
                if fam.kind == "histogram":
                    for le, cum in series["buckets"]:
                        lines.append(
                            f"{name}_bucket"
                            f"{_prom_labels({**labels, 'le': le})} {cum}")
                    lines.append(
                        f"{name}_sum{_prom_labels(labels)} "
                        f"{_prom_num(series['sum'])}")
                    lines.append(
                        f"{name}_count{_prom_labels(labels)} "
                        f"{series['count']}")
                else:
                    lines.append(f"{name}{_prom_labels(labels)} "
                                 f"{_prom_num(series['value'])}")
        return "\n".join(lines) + "\n"

    @staticmethod
    def _export_series(fam: MetricFamily,
                       aggregate_label: Optional[str]):
        """(labels, flat-series) pairs for exposition, optionally with
        `aggregate_label` dropped and colliding series merged."""
        flat: List[tuple] = []
        for labels, series in fam.series_items():
            if fam.kind == "histogram":
                flat.append((labels, {
                    "buckets": list(series.cumulative_buckets()),
                    "sum": series.sum, "count": series.count}))
            else:
                flat.append((labels, {"value": series.value}))
        if aggregate_label is None:
            return flat
        groups: Dict[tuple, List[tuple]] = {}
        order: List[tuple] = []
        for labels, data in flat:
            if aggregate_label not in labels:
                key = ("raw", len(order))
            else:
                kept = {k: v for k, v in labels.items()
                        if k != aggregate_label}
                key = ("agg", tuple(sorted(kept.items())))
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append((labels, data))
        out: List[tuple] = []
        for key in order:
            members = groups[key]
            if key[0] == "raw":
                out.extend(members)
                continue
            kept = {k: v for k, v in members[0][0].items()
                    if k != aggregate_label}
            if fam.kind != "histogram":
                out.append((kept, {"value": sum(d["value"]
                                                for _, d in members)}))
                continue
            layouts = {tuple(le for le, _ in d["buckets"])
                       for _, d in members}
            if len(layouts) > 1:
                # per-series `labels(_buckets=)` overrides gave this
                # group mismatched bucket layouts: cumulative counts
                # over different bounds are not summable, so fall back
                # to emitting these series unaggregated under their
                # ORIGINAL labels (dropping the aggregate label here
                # would emit duplicate label sets in the exposition)
                out.extend(members)
                continue
            acc = {"buckets": list(members[0][1]["buckets"]),
                   "sum": members[0][1]["sum"],
                   "count": members[0][1]["count"]}
            for _, d in members[1:]:
                acc["buckets"] = [
                    (le, a + b) for (le, a), (_, b)
                    in zip(acc["buckets"], d["buckets"])]
                acc["sum"] += d["sum"]
                acc["count"] += d["count"]
            out.append((kept, acc))
        return out


def _prom_name(name: str) -> str:
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not re.match(r"[a-zA-Z_:]", name):
        name = "_" + name
    return name


def _prom_label_name(name: str) -> str:
    # label names are [a-zA-Z_][a-zA-Z0-9_]* — unlike metric names, colons
    # are NOT allowed (they're reserved for recording rules)
    name = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    if not re.match(r"[a-zA-Z_]", name):
        name = "_" + name
    return name


def _prom_escape(text: str) -> str:
    """HELP-text escaping per the exposition format 0.0.4: backslash and
    line feed (a raw newline would split the comment into a bogus sample
    line)."""
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _prom_label_value(value: Any) -> str:
    """Label-value escaping per the exposition format 0.0.4: backslash,
    double-quote, and line feed — in that order (escaping the backslash
    last would re-mangle the escapes just written). Raw interpolation of
    any of the three corrupts the scrape: a quote terminates the value
    early, a newline splits the sample line."""
    return (str(value).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    parts = [f'{_prom_label_name(k)}="{_prom_label_value(labels[k])}"'
             for k in sorted(labels)]
    return "{" + ",".join(parts) + "}"


def _prom_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry all subsystems publish into."""
    return _GLOBAL
