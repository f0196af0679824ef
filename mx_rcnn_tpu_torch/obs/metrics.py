"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The port's own copy of ``mx_rcnn_tpu/obs/metrics.py`` (the port imports
nothing of the JAX package).  Stdlib-only and host-side by construction:
nothing here runs on the card.  Everything is thread-safe: hot paths touch one
``threading.Lock`` per metric family and do integer/float arithmetic —
no allocation beyond the first observation of a label set.

Rendering follows the Prometheus text exposition format 0.0.4, so the
``/metrics`` endpoint (obs/endpoint.py) can be scraped by a stock
Prometheus server; :meth:`Registry.snapshot` produces the same data as a
JSON-able dict for the periodic journal flush (headless runs keep the
numbers even with no scraper attached).

Histograms use FIXED buckets chosen at creation: cumulative bucket
counts + ``_sum``/``_count``, which is exactly what p50/p99 recording
rules need.  The default buckets cover serving latencies from 1 ms to
60 s.
"""

from __future__ import annotations

import re
import threading
from typing import Iterable, Optional, Sequence

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "SnapshotWindow",
    "snapshot_delta", "parse_labels", "percentile_from_counts",
    "DEFAULT_LATENCY_BUCKETS_S",
]

# 1ms .. 60s, roughly log-spaced: serving device calls sit mid-range,
# queue waits at the bottom, rebuild-shadowed tails at the top.
DEFAULT_LATENCY_BUCKETS_S: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Metric:
    """Shared name/help/label-children plumbing for one metric family."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def _header(self) -> list[str]:
        out = []
        if self.help:
            out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        return out


class Counter(_Metric):
    """Monotonic counter, optionally labelled via ``inc(**labels)``."""

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        out = self._header()
        for key, v in items or [((), 0.0)]:
            out.append(f"{self.name}{_label_str(key)} {v:g}")
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {_label_str(k) or "": v for k, v in self._values.items()}


class Gauge(_Metric):
    """Settable point-in-time value (queue depth, worker count, ...)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        out = self._header()
        for key, v in items or [((), 0.0)]:
            out.append(f"{self.name}{_label_str(key)} {v:g}")
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {_label_str(k) or "": v for k, v in self._values.items()}


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative counts + sum/count per labels)."""

    kind = "histogram"

    def __init__(
        self, name: str, help: str = "",
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
    ) -> None:
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one finite bucket")
        # per label-key: ([per-bucket counts...], count, sum)
        self._series: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [[0] * len(self.buckets), 0, 0.0]
            counts, _, _ = s
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            s[1] += 1
            s[2] += value

    def percentile(self, q: float, **labels) -> Optional[float]:
        """Bucket-upper-bound estimate of the q-quantile (0..1); None when
        the series is empty.  Good enough for journal flushes — Prometheus
        recording rules do the real interpolation server-side."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None or s[1] == 0:
                return None
            counts, total = list(s[0]), s[1]
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank and c:
                return self.buckets[i]
        return float("inf")

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(
                (k, (list(s[0]), s[1], s[2]))
                for k, s in self._series.items()
            )
        out = self._header()
        for key, (counts, count, total) in items:
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                lk = _label_str(key + (("le", f"{b:g}"),))
                out.append(f"{self.name}_bucket{lk} {cum}")
            lk = _label_str(key + (("le", "+Inf"),))
            out.append(f"{self.name}_bucket{lk} {count}")
            out.append(f"{self.name}_sum{_label_str(key)} {total:g}")
            out.append(f"{self.name}_count{_label_str(key)} {count}")
        return out

    def snapshot(self) -> dict:
        out = {}
        with self._lock:
            items = [(k, (list(s[0]), s[1], s[2]))
                     for k, s in self._series.items()]
        for key, (counts, count, total) in items:
            out[_label_str(key) or ""] = {
                "count": count,
                "sum": total,
                "p50": self.percentile(0.50, **dict(key)),
                "p99": self.percentile(0.99, **dict(key)),
                # Raw per-bucket counts + upper bounds: what windowed
                # deltas (snapshot_delta) need to rebuild a percentile
                # over just the window, not the whole run.
                "le": list(self.buckets),
                "buckets": counts,
            }
        return out


class Registry:
    """Name -> metric family; idempotent getters create on first use."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "",
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
    ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def families(self) -> Iterable[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def render(self) -> str:
        """Prometheus text exposition (0.0.4) of every family."""
        lines: list[str] = []
        for m in sorted(self.families(), key=lambda m: m.name):
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able {name: {labelstr: value|hist-summary}} for the
        periodic journal flush."""
        return {m.name: m.snapshot() for m in self.families()}


# ---------------------------------------------------------------------------
# Windowed snapshot deltas (burn-rate / autoscaler math without
# re-scraping Prometheus text)
# ---------------------------------------------------------------------------

_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def parse_labels(labelstr: str) -> dict:
    """``'{level="full",replica="0"}'`` -> ``{"level": "full", ...}``."""
    return dict(_LABEL_RE.findall(labelstr or ""))


def percentile_from_counts(
    le: Sequence[float], counts: Sequence[int], q: float
) -> Optional[float]:
    """Bucket-upper-bound q-quantile over raw (non-cumulative) bucket
    counts — same estimator as :meth:`Histogram.percentile`, usable on a
    windowed delta.  None when the counts are empty; +inf when the rank
    falls past the last finite bucket."""
    total = sum(counts)
    if total == 0:
        return None
    rank = q * total
    cum = 0
    for b, c in zip(le, counts):
        cum += c
        if cum >= rank and c:
            return b
    return float("inf")


def _series_delta(older, newer):
    """Delta of one series value (counter float or histogram summary).
    Counter resets (newer < older) clamp to the newer value, the usual
    rate() convention."""
    if isinstance(newer, dict):
        old = older if isinstance(older, dict) else {}
        oc = old.get("buckets") or []
        nc = newer.get("buckets") or []
        if len(oc) != len(nc):
            oc = [0] * len(nc)
        counts = [max(0, n - o) for n, o in zip(nc, oc)]
        le = newer.get("le") or []
        dcount = newer.get("count", 0) - old.get("count", 0)
        if dcount < 0:
            dcount, counts = newer.get("count", 0), list(nc)
        return {
            "count": dcount,
            "sum": newer.get("sum", 0.0) - old.get("sum", 0.0),
            "le": list(le),
            "buckets": counts,
            "p50": percentile_from_counts(le, counts, 0.50),
            "p99": percentile_from_counts(le, counts, 0.99),
        }
    new = float(newer)
    old = float(older) if isinstance(older, (int, float)) else 0.0
    return new if new < old else new - old


def snapshot_delta(older: dict, newer: dict) -> dict:
    """Per-series difference between two :meth:`Registry.snapshot`
    dicts: counters become increments over the interval, histogram
    summaries become windowed count/sum/buckets with percentiles
    recomputed over just the window.  Gauges are point-in-time, so a
    delta is meaningless — callers should read gauges from ``newer``
    directly; here they fall through the counter rule (delta of the
    stored value), which is still the honest interval change."""
    older = older or {}
    out: dict = {}
    for name, series in newer.items():
        old_series = older.get(name, {})
        out[name] = {
            label: _series_delta(old_series.get(label), value)
            for label, value in series.items()
        }
    return out


class SnapshotWindow:
    """Rolling ``(t, Registry.snapshot())`` pairs with rate/delta reads.

    The SLO engine and autoscaler (``ctrl/``) call
    :meth:`observe` once per evaluation period and read
    :meth:`delta_over` / :meth:`rate` instead of re-scraping the
    Prometheus text endpoint.  Thread-safe; bounded by ``horizon_s``
    (entries older than the horizon are dropped on observe).
    """

    def __init__(
        self,
        registry: Optional[Registry] = None,
        horizon_s: float = 4000.0,
    ) -> None:
        self._registry = registry
        self.horizon_s = float(horizon_s)
        self._lock = threading.Lock()
        self._entries: list[tuple[float, dict]] = []

    def observe(self, t: float, snapshot: Optional[dict] = None) -> dict:
        """Record one snapshot at time ``t`` (monotonic or epoch — any
        clock, as long as it is THE clock for this window).  Taken from
        the attached registry when not given."""
        if snapshot is None:
            if self._registry is None:
                raise ValueError("no snapshot given and no registry attached")
            snapshot = self._registry.snapshot()
        with self._lock:
            self._entries.append((float(t), snapshot))
            floor = float(t) - self.horizon_s
            while len(self._entries) > 1 and self._entries[0][0] < floor:
                self._entries.pop(0)
        return snapshot

    def latest(self) -> Optional[tuple[float, dict]]:
        with self._lock:
            return self._entries[-1] if self._entries else None

    def span_s(self) -> float:
        """Seconds between the oldest and newest recorded snapshots."""
        with self._lock:
            if len(self._entries) < 2:
                return 0.0
            return self._entries[-1][0] - self._entries[0][0]

    def delta_over(self, window_s: float) -> tuple[float, dict]:
        """(actual seconds covered, snapshot_delta) between the newest
        entry and the newest entry at least ``window_s`` older — or the
        oldest available when the window has not filled yet.  ``(0.0,
        {})`` with fewer than two entries."""
        with self._lock:
            if len(self._entries) < 2:
                return 0.0, {}
            t_new, newest = self._entries[-1]
            base = self._entries[0]
            for entry in reversed(self._entries[:-1]):
                if t_new - entry[0] >= window_s:
                    base = entry
                    break
            t_old, oldest = base
        return t_new - t_old, snapshot_delta(oldest, newest)

    def rate(self, name: str, label: str = "",
             window_s: float = 60.0) -> Optional[float]:
        """Per-second increase of counter ``name``/``label`` over the
        last ``window_s`` (labels summed when ``label`` is "" and the
        series is labelled).  None before two snapshots exist."""
        dt, delta = self.delta_over(window_s)
        if dt <= 0:
            return None
        series = delta.get(name)
        if not series:
            return 0.0
        if label in series and not isinstance(series[label], dict):
            return series[label] / dt
        total = sum(
            v for v in series.values() if isinstance(v, (int, float))
        )
        return total / dt
