"""Process-local metrics: counters, gauges, log-bucketed histograms.

A copy of :mod:`repro.obs.metrics` (the port imports nothing of
``repro``), with the same bucket law, ``as_dict`` and Prometheus text, so
a snapshot taken by either package loads and merges in the other.

Zero-dependency by design (stdlib only): this module is imported by the
hot serve path, so it must not pull in torch/numpy at import time, and
every operation on the recording side is O(1) dict work.

Three instrument kinds, chosen so snapshots merge associatively across
shards and streams:

``Counter``
    Monotonic event count (``kernel.launches_total``).  Merge = sum.
``Gauge``
    Last-observed value (``sched.queue_depth``, folded island counters
    like ``plan.cache.hits``).  Merge = max — the folded islands are
    themselves cumulative, and max of cumulative readings is the latest
    one, which keeps repeated ``obs_snapshot()`` calls from
    double-counting.
``Histogram``
    Log-bucketed latency distribution.  Bucket ``i`` covers
    ``[lo * growth**i, lo * growth**(i+1))`` with ``lo = 1e-7`` s and
    ``growth = 2**(1/8)``, so any interpolated percentile is within a
    factor of ``growth`` (~9% relative) of the exact sample percentile.
    Buckets are a sparse dict, merge = elementwise add, so histograms
    merged across shards give the same percentiles as one global
    histogram would.

``MetricsRegistry.snapshot()`` freezes everything into an
:class:`ObsSnapshot` — a plain-dict dataclass with JSON
(:meth:`ObsSnapshot.as_dict`) and Prometheus text exposition
(:meth:`ObsSnapshot.to_prometheus`) exports and a lossless
:meth:`ObsSnapshot.merge`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ObsSnapshot",
]


class Counter:
    """Monotonic event counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("Counter.inc requires n >= 0")
        self.value += n


class Gauge:
    """Last-observed value (set wins; merge across snapshots takes max)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Sparse log-bucketed histogram of nonnegative samples (seconds).

    Samples at or below ``lo`` land in the underflow bucket ``-1``
    (interpolated linearly between the observed min and ``lo``).
    """

    #: default lower edge: 100 ns — below any latency this repo measures.
    LO = 1e-7
    #: default growth: 2**(1/8) per bucket => <=~9% relative percentile error.
    GROWTH = 2.0 ** 0.125

    __slots__ = ("lo", "growth", "_log_growth", "buckets", "count", "sum",
                 "min", "max")

    def __init__(self, lo: float = LO, growth: float = GROWTH) -> None:
        if not lo > 0.0 or not growth > 1.0:
            raise ValueError("Histogram requires lo > 0 and growth > 1")
        self.lo = float(lo)
        self.growth = float(growth)
        self._log_growth = math.log(self.growth)
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, x: float) -> int:
        if x <= self.lo:
            return -1
        return int(math.floor(math.log(x / self.lo) / self._log_growth))

    def observe(self, x: float) -> None:
        x = float(x)
        if x < 0.0 or math.isnan(x):
            x = 0.0  # clock skew / fake test clocks: clamp, don't poison
        i = self._index(x)
        self.buckets[i] = self.buckets.get(i, 0) + 1
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    def _edges(self, i: int) -> tuple:
        if i < 0:
            lo = self.min if self.min < self.lo else 0.0
            return (max(lo, 0.0), self.lo)
        return (self.lo * self.growth ** i, self.lo * self.growth ** (i + 1))

    def percentile(self, q: float) -> float:
        """Interpolated percentile (``q`` in [0, 100]) from the buckets."""
        if self.count == 0:
            return math.nan
        target = (q / 100.0) * self.count
        cum = 0
        for i in sorted(self.buckets):
            n = self.buckets[i]
            if cum + n >= target:
                lo, hi = self._edges(i)
                frac = (target - cum) / n if n else 0.0
                v = lo + (hi - lo) * frac
                return min(max(v, self.min), self.max)
            cum += n
        return self.max

    def merge(self, other: "Histogram") -> None:
        if (other.lo, other.growth) != (self.lo, self.growth):
            raise ValueError("cannot merge histograms with different buckets")
        for i, n in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + n
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def as_dict(self) -> dict:
        d = {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "lo": self.lo,
            "growth": self.growth,
            # JSON object keys must be strings; keep raw buckets so merges
            # of exported snapshots stay lossless.
            "buckets": {str(i): n for i, n in sorted(self.buckets.items())},
        }
        if self.count:
            d["p50"] = self.percentile(50.0)
            d["p95"] = self.percentile(95.0)
            d["p99"] = self.percentile(99.0)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls(lo=d.get("lo", cls.LO), growth=d.get("growth", cls.GROWTH))
        h.count = int(d.get("count", 0))
        h.sum = float(d.get("sum", 0.0))
        if h.count:
            h.min = float(d["min"])
            h.max = float(d["max"])
        h.buckets = {int(i): int(n) for i, n in d.get("buckets", {}).items()}
        return h


class MetricsRegistry:
    """Name -> instrument map; instruments are created on first use."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram()
        return h

    def snapshot(self) -> "ObsSnapshot":
        return ObsSnapshot(
            counters={k: c.value for k, c in sorted(self._counters.items())},
            gauges={k: g.value for k, g in sorted(self._gauges.items())},
            histograms={k: h.as_dict()
                        for k, h in sorted(self._histograms.items())},
        )


def _prom_name(name: str) -> str:
    return "".join(ch if (ch.isalnum() or ch in "_:") else "_"
                   for ch in name)


@dataclasses.dataclass
class ObsSnapshot:
    """Frozen, JSON-ready view of a :class:`MetricsRegistry`.

    ``histograms`` values are :meth:`Histogram.as_dict` dicts (raw
    buckets included), so snapshots merge losslessly: percentiles of a
    merged snapshot equal percentiles of one registry that saw every
    sample.
    """

    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    gauges: Dict[str, float] = dataclasses.field(default_factory=dict)
    histograms: Dict[str, dict] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: dict(v) for k, v in self.histograms.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ObsSnapshot":
        return cls(
            counters=dict(d.get("counters", {})),
            gauges=dict(d.get("gauges", {})),
            histograms={k: dict(v)
                        for k, v in d.get("histograms", {}).items()},
        )

    def merge(self, other: "ObsSnapshot") -> "ObsSnapshot":
        """Associative merge: counters add, gauges max, histograms add."""
        counters = dict(self.counters)
        for k, v in other.counters.items():
            counters[k] = counters.get(k, 0) + v
        gauges = dict(self.gauges)
        for k, v in other.gauges.items():
            gauges[k] = max(gauges.get(k, v), v)
        histograms = dict(self.histograms)
        for k, v in other.histograms.items():
            if k in histograms:
                h = Histogram.from_dict(histograms[k])
                h.merge(Histogram.from_dict(v))
                histograms[k] = h.as_dict()
            else:
                histograms[k] = dict(v)
        return ObsSnapshot(counters=counters, gauges=gauges,
                           histograms=histograms)

    @classmethod
    def merge_all(cls, snaps: Iterable["ObsSnapshot"]) -> "ObsSnapshot":
        out = cls()
        for s in snaps:
            out = out.merge(s)
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (metric dots become underscores)."""
        lines = []
        for k, v in self.counters.items():
            n = _prom_name(k)
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {v}")
        for k, v in self.gauges.items():
            n = _prom_name(k)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {v}")
        for k, d in self.histograms.items():
            n = _prom_name(k)
            h = Histogram.from_dict(d)
            lines.append(f"# TYPE {n} histogram")
            cum = 0
            for i in sorted(h.buckets):
                cum += h.buckets[i]
                le = h._edges(i)[1]
                lines.append(f'{n}_bucket{{le="{le:.6g}"}} {cum}')
            lines.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{n}_sum {h.sum}")
            lines.append(f"{n}_count {h.count}")
        return "\n".join(lines) + "\n"
