"""Counters, gauges, and fixed-bucket histograms (DESIGN.md §13).

Instruments are get-or-create by name from a :class:`MetricsRegistry`; each
is a tiny ``__slots__`` object whose update methods do constant work — no
numpy on the record path, so observing a latency inside the serving loop
costs a couple of float ops.

Histograms have *fixed* bucket edges chosen at creation (half-open
``[edges[i-1], edges[i])`` buckets plus underflow/overflow), which keeps
``observe`` O(log n_buckets) and makes two histograms with the same edges
mergeable by adding counts.  ``quantile`` interpolates linearly inside the
covering bucket, clamped to the observed min/max, so estimates degrade
gracefully with bucket width instead of snapping to edges.
"""
from __future__ import annotations

import bisect
import math


def geometric_edges(lo: float, hi: float, per_octave: int = 4
                    ) -> tuple[float, ...]:
    """Geometric bucket edges from ``lo`` to at least ``hi`` with
    ``per_octave`` buckets per doubling — the default shape for latency
    histograms, whose values span decades."""
    if not (lo > 0 and hi > lo and per_octave >= 1):
        raise ValueError("need 0 < lo < hi and per_octave >= 1")
    ratio = 2.0 ** (1.0 / per_octave)
    edges = [lo]
    while edges[-1] < hi:
        edges.append(edges[-1] * ratio)
    return tuple(edges)


def linear_edges(lo: float, hi: float, n: int = 64) -> tuple[float, ...]:
    """``n`` equal-width buckets spanning [lo, hi]."""
    if not (hi > lo and n >= 1):
        raise ValueError("need hi > lo and n >= 1")
    step = (hi - lo) / n
    return tuple(lo + i * step for i in range(n + 1))


# default latency edges: 10 µs .. ~84 s, 4 buckets per octave
DEFAULT_TIME_EDGES = geometric_edges(1e-5, 64.0)
# small-integer count edges (batch sizes, pool sizes)
DEFAULT_COUNT_EDGES = tuple(float(v) for v in
                            (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))


class Counter:
    """Monotone accumulator."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def to_dict(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Last-value instrument that also tracks the min/max it has seen."""

    __slots__ = ("value", "min", "max", "n_sets")

    def __init__(self):
        self.value = math.nan
        self.min = math.inf
        self.max = -math.inf
        self.n_sets = 0

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.n_sets += 1

    def to_dict(self) -> dict:
        return {"value": self.value, "min": self.min, "max": self.max,
                "n_sets": self.n_sets}


class Histogram:
    """Fixed-bucket histogram: ``len(edges) + 1`` half-open buckets
    (underflow ``(-inf, edges[0])``, interior ``[edges[i-1], edges[i])``,
    overflow ``[edges[-1], inf)``)."""

    __slots__ = ("edges", "counts", "count", "total", "min", "max")

    def __init__(self, edges):
        edges = tuple(float(e) for e in edges)
        if len(edges) < 1 or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError("edges must be non-empty, strictly increasing")
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        # a value exactly at an edge belongs to the bucket it opens
        self.counts[bisect.bisect_right(self.edges, v)] += 1
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile estimate, clamped to [min, max]."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return math.nan
        rank = q * self.count
        cum = 0
        for b, c in enumerate(self.counts):
            if cum + c >= rank and c > 0:
                lo = self.edges[b - 1] if b > 0 else self.min
                hi = self.edges[b] if b < len(self.edges) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (rank - cum) / c
                return min(max(lo + frac * (hi - lo), self.min), self.max)
            cum += c
        return self.max

    def to_dict(self) -> dict:
        return {"edges": list(self.edges), "counts": list(self.counts),
                "count": self.count, "sum": self.total,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None}


class MetricsRegistry:
    """Get-or-create instrument store; one per observability session."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def __len__(self) -> int:
        return (len(self._counters) + len(self._gauges)
                + len(self._histograms))

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

    def histogram(self, name: str, edges=None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(
                edges if edges is not None else DEFAULT_TIME_EDGES)
        return h

    def snapshot(self) -> dict:
        return {
            "counters": {k: v.to_dict()
                         for k, v in sorted(self._counters.items())},
            "gauges": {k: v.to_dict()
                       for k, v in sorted(self._gauges.items())},
            "histograms": {k: v.to_dict()
                           for k, v in sorted(self._histograms.items())},
        }
