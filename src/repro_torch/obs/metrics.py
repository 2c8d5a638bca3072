"""Host-side metrics registry: counters, gauges, fixed-bucket histograms.

Port of `repro.obs.metrics`, unchanged: it holds host values only.

The observability layer's storage primitive (DESIGN.md §12). Everything here
is plain-python host state — no tensors, no device syncs — so recording a
metric costs a dict lookup and an integer add. The registry is built once
per `GraphServer` (or standalone for benches) and is a **no-op when
disabled**: `MetricsRegistry(enabled=False)` hands out shared singleton
instruments whose record methods do nothing, so telemetry-off code paths
execute zero extra work and, by construction, zero extra device transfers
(the overhead-guard test in tests/test_torch_obs.py pins this).

Histograms use FIXED bucket boundaries chosen at construction (the same
bounded-static-structure doctrine the engine applies to frontiers): an
observation is one bisect + one increment, and percentile summaries
(p50/p95/p99) come from linear interpolation inside the bucket holding the
target rank. The estimate is exact to within one bucket's width — the
default latency buckets are exponential (~1.6x), so the relative error of a
reported percentile is bounded by the bucket growth factor, which is the
usual Prometheus-style contract. `Histogram.percentile` is tested against
`numpy.quantile` in tests/test_torch_obs.py.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Sequence


def default_latency_buckets() -> List[float]:
    """Exponential seconds-scale boundaries: 100us .. ~120s, ratio ~1.6."""
    out = []
    b = 100e-6
    while b < 120.0:
        out.append(b)
        b *= 1.6
    return out


def default_count_buckets(hi: int = 1 << 30) -> List[float]:
    """Power-of-4 boundaries for volume counters (frontier sizes, edges)."""
    out, b = [], 1
    while b < hi:
        out.append(float(b))
        b *= 4
    return out


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, v: float = 1) -> None:
        self.value += v

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram with interpolated percentile summaries.

    `bounds` are the inner bucket upper boundaries (sorted, exclusive of the
    implicit +inf overflow bucket). Observation i lands in the first bucket
    whose boundary is >= value. min/max/sum ride along so summaries can
    clamp interpolation to the observed range — the p99 of a histogram whose
    mass sits in one bucket reports within that bucket, never a boundary the
    data never reached.
    """

    __slots__ = ("name", "bounds", "counts", "n", "total", "vmin", "vmax")

    def __init__(self, name: str, bounds: Optional[Sequence[float]] = None):
        self.name = name
        bounds = list(bounds if bounds is not None
                      else default_latency_buckets())
        assert bounds == sorted(bounds) and len(bounds) >= 1, bounds
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # +1: overflow bucket
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def percentile(self, q: float) -> float:
        """Interpolated quantile, q in [0, 1]; nan when empty.

        Matches numpy's 'linear' quantile definition at the rank level: the
        target rank is q*(n-1), located in the cumulative bucket counts,
        then linearly interpolated across the owning bucket's value span
        (clamped to [vmin, vmax]). Exact when every observation in the
        owning bucket sits on one value; within one bucket width otherwise.
        """
        if self.n == 0:
            return math.nan
        rank = q * (self.n - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            # bucket i spans ranks [cum, cum + c - 1]
            if rank < cum + c:
                lo = self.bounds[i - 1] if i > 0 else self.vmin
                hi = self.bounds[i] if i < len(self.bounds) else self.vmax
                lo = max(lo, self.vmin)
                hi = min(hi, self.vmax)
                if hi <= lo:
                    return lo
                if c == 1:
                    return hi      # conservative upper estimate
                # linear position of the target rank inside this bucket
                frac = (rank - cum) / (c - 1)
                frac = min(1.0, max(0.0, frac))
                return lo + frac * (hi - lo)
            cum += c
        return self.vmax

    def summary(self) -> dict:
        return {
            "count": self.n,
            "sum": self.total,
            "min": None if self.n == 0 else self.vmin,
            "max": None if self.n == 0 else self.vmax,
            "p50": None if self.n == 0 else self.percentile(0.50),
            "p95": None if self.n == 0 else self.percentile(0.95),
            "p99": None if self.n == 0 else self.percentile(0.99),
        }

    def snapshot(self):
        return self.summary()


class _NoopInstrument:
    """Shared do-nothing stand-in handed out by a disabled registry."""

    name = "<noop>"
    value = 0

    def inc(self, v: float = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return math.nan

    def summary(self) -> dict:
        return {}

    def snapshot(self):
        return None


NOOP = _NoopInstrument()


class MetricsRegistry:
    """Named instruments behind one enable switch.

    `counter/gauge/histogram` create-or-return by name; with
    `enabled=False` every call returns the shared `NOOP` instrument and the
    registry stores nothing — the disabled path allocates nothing per call
    and `snapshot()` is `{}`.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, factory):
        if not self.enabled:
            return NOOP
        inst = self._instruments.get(name)
        if inst is None:
            inst = factory(name)
            self._instruments[name] = inst
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, lambda n: Histogram(n, bounds))

    def snapshot(self) -> dict:
        """{name: value-or-summary} for every registered instrument."""
        return {name: inst.snapshot()
                for name, inst in sorted(self._instruments.items())}
