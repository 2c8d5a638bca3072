"""Streaming SLO health monitor: P² quantiles + windowed burn-rate gauges.

Port of `repro.obs.health`, unchanged: host arithmetic only.

`repro_torch.obs.metrics` answers "what were the percentiles of this run?" —
fixed-bucket histograms read post-hoc.  This module answers "how healthy is
the server *right now*?", the live signal the adaptive-policy work
(ROADMAP "SLO round 2") needs:

  * :class:`P2Quantile` — the Jain & Chlamtac P² algorithm: a streaming
    quantile estimate from five markers, O(1) memory and per-observation
    cost, no buckets to pre-size.  Used for whole-stream latency
    p50/p95/p99.
  * :class:`HealthMonitor` — a sliding wall-clock window over completions:
    deadline-miss burn rate (misses/s), windowed goodput fraction, drop
    count, and queue-depth last/peak.  Everything is host-side arithmetic
    on events the scheduler already handles; no device reads.

Disabled monitors are inert: every hook returns immediately and
``snapshot()`` is ``{"enabled": False}``, preserving the §12 zero-overhead
contract.
"""

from __future__ import annotations

import bisect
import math
import time
from collections import deque
from typing import Optional

DEFAULT_QUANTILES = (0.50, 0.95, 0.99)


class P2Quantile:
    """Jain & Chlamtac's P² streaming quantile estimator (CACM 1985).

    Tracks five markers (min, q/2, q, (1+q)/2, max); marker heights are
    nudged toward their desired positions with a piecewise-parabolic
    interpolation as observations stream in.  Exact for the first five
    observations, approximate after.
    """

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self.n = 0
        self._h: list = []          # marker heights (sorted)
        self._pos = [1, 2, 3, 4, 5]  # actual marker positions (1-based)

    def observe(self, x: float) -> None:
        x = float(x)
        if self.n < 5:
            bisect.insort(self._h, x)
            self.n += 1
            return
        h, pos = self._h, self._pos
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while not (h[k] <= x < h[k + 1]):
                k += 1
        self.n += 1
        for i in range(k + 1, 5):
            pos[i] += 1
        q = self.q
        desired = (1.0,
                   1.0 + (self.n - 1) * q / 2.0,
                   1.0 + (self.n - 1) * q,
                   1.0 + (self.n - 1) * (1.0 + q) / 2.0,
                   float(self.n))
        for i in (1, 2, 3):
            d = desired[i] - pos[i]
            if ((d >= 1.0 and pos[i + 1] - pos[i] > 1)
                    or (d <= -1.0 and pos[i - 1] - pos[i] < -1)):
                s = 1 if d >= 1.0 else -1
                hp = self._parabolic(i, s)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:  # parabolic estimate left the bracket: linear step
                    h[i] = h[i] + s * (h[i + s] - h[i]) / (pos[i + s] - pos[i])
                pos[i] += s

    def _parabolic(self, i: int, s: int) -> float:
        h, pos = self._h, self._pos
        return h[i] + s / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + s) * (h[i + 1] - h[i])
            / (pos[i + 1] - pos[i])
            + (pos[i + 1] - pos[i] - s) * (h[i] - h[i - 1])
            / (pos[i] - pos[i - 1]))

    def value(self) -> float:
        """Current estimate (exact interpolated quantile while n <= 5)."""
        if self.n == 0:
            return math.nan
        if self.n <= 5:
            # numpy 'linear' interpolation over the exact sorted sample
            rank = self.q * (self.n - 1)
            lo = int(math.floor(rank))
            hi = min(lo + 1, self.n - 1)
            frac = rank - lo
            return self._h[lo] * (1.0 - frac) + self._h[hi] * frac
        return self._h[2]


class HealthMonitor:
    """Sliding-window SLO gauges over completion/queue events.

    One monitor per server (owned by :class:`repro_torch.obs.Observability`).
    ``on_complete`` is called once per finished request — harvested,
    cache-hit, or dropped — with its end-to-end latency; ``on_queue_depth``
    once per pump with the current backlog.  ``snapshot()`` evicts events
    older than ``window_s`` and derives the gauges.
    """

    def __init__(self, enabled: bool = False, window_s: float = 10.0,
                 quantiles=DEFAULT_QUANTILES, clock=time.monotonic):
        self.enabled = bool(enabled)
        self.window_s = float(window_s)
        self._clock = clock
        self._q = {q: P2Quantile(q) for q in quantiles} if self.enabled else {}
        # completion events inside the window: (t, latency_s, missed, good,
        # dropped)
        self._events: deque = deque()
        # queue-depth samples inside the window: (t, depth)
        self._depths: deque = deque()
        self._total = 0

    def on_complete(self, latency_s: float, *, deadline_missed: bool = False,
                    dropped: bool = False,
                    good: Optional[bool] = None) -> None:
        if not self.enabled:
            return
        latency_s = max(0.0, float(latency_s))
        if good is None:
            good = not deadline_missed and not dropped
        self._total += 1
        for est in self._q.values():
            est.observe(latency_s)
        self._events.append((self._clock(), latency_s,
                             bool(deadline_missed), bool(good),
                             bool(dropped)))

    def on_queue_depth(self, depth: int) -> None:
        if not self.enabled:
            return
        self._depths.append((self._clock(), int(depth)))

    def reset(self) -> None:
        """Forget all history (quantile markers included). The P² estimators
        cannot be delta'd the way plain counters can, so measured phases
        (slo.harness.replay) reset at entry to keep warmup/JIT-compile
        latencies out of the whole-stream quantiles."""
        self._q = {q: P2Quantile(q) for q in self._q}
        self._events.clear()
        self._depths.clear()
        self._total = 0

    def _evict(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()
        while self._depths and self._depths[0][0] < cutoff:
            self._depths.popleft()

    def snapshot(self) -> dict:
        if not self.enabled:
            return {"enabled": False}
        now = self._clock()
        self._evict(now)
        n_win = len(self._events)
        missed = sum(1 for e in self._events if e[2])
        good = sum(1 for e in self._events if e[3])
        dropped = sum(1 for e in self._events if e[4])
        lat = {f"p{int(q * 100)}_s": (0.0 if math.isnan(est.value())
                                      else float(est.value()))
               for q, est in self._q.items()}
        lat["n"] = self._total
        return {
            "enabled": True,
            "window_s": self.window_s,
            "latency": lat,
            "window": {
                "completions": n_win,
                "deadline_missed": missed,
                "miss_rate": (missed / n_win) if n_win else 0.0,
                "burn_per_s": missed / self.window_s,
                "goodput": (good / n_win) if n_win else 0.0,
                "dropped": dropped,
            },
            "queue_depth": {
                "last": self._depths[-1][1] if self._depths else 0,
                "peak": max((d for _t, d in self._depths), default=0),
            },
        }
