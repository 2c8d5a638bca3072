"""Seeded open-loop workload specs for the serving stack (DESIGN.md §13).

Port of `repro.slo.workload`: host numpy only, the same draws in the same
order, so `generate` gives the reference's `Arrival` list bit for bit.

A `Workload` describes an arrival PROCESS, not a request list: multi-tenant
mixes of ACC queries (each tenant class owns a weight, an algorithm mix, a
deadline, and a source skew) arriving by a Poisson or bursty (2-state
MMPP — Markov-modulated Poisson) clock, with streaming edge-update batches
interleaved at a fixed cadence. `generate(workload, n_nodes)` expands it
deterministically (one `numpy` Generator, fixed draw order) into a sorted
`Arrival` list that `repro_torch.slo.harness.replay` fires at the server
open-loop — submission times come from the spec's clock, never from
completions, which is what makes overload visible instead of self-throttled
(closed-loop benches like BENCH_obs.json can never overrun the server).

The MMPP burst model: the process alternates between a LOW state and a HIGH
state (rate = `rate_qps * burst_factor`) with exponentially distributed
dwell times, tuned so a `burst_frac` fraction of time is spent bursting and
the time-averaged rate stays ~`rate_qps`. Bursts are what defeat
average-rate provisioning — the queue depth a burst builds is exactly what
the SLO policy's drop/degrade/preempt triggers act on.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One tenant population's traffic contract."""

    tenant: str = "default"
    #: share of the arrival stream routed to this tenant
    weight: float = 1.0
    #: (algo, weight) mix of query types this tenant issues
    algos: Tuple[Tuple[str, float], ...] = (("bfs", 1.0),)
    #: latency SLO attached to every query (None = best-effort)
    deadline_ms: Optional[float] = None
    #: fraction of queries aimed at the shared hot source set (cacheable
    #: skew); the rest draw uniformly over all nodes
    hot_frac: float = 0.0
    #: explicit source pool overriding the uniform draw (e.g. hub vertices
    #: for a deliberately heavy tenant); hot_frac still applies first
    sources: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class Workload:
    """Seeded open-loop arrival spec. `arrival` is 'poisson' (homogeneous)
    or 'mmpp' (bursty two-state, see module docstring)."""

    arrival: str = "poisson"
    #: time-averaged arrival rate (both processes target this mean)
    rate_qps: float = 50.0
    duration_s: float = 5.0
    #: HIGH-state rate multiplier (mmpp only)
    burst_factor: float = 6.0
    #: fraction of time spent in the HIGH state (mmpp only)
    burst_frac: float = 0.25
    #: mean HIGH-state dwell (mmpp only); LOW dwell follows from burst_frac
    burst_dwell_s: float = 0.4
    tenants: Tuple[TenantClass, ...] = (TenantClass(),)
    #: cadence of interleaved streaming edge-update batches (0 = none)
    update_every_s: float = 0.0
    #: edges inserted per update batch (plus a few deletions of earlier
    #: inserted edges, exercising both overlay directions)
    update_batch: int = 8
    #: size of the shared hot source set `hot_frac` draws from
    hot_set: int = 16
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One expanded event: a query submission or an update batch."""

    t: float
    kind: str                       # 'query' | 'update'
    algo: str = ""
    source: int = 0
    tenant: str = "default"
    deadline_ms: Optional[float] = None
    inserts: Tuple[Tuple[int, int], ...] = ()
    deletes: Tuple[Tuple[int, int], ...] = ()


def _poisson_times(w: Workload, rng: np.random.Generator) -> List[float]:
    t, out = 0.0, []
    scale = 1.0 / w.rate_qps
    while True:
        t += rng.exponential(scale)
        if t >= w.duration_s:
            return out
        out.append(t)


def _mmpp_times(w: Workload, rng: np.random.Generator) -> List[float]:
    f = min(max(w.burst_frac, 1e-6), 1.0 - 1e-6)
    hi = w.rate_qps * w.burst_factor
    # low-state rate chosen so f*hi + (1-f)*lo == rate_qps; clamps at 0 when
    # the bursts alone carry more than the average (all-burst traffic)
    lo = max(w.rate_qps * (1.0 - f * w.burst_factor) / (1.0 - f), 0.0)
    dwell_hi = w.burst_dwell_s
    dwell_lo = dwell_hi * (1.0 - f) / f
    t, out, high = 0.0, [], False
    seg_end = rng.exponential(dwell_lo)
    while t < w.duration_s:
        rate = hi if high else lo
        nxt = t + rng.exponential(1.0 / rate) if rate > 0 else seg_end
        if nxt >= seg_end:
            t = seg_end
            high = not high
            seg_end = t + rng.exponential(dwell_hi if high else dwell_lo)
        else:
            t = nxt
            if t < w.duration_s:
                out.append(t)
    return out


def generate(w: Workload, n_nodes: int) -> List[Arrival]:
    """Expand a workload spec into its sorted arrival list. Deterministic
    per (spec, n_nodes): one seeded Generator, fixed consumption order
    (arrival clock, then per-query draws in arrival order, then updates)."""
    assert w.arrival in ("poisson", "mmpp"), w.arrival
    assert w.tenants, "workload needs at least one tenant class"
    rng = np.random.default_rng(w.seed)
    times = (_poisson_times(w, rng) if w.arrival == "poisson"
             else _mmpp_times(w, rng))
    hot = rng.integers(0, n_nodes, size=max(1, w.hot_set))

    tw = np.asarray([tc.weight for tc in w.tenants], np.float64)
    tw = tw / tw.sum()
    out: List[Arrival] = []
    for t in times:
        tc = w.tenants[int(rng.choice(len(w.tenants), p=tw))]
        aw = np.asarray([a[1] for a in tc.algos], np.float64)
        algo = tc.algos[int(rng.choice(len(tc.algos), p=aw / aw.sum()))][0]
        if tc.hot_frac > 0 and rng.random() < tc.hot_frac:
            source = int(hot[int(rng.integers(0, len(hot)))])
        elif tc.sources is not None:
            source = int(tc.sources[int(rng.integers(0, len(tc.sources)))])
        else:
            source = int(rng.integers(0, n_nodes))
        out.append(Arrival(t=float(t), kind="query", algo=algo,
                           source=source, tenant=tc.tenant,
                           deadline_ms=tc.deadline_ms))
    if w.update_every_s > 0:
        inserted: List[Tuple[int, int]] = []
        k = 1
        while k * w.update_every_s < w.duration_s:
            ins = [(int(u), int(v)) for u, v in zip(
                rng.integers(0, n_nodes, size=w.update_batch),
                rng.integers(0, n_nodes, size=w.update_batch)) if u != v]
            n_del = min(len(inserted), max(0, w.update_batch // 4))
            dels = [inserted.pop(int(rng.integers(0, len(inserted))))
                    for _ in range(n_del)]
            inserted.extend(ins)
            out.append(Arrival(t=float(k * w.update_every_s), kind="update",
                               inserts=tuple(ins), deletes=tuple(dels)))
            k += 1
    out.sort(key=lambda a: (a.t, a.kind))   # 'query' < 'update' at a tie
    return out


def describe(w: Workload) -> dict:
    """JSON-able spec summary for bench records."""
    return {
        "arrival": w.arrival,
        "rate_qps": w.rate_qps,
        "duration_s": w.duration_s,
        "burst_factor": w.burst_factor if w.arrival == "mmpp" else None,
        "burst_frac": w.burst_frac if w.arrival == "mmpp" else None,
        "seed": w.seed,
        "update_every_s": w.update_every_s,
        "tenants": [
            {"tenant": tc.tenant, "weight": tc.weight,
             "algos": [list(a) for a in tc.algos],
             "deadline_ms": tc.deadline_ms, "hot_frac": tc.hot_frac}
            for tc in w.tenants
        ],
    }
