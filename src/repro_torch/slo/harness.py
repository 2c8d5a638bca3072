"""Open-loop replay: fire a workload's arrival list at a `GraphServer`.

Port of `repro.slo.harness` over the port's `GraphServer`. On the card a
pump returns once its packed host read has waited for the step, so a
completion is stamped when the step's result reached the host; an
`apply_updates` blocks the open loop for as long as it takes, as in the
reference.

The loop is strictly open: each arrival is submitted when its spec time
comes due on the host wall clock, whether or not earlier queries have
completed — queue backpressure surfaces as SHED submissions (quota-full
`submit` returning None), never as a slowed arrival clock. Between
arrivals the loop pumps the server continuously; after the last arrival it
drains. The report separates every way a query can leave the system:

    completed      engine- or cache-served with a result
    shed           refused at submit (queue share full, open-loop overrun)
    dropped        policy-shed (expired/hopeless deadline), result=None
    deadline_missed completed but late (also counts every drop)
    degraded       served from the loosened-tolerance shadow pool
    preempted      evicted mid-run at least once before completing

Goodput is the fraction of OFFERED queries that produced a timely answer:
(completed - deadline_missed-but-completed) / offered, with best-effort
(deadline-less) completions counting as good. Percentiles are measured on
the harness's own wall clock (submit->completion observed), independent of
the server's span telemetry, so the harness works with telemetry off.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.kernels import _build
from repro_torch.serving.scheduler import GraphServer
from repro_torch.slo.workload import Arrival

#: the CUDA sources a serving pool launches (the batched pull, the union
#: push's compaction and segment Combine); `warmup` builds them together
SERVING_SOURCES = ("ell_combine_batched", "frontier_pack", "segment_reduce")


#: floor on reported latencies: synchronous completions (cache hits,
#: expired-at-submit drops) cost ~0 wall time but the bench schema pins
#: every *_seconds as strictly positive
EPS_S = 1e-9


def percentiles(samples: List[float]) -> Optional[dict]:
    """{p50,p95,p99,mean}_seconds over raw latency samples (None if empty).
    np.percentile with linear interpolation — same convention as the
    closed-loop benches."""
    if not samples:
        return None
    arr = np.asarray(samples, np.float64)
    return {
        "n": int(arr.size),
        "mean_seconds": max(float(arr.mean()), EPS_S),
        "p50_seconds": max(float(np.percentile(arr, 50)), EPS_S),
        "p95_seconds": max(float(np.percentile(arr, 95)), EPS_S),
        "p99_seconds": max(float(np.percentile(arr, 99)), EPS_S),
    }


@dataclasses.dataclass
class ReplayReport:
    offered: int
    completed: int
    good: int
    shed: int
    dropped: int
    degraded: int
    preempted: int
    deadline_missed: int
    cache_hits: int
    updates_applied: int
    goodput: float
    wall_s: float
    #: lanes still holding a rid after the drain — MUST be 0 (a non-zero
    #: count means the scheduler leaked/wedged a lane under load)
    crashed_lanes: int
    total: Optional[dict]                  # percentiles over all completions
    per_algo: Dict[str, Optional[dict]]
    per_tenant: Dict[str, Optional[dict]]
    #: server-side streaming health snapshot (stats()["health"]) taken at
    #: drain — P² quantiles + windowed miss/goodput gauges (DESIGN.md §14).
    #: {"enabled": False} when the server runs without a health monitor.
    health: Optional[dict] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def replay(srv: GraphServer, arrivals: List[Arrival], *,
           max_wall_s: Optional[float] = None) -> ReplayReport:
    """Open-loop replay of `arrivals` (from `workload.generate`) against a
    server, then drain; see module docstring for the report's accounting.
    Counters (slo_counts, rejected, cache hits, updates) are reported as
    DELTAS over the replay, so a warmed-up server replays cleanly."""
    slo0 = dict(srv.slo_counts)
    updates0 = len(srv.update_log)
    # P² markers can't be delta'd like the counters above: reset so warmup
    # first-launch latencies never poison the measured-phase quantiles
    srv.obs.health.reset()
    t0 = time.monotonic()
    sub_t: Dict[int, float] = {}          # rid -> submit wall time
    comp_t: Dict[int, float] = {}         # rid -> completion wall time
    shed = 0
    i = 0
    deadline = None if max_wall_s is None else t0 + max_wall_s

    def pump_and_stamp() -> None:
        now = time.monotonic()
        for c in srv.pump():
            comp_t.setdefault(c.rid, now)

    while True:
        now = time.monotonic() - t0
        while i < len(arrivals) and arrivals[i].t <= now:
            a = arrivals[i]
            i += 1
            if a.kind == "update":
                srv.apply_updates(inserts=list(a.inserts),
                                  deletes=list(a.deletes))
                continue
            rid = srv.submit(a.algo, a.source, tenant=a.tenant,
                             deadline_ms=a.deadline_ms)
            if rid is None:
                shed += 1
            else:
                # synchronous completions (cache hit, expired-at-submit
                # drop) never get a pump stamp; collection falls back to
                # the submit time (latency ~0, which is what they cost)
                sub_t[rid] = time.monotonic()
        pump_and_stamp()
        busy = (srv._queued() > 0
                or any(p.live() for _n, p, _d in srv._leaves()))
        if i >= len(arrivals) and not busy:
            break
        if deadline is not None and time.monotonic() > deadline:
            break
        if not busy and i < len(arrivals):
            # idle gap before the next arrival: sleep instead of spinning
            gap = arrivals[i].t - (time.monotonic() - t0)
            if gap > 0:
                time.sleep(min(gap, 0.002))
    wall_s = time.monotonic() - t0

    by_rid = {c.rid: c for c in srv.completions if c.rid in sub_t}
    lat_all: List[float] = []
    lat_algo: Dict[str, List[float]] = {}
    lat_tenant: Dict[str, List[float]] = {}
    completed = good = missed = cache_hits = 0
    for rid, c in by_rid.items():
        if c.dropped:
            continue
        completed += 1
        if c.from_cache:
            cache_hits += 1
        if c.deadline_missed:
            missed += 1
        else:
            good += 1
        lat = max(0.0, comp_t.get(rid, sub_t[rid]) - sub_t[rid])
        lat_all.append(lat)
        lat_algo.setdefault(c.algo, []).append(lat)
        lat_tenant.setdefault(c.tenant, []).append(lat)
    offered = len(sub_t) + shed
    slo_d = {k: srv.slo_counts[k] - slo0[k] for k in slo0}
    crashed = sum(
        1 for _n, p, _d in srv._leaves() for r in p.lane_rid if r is not None)
    if crashed and srv.obs.flight is not None:
        # post-mortem: a wedged lane is exactly what the flight recorder
        # exists for — dump the event ring before anyone resets the server
        crash_path = os.path.join(tempfile.gettempdir(),
                                  "repro_flight_crash.jsonl")
        srv.obs.flight.record("crash", crashed_lanes=int(crashed))
        n = srv.dump_flight_record(crash_path)
        print(f"[replay] {crashed} crashed lane(s): flight record "
              f"({n} events) -> {crash_path}")
    return ReplayReport(
        offered=offered,
        completed=completed,
        good=good,
        shed=shed,
        dropped=slo_d["dropped"],
        degraded=slo_d["degraded"],
        preempted=slo_d["preempted"],
        deadline_missed=slo_d["deadline_missed"],
        cache_hits=cache_hits,
        updates_applied=len(srv.update_log) - updates0,
        goodput=(good / offered) if offered else 0.0,
        wall_s=wall_s,
        crashed_lanes=crashed,
        total=percentiles(lat_all),
        per_algo={a: percentiles(ls) for a, ls in sorted(lat_algo.items())},
        per_tenant={t: percentiles(ls)
                    for t, ls in sorted(lat_tenant.items())},
        health=srv.stats().get("health"),
    )


def warmup(srv: GraphServer, algo_sources: Dict[str, int]) -> None:
    """Warm a server before a measured replay: on the card, build the
    serving kernels first (one `nvcc` a source, all together — the port's
    first launch pays a build, not a JIT compile); then one query per
    algorithm pool (drained), plus one forced admission through each
    degraded shadow pool, so no first launch lands inside the measurement
    window. Uses real scheduler paths; counter deltas are the caller's
    concern (`replay` snapshots at entry)."""
    if srv.g.device.type == "cuda":
        _build.build_all(SERVING_SOURCES)
    tenant0 = next(iter(srv.tenants))
    for algo, src in algo_sources.items():
        srv.submit(algo, src, tenant=tenant0)
    srv.drain()
    for name, dp in srv.degraded_pools.items():
        src = algo_sources.get(name, 0)
        rid = srv._next_rid
        srv._next_rid += 1
        srv.obs.tracer.begin(rid, name, src, next(iter(srv.tenants)),
                             srv.graph_version)
        srv._inflight_sources[rid] = src
        srv._inflight_tenants[rid] = next(iter(srv.tenants))
        dp.admit(dp.free_lanes()[0], rid, src)
        srv.obs.tracer.mark(rid, "admit")
        srv._degraded_rids.add(rid)
        srv.drain()
    # warmup results must not serve the measured replay from cache
    srv.cache.clear()
    # ... and warmup residencies must not poison the EWMA service-time
    # estimate: the first query per pool pays its kernel load in residency, which would make every deadline look hopeless to
    # SLOPolicy.hopeless_margin and over-trigger preemption slack
    for _name, pool, _deg in srv._leaves():
        pool.ewma_resident_s = None
