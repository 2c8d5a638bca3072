"""Open-loop SLO replay driver: bursty multi-tenant load against GraphServer.

Port of `repro.launch.slo_replay`, with the same flags, printed lines,
`--json` report and `--assert-goodput` gate, plus `--device` (default
cuda; the tests pass cpu).

Expands a seeded `repro.slo.Workload` (Poisson or bursty MMPP arrivals,
paid/batch tenant mix with per-class deadlines, optional interleaved
streaming update batches) and fires it open-loop at a server running the
full SLO policy stack (DESIGN.md §13): deadline drops, degraded shadow
pools for any residual program with a tolerance-rebuild contract, lane
preemption, consensus cohorts.

  PYTHONPATH=src python -m repro_torch.launch.slo_replay --arrival mmpp \\
      --rate 80 --duration 10 --deadline-ms 400

`--mesh DxS` serves through sharded replicated pools (degraded/preempt
shadow paths stay off; the drop half of the policy still runs). The mesh
takes D*S GPUs under `--device cuda`, or puts every shard on a named
device:

  PYTHONPATH=src python -m repro_torch.launch.slo_replay --mesh 4x1 \\
      --slots 8 --device cuda:0

`--assert-goodput` exits nonzero unless goodput > 0 with zero crashed
lanes — the CI smoke contract (`make smoke-slo`).
"""

from __future__ import annotations

import argparse
import json

from repro_torch._device import resolve_device
from repro_torch.graph import pack_ell
from repro_torch.launch.catalog import algos_argtype, make_catalog
from repro_torch.launch.serve_graph import build_graph, device_mesh, parse_mesh
from repro_torch.obs.trace import add_obs_cli_args, finish_obs_cli, obs_from_cli
from repro_torch.serving import GraphServer, Placement, default_config
from repro_torch.slo import SLOPolicy, TenantClass, Workload, generate, replay, warmup
from repro_torch.streaming.incremental import is_residual


def main(argv=None):
    catalog = make_catalog()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--graph", default="rmat", choices=("rmat", "uniform", "road"))
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--algos", default="bfs,sssp,ppr_delta",
                    type=algos_argtype(catalog),
                    help=f"comma list from the registered catalog: "
                         f"{', '.join(sorted(catalog))}; idempotent-combiner "
                         f"algos serve the paid tenant, the rest the batch "
                         f"tenant")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival", default="mmpp", choices=("poisson", "mmpp"))
    ap.add_argument("--rate", type=float, default=60.0,
                    help="time-averaged arrival rate (q/s)")
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--burst-factor", type=float, default=6.0)
    ap.add_argument("--deadline-ms", type=float, default=400.0,
                    help="paid-tenant deadline; the batch tenant gets 4x")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--queue-cap", type=int, default=128)
    ap.add_argument("--cohorts", type=int, default=1,
                    help="consensus cohorts per single-device pool")
    ap.add_argument("--update-every", type=float, default=0.0,
                    help="interleave a streaming update batch every N s")
    ap.add_argument("--no-policy", action="store_true",
                    help="deadlines accounted but no drop/degrade/preempt")
    ap.add_argument("--mesh", default="",
                    help="DxS serving mesh (replicated pools, global "
                         "consensus — the host-stepped serving loop requires "
                         "it; tail isolation comes from --cohorts on "
                         "single-device pools); empty = single-device")
    add_obs_cli_args(
        ap, trace_help="write lifecycle spans (with slo outcomes) as JSON "
                       "lines to this path")
    ap.add_argument("--assert-goodput", action="store_true",
                    help="exit 1 unless goodput > 0 and crashed_lanes == 0")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the graph and the pools (cuda, cuda:N "
                         "or cpu); with --mesh, cuda takes D*S GPUs and a "
                         "named device holds every shard")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = build_graph(args.graph, args.scale, args.edge_factor, args.seed, dev)
    pack = pack_ell(g.inc)
    print(f"[slo_replay] {args.graph} scale={args.scale}: {g.n_nodes} nodes, "
          f"{g.n_edges} edges")

    programs = {a: catalog[a] for a in args.algos}
    # Tenant mix from combiner metadata, not names: cheap idempotent
    # traversals (min/max combiners) are the latency-sensitive paid class,
    # sum-aggregation programs (residual PR family, BP-like) the batch
    # class. Either side empty -> both tenants share the whole set.
    paid = tuple(a for a, p in programs.items() if p.combiner.idempotent)
    batch = tuple(a for a in programs if a not in paid)
    paid = paid or tuple(programs)
    batch = batch or tuple(programs)
    w = Workload(
        arrival=args.arrival, rate_qps=args.rate, duration_s=args.duration,
        burst_factor=args.burst_factor, seed=args.seed,
        update_every_s=args.update_every,
        tenants=(
            TenantClass("paid", 2.0, tuple((a, 1.0) for a in paid),
                        deadline_ms=args.deadline_ms, hot_frac=0.3),
            TenantClass("batch", 1.0, tuple((a, 1.0) for a in batch),
                        deadline_ms=4 * args.deadline_ms),
        ),
    )
    arrivals = generate(w, g.n_nodes)
    print(f"[slo_replay] {args.arrival} arrivals: "
          f"{sum(a.kind == 'query' for a in arrivals)} queries, "
          f"{sum(a.kind == 'update' for a in arrivals)} update batches "
          f"over {args.duration:.0f}s at ~{args.rate:.0f} q/s")

    mesh = placements = None
    if args.mesh:
        d, s = parse_mesh(ap, args.mesh)
        mesh = device_mesh(d, s, dev, "slo_replay")
        placements = {a: Placement("replicated", d) for a in programs}
        print(f"[slo_replay] sharded replicated pools: mesh {d}x{s}")
    policy = None
    if not args.no_policy:
        # degraded/preempt pools are single-device machinery; on a mesh run
        # the policy keeps its drop half only. Degradation is offered to
        # every program that declares a tolerance-rebuild contract
        # (residual kind + with_tol), not to hard-coded names.
        degradable = tuple(a for a, p in programs.items()
                           if is_residual(p) and p.with_tol is not None)
        policy = SLOPolicy(
            degrade_algos=() if mesh is not None else degradable,
            degrade_queue_depth=max(2, args.slots // 2),
            degrade_slots=max(2, args.slots // 4),
            preempt=mesh is None,
            preempt_slack_s=args.deadline_ms / 1e3 / 4,
            preempt_min_resident_s=args.deadline_ms / 1e3 / 4,
        )
    srv = GraphServer(
        g, pack, programs, slots=args.slots, cfg=default_config(g),
        queue_cap=args.queue_cap,
        # pools default served fields from each program's 'result' param
        tenant_weights={"paid": 2.0, "batch": 1.0},
        delta_cap=256 if args.update_every > 0 else 0,
        mesh=mesh, placements=placements,
        cohorts=None if args.cohorts <= 1 else {
            a: args.cohorts for a in programs},
        slo=policy,
        obs=obs_from_cli(args),
    )
    warmup(srv, {a: 1 for a in programs})
    report = replay(srv, arrivals, max_wall_s=4 * args.duration + 60)
    finish_obs_cli(srv, args, "slo_replay")

    rep = report.to_json()
    if args.json:
        print(json.dumps(rep, indent=2))
    else:
        print(f"[slo_replay] offered={report.offered} "
              f"completed={report.completed} shed={report.shed} "
              f"dropped={report.dropped} degraded={report.degraded} "
              f"preempted={report.preempted} missed={report.deadline_missed}")
        print(f"[slo_replay] goodput={report.goodput:.3f} "
              f"wall={report.wall_s:.2f}s crashed_lanes={report.crashed_lanes}")
        if report.total:
            t = report.total
            print(f"[slo_replay] latency p50={t['p50_seconds'] * 1e3:.1f}ms "
                  f"p95={t['p95_seconds'] * 1e3:.1f}ms "
                  f"p99={t['p99_seconds'] * 1e3:.1f}ms (n={t['n']})")
        h = report.health
        if h and h.get("enabled"):
            lat, win = h["latency"], h["window"]
            print(f"[slo_replay] health: p²-p50={lat['p50_s'] * 1e3:.1f}ms "
                  f"p²-p99={lat['p99_s'] * 1e3:.1f}ms "
                  f"window goodput={win['goodput']:.3f} "
                  f"burn={win['burn_per_s']:.2f}/s")
    if args.assert_goodput:
        ok = report.goodput > 0 and report.crashed_lanes == 0
        print(f"[slo_replay] smoke gate: goodput>0 and zero crashed lanes -> "
              f"{'PASS' if ok else 'FAIL'}")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
