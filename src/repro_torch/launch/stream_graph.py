"""Streaming graph serving driver: replay an update trace against queries.

Port of `repro.launch.stream_graph`, with the same flags, printed lines and
`--verify` rule (DESIGN.md §8): an irregular stream of point queries is
served by the batched engine while the graph itself mutates underneath —
every `--update-every` submitted queries, a batch of random edge
insertions/deletions is applied through `GraphServer.apply_updates`, which
swaps the delta overlay into the pools, selectively invalidates the result
cache (clean sources keep their entries, dirty entries are refreshed
incrementally), resumes in-flight residual lanes and restarts the other
dirtied in-flight queries.

  PYTHONPATH=src python -m repro_torch.launch.stream_graph --requests 24 --slots 4

It runs on the card unless `--device cpu` asks for the CPU. The request
stream and the update batches come from numpy's `default_rng(--seed)`, call
for call as in the reference, so both drivers replay the same trace.

`--mesh DxS` streams through sharded pools (DESIGN.md §9/§11): updates then
ship only the changed shard rows or views and, with `--placement
edge_sharded`, exercise the frontier-compacted shard scan and CSR-free
admission. The mesh takes D*S GPUs under `--device cuda`, or puts every
shard on a named device (`cuda:0`, `cpu`).

With `--verify`, every completion is checked against a from-scratch run on
the graph version it was served under: bit-equal, except residual programs,
whose lanes resumed across an update are within 1e-3 in max abs.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.launch.catalog import algos_argtype, make_catalog, result_fields
from repro_torch.launch.serve_graph import build_graph, device_mesh, parse_mesh
from repro_torch.obs.trace import add_obs_cli_args, finish_obs_cli, obs_from_cli
from repro_torch.serving import (
    GraphServer,
    Placement,
    default_config,
    query_result,
    run_batch,
)
from repro_torch.streaming.incremental import is_residual


def random_update_batch(rng, sg, n_ins, n_del):
    """Inserts are uniform random pairs; deletes sample LIVE base edges.

    The draws are the reference's, call for call: its
    `rng.choice(live, k, replace=False)` over the live base positions
    equals the k-th live position of `rng.choice(len(live), k,
    replace=False)`, which is found from the sorted deleted positions
    without listing the live ones (130 M at RMAT scale 22)."""
    n = sg.n
    ins = [(int(rng.integers(0, n)), int(rng.integers(0, n)),
            float(rng.integers(1, 65))) for _ in range(n_ins)]
    dead = sg._dead_out_positions()
    n_live = sg._out_ci.shape[0] - dead.size
    dels = []
    if n_live and n_del:
        k = rng.choice(n_live, size=min(n_del, n_live), replace=False)
        # the k-th live position: k plus the deleted positions before it
        e = k + np.searchsorted(dead - np.arange(dead.size), k, side="right")
        rows = np.searchsorted(sg._out_rp, e, side="right") - 1
        for u, x in zip(rows, e):
            dels.append((int(u), int(sg._out_ci[x])))
    return ins, dels


def main(argv=None):
    catalog = make_catalog()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--graph", default="rmat", choices=("rmat", "uniform", "road"))
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--algos", default="bfs,sssp,ppr",
                    type=algos_argtype(catalog),
                    help=f"comma list from the registered catalog: "
                         f"{', '.join(sorted(catalog))}")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--update-every", type=int, default=8,
                    help="apply an update batch every N submitted queries")
    ap.add_argument("--inserts", type=int, default=4, help="insertions per batch")
    ap.add_argument("--deletes", type=int, default=2, help="deletions per batch")
    ap.add_argument("--delta-cap", type=int, default=256)
    ap.add_argument("--cache-cap", type=int, default=256)
    ap.add_argument("--hot-frac", type=float, default=0.25)
    ap.add_argument("--refresh", default="incremental",
                    choices=("incremental", "drop"))
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="",
                    help="stream through sharded pools on a DxS ('data' x "
                         "'model') mesh, e.g. 8x1 or 1x4; empty = "
                         "single-device pools")
    ap.add_argument("--placement", default="replicated",
                    choices=("replicated", "edge_sharded"),
                    help="pool placement on the --mesh")
    add_obs_cli_args(
        ap, trace_help="write per-request lifecycle spans as JSON lines "
                       "to this path (implies --telemetry); spans carry "
                       "the graph version each request completed on")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the graph and the pools (cuda, cuda:N "
                         "or cpu); with --mesh, cuda takes D*S GPUs and a "
                         "named device holds every shard")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = build_graph(args.graph, args.scale, args.edge_factor, args.seed, dev)
    n = g.n_nodes
    print(f"[stream_graph] {args.graph} scale={args.scale}: "
          f"{n} nodes, {g.n_edges} directed edges, delta_cap={args.delta_cap}")

    algos = args.algos                       # validated at argparse time
    programs = {a: catalog[a] for a in algos}

    mesh = None
    placements = None
    if args.mesh:
        d, s = parse_mesh(ap, args.mesh)
        if args.slots % d:
            ap.error(f"--slots {args.slots} must divide over {d} query shards")
        mesh = device_mesh(d, s, dev, "stream_graph")
        n_shards = d if args.placement == "replicated" else s
        placements = {a: Placement(args.placement, n_shards) for a in algos}
        print(f"[stream_graph] sharded pools: mesh {d}x{s}, "
              f"placement={args.placement}")

    srv = GraphServer(
        g, None, programs, slots=args.slots, cfg=default_config(g),
        cache_capacity=args.cache_cap, delta_cap=args.delta_cap,
        mesh=mesh, placements=placements,
        # pools default each algo's served field from its declared
        # 'result' param
        obs=obs_from_cli(args),
    )
    # version -> overlay views, for --verify of historical completions.
    # Only kept under --verify: each version pins its views.
    snapshots = {0: (srv.sg.graph, srv.sg.pack, srv.sg.delta)} \
        if args.verify else None

    rng = np.random.default_rng(args.seed)
    hot = rng.integers(0, n, size=max(1, args.requests // 8))
    t0 = time.time()
    for i in range(args.requests):
        algo = algos[i % len(algos)]
        src = int(rng.choice(hot)) if rng.random() < args.hot_frac \
            else int(rng.integers(0, n))
        rid = srv.submit(algo, src)
        while rid is None:
            srv.pump()
            rid = srv.submit(algo, src)
        srv.pump()                       # keep lanes busy while submitting
        if (i + 1) % args.update_every == 0:
            ins, dels = random_update_batch(
                rng, srv.sg, args.inserts, args.deletes)
            st = srv.apply_updates(ins, dels, refresh=args.refresh)
            if snapshots is not None:
                snapshots[st["version"]] = (
                    srv.sg.graph, srv.sg.pack, srv.sg.delta)
            print(f"[stream_graph] update v{st['version']}: "
                  f"+{st['inserted']}/-{st['deleted']} edges, "
                  f"cache retained {st['cache_retained']} "
                  f"refreshed {st['cache_refreshed']} "
                  f"dropped {st['cache_dropped']}, "
                  f"re-enqueued {st['reenqueued_inflight']}, "
                  f"resumed {st['resumed_inflight']}, "
                  f"rebuild={st['rebuild']}")
    comps = srv.drain()
    dt = time.time() - t0

    stats = srv.stats()
    finish_obs_cli(srv, args, "stream_graph")
    print(f"[stream_graph] {len(comps)} completions in {dt:.2f}s "
          f"({len(comps) / dt:.1f} q/s) across "
          f"{stats['updates']} update batches "
          f"(graph now v{stats['graph_version']}, "
          f"{srv.sg.stats()['rebuilds']} rebuilds)")
    cache = stats["cache"]
    print(f"[stream_graph] cache: {cache['hits']} hits / {cache['misses']} "
          f"misses (hit rate {cache['hit_rate']:.0%}), size {cache['size']}")

    if args.verify:
        fields = result_fields(programs)
        bad = 0
        for c in comps:
            ver = c.graph_version
            gv, pv, dv = snapshots[ver]
            ref, _ = run_batch(programs[c.algo], gv, pv,
                               default_config(g), [c.source], delta=dv)
            want = query_result(ref, fields[c.algo], 0).cpu().numpy()
            if is_residual(programs[c.algo]):
                # residual lanes RESUMED across an update are tol-accurate
                # (mid-run correction, DESIGN.md §10), not bitwise
                ok = np.abs(c.result - want).max() < 1e-3
            else:
                ok = np.array_equal(c.result, want)
            if not ok:
                bad += 1
                print(f"  MISMATCH rid={c.rid} {c.algo}({c.source}) v{ver}")
        print(f"[stream_graph] verify: {len(comps) - bad}/{len(comps)} OK")
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
