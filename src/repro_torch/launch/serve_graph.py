"""Graph query serving driver: continuous batching over a shared graph.

Port of `repro.launch.serve_graph`, with the same flags and printed lines:
an irregular stream of point queries (BFS / SSSP / personalized PageRank
from random sources, with a configurable hot set so the LRU cache sees
repeats) is admitted into fixed per-algorithm query slots and served by
the batched multi-query engine (`repro_torch.serving`).

  PYTHONPATH=src python -m repro_torch.launch.serve_graph --requests 8 --slots 4

It runs on the card unless `--device cpu` asks for the CPU. The source
stream is numpy's `default_rng(--seed)`, as in the reference, so both
drivers serve the same requests. `--mesh` (sharded pools) is ROADMAP
queue 1 item 8 and is refused.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.graph import generators, pack_ell
from repro_torch.launch.catalog import algos_argtype, make_catalog
from repro_torch.obs.trace import add_obs_cli_args, finish_obs_cli, obs_from_cli
from repro_torch.serving import GraphServer, SLOPolicy, default_config


def build_graph(kind: str, scale: int, edge_factor: int, seed: int, device):
    if kind == "rmat":
        return generators.rmat(scale, edge_factor, seed=seed, device=device)
    if kind == "uniform":
        n = 1 << scale
        return generators.uniform_random(n, n * edge_factor, seed=seed,
                                         device=device)
    if kind == "road":
        return generators.grid2d(1 << (scale // 2), seed=seed, device=device)
    raise ValueError(kind)


def main(argv=None):
    catalog = make_catalog()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--graph", default="rmat", choices=("rmat", "uniform", "road"))
    ap.add_argument("--scale", type=int, default=10,
                    help="log2 node count (rmat/uniform)")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--algos", default="bfs,sssp,ppr",
                    type=algos_argtype(catalog),
                    help=f"comma list from the registered catalog: "
                         f"{', '.join(sorted(catalog))}")
    ap.add_argument("--slots", type=int, default=4, help="query slots per algorithm")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--queue-cap", type=int, default=256)
    ap.add_argument("--cache-cap", type=int, default=256)
    ap.add_argument("--hot-frac", type=float, default=0.25,
                    help="fraction of requests drawn from a small hot source set")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="",
                    help="sharded pools on a DxS mesh: not ported yet "
                         "(ROADMAP queue 1 item 8); empty = single-device pools")
    ap.add_argument("--placement", default="replicated",
                    choices=("replicated", "edge_sharded"),
                    help="pool placement on the --mesh")
    add_obs_cli_args(ap)
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="attach this latency SLO to every query and drop "
                         "already-expired queued queries (DESIGN.md §13); "
                         "0 = no deadlines")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the graph and the pools (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error(f"--mesh {args.mesh!r}: sharded pools are not ported yet "
                 "(ROADMAP queue 1 item 8)")
    dev = resolve_device(args.device)

    g = build_graph(args.graph, args.scale, args.edge_factor, args.seed, dev)
    pack = pack_ell(g.inc)
    n = g.n_nodes
    print(f"[serve_graph] {args.graph} scale={args.scale}: "
          f"{n} nodes, {g.n_edges} directed edges")

    algos = args.algos                       # validated at argparse time
    programs = {a: catalog[a] for a in algos}

    deadline_ms = args.deadline_ms if args.deadline_ms > 0 else None
    srv = GraphServer(
        g, pack, programs, slots=args.slots, cfg=default_config(g),
        queue_cap=args.queue_cap, cache_capacity=args.cache_cap,
        # pools default each algo's served field from its declared
        # 'result' param — no per-name table needed
        obs=obs_from_cli(args),
        slo=SLOPolicy() if deadline_ms is not None else None,
    )

    rng = np.random.default_rng(args.seed)
    hot = rng.integers(0, n, size=max(1, args.requests // 8))
    t0 = time.time()
    submitted = 0
    backpressured = 0
    while submitted < args.requests:
        algo = algos[submitted % len(algos)]
        if rng.random() < args.hot_frac:
            src = int(rng.choice(hot))
        else:
            src = int(rng.integers(0, n))
        rid = srv.submit(algo, src, deadline_ms=deadline_ms)
        if rid is None:                 # queue full: serve a round, retry
            backpressured += 1
            srv.pump()
            continue
        submitted += 1
    comps = srv.drain()
    dt = time.time() - t0

    stats = srv.stats()
    assert len(comps) == args.requests, (len(comps), args.requests)
    print(f"[serve_graph] {len(comps)} queries in {dt:.2f}s "
          f"({len(comps) / dt:.1f} q/s), backpressure events: {backpressured}")
    if deadline_ms is not None:
        s = stats["slo"]
        print(f"[serve_graph] slo: deadline={deadline_ms:.0f}ms, "
              f"{s['deadline_missed']} missed, {s['dropped']} dropped")
    cache = stats["cache"]
    print(f"[serve_graph] cache: {cache['hits']} hits / {cache['misses']} misses "
          f"(hit rate {cache['hit_rate']:.0%})")
    for name, p in stats["pools"].items():
        place = "" if p["placement"] == "single" else f" [{p['placement']}]"
        print(f"[serve_graph]   pool {name}: {p['engine_queries']} engine queries, "
              f"{p['steps']} batched steps x {p['slots']} slots{place}")
        if "tele" in p:
            t = p["tele"]
            print(f"[serve_graph]     tele: {t['push_edges_scanned']} push / "
                  f"{t['pull_edges_scanned']} pull edges scanned, "
                  f"{t['compact_hits']} compact hits / "
                  f"{t['compact_dense_fallbacks']} dense fallbacks")
    if srv.obs.enabled:
        m = stats["obs"]["metrics"]
        for name in stats["pools"]:
            s = m.get(f"{name}.latency_total_s")
            if s:
                print(f"[serve_graph]   latency {name}: "
                      f"p50={s['p50'] * 1e3:.1f}ms p95={s['p95'] * 1e3:.1f}ms "
                      f"p99={s['p99'] * 1e3:.1f}ms (n={s['count']})")
        for name, p in stats["pools"].items():
            imb = p.get("imbalance")
            if imb:
                print(f"[serve_graph]   imbalance {name}: "
                      f"skew={imb['skew']:.2f} "
                      f"shard_edges={imb['shard_edges']}")
    finish_obs_cli(srv, args, "serve_graph")
    for c in comps[:3]:
        head = ("DROPPED" if c.result is None
                else np.array2string(c.result[:4], precision=3))
        print(f"  rid {c.rid} {c.algo}(src={c.source}) iters={c.iterations} "
              f"cache={c.from_cache} result[:4]={head}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
