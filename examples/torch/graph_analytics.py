"""Graph-analytics pipeline on the PyTorch port: the paper's algorithm suite
over the graph zoo, with the Fig. 8-style JIT-management report (the
`examples/graph_analytics.py` journey, on the port's engine and kernels).

  PYTHONPATH=src python examples/torch/graph_analytics.py [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.core import algorithms as A
from repro_torch.core.engine import EngineConfig, run
from repro_torch.graph import generators, pack_ell
from repro_torch.graph.packing import pack_stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    graphs = {
        "social (rmat 4k)": generators.rmat(12, 8, seed=1, device=args.device),
        "road (grid 64x64)": generators.grid2d(64, seed=5, device=args.device),
    }
    algos = {
        "bfs": lambda: A.bfs(0),
        "sssp": lambda: A.sssp(0),
        "wcc": lambda: A.wcc(),
        "pagerank": lambda: A.pagerank(max_iters=32),
        "kcore(k=8)": lambda: A.kcore(k=8),
        "bp": lambda: A.belief_propagation(n_iters=8),
    }
    sync = torch.cuda.synchronize if torch.device(args.device).type == "cuda" else (lambda: None)
    for gname, g in graphs.items():
        pack = pack_ell(g.inc)
        st = pack_stats(pack)
        fill = {k: round(v["fill"], 2) for k, v in st.items()}
        print(f"\n== {gname}: {g.n_nodes} vertices, {g.n_edges} edges")
        print(f"   ELL buckets fill: {fill}")
        cfg = EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges)
        for aname, mk in algos.items():
            t0 = time.time()
            md, stats = run(mk(), g, pack, cfg)
            sync()
            dt = (time.time() - t0) * 1e3
            print(f"   {aname:12s} {dt:8.1f} ms  iters={int(stats['iterations']):4d} "
                  f"push={int(stats['push_iters']):4d} pull={int(stats['pull_iters']):3d} "
                  f"switches={int(stats['switches'])}")


if __name__ == "__main__":
    main()
