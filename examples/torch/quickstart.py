"""Quickstart for the PyTorch port: write a graph algorithm in ~10 lines of
ACC and run it on the SIMD-X engine.

Here: single-source widest-path (maximin bottleneck), an algorithm not in
the paper, defined from scratch with Active/Compute/Combine. Its Compute,
min(width[u], w_uv), is none of the four ops the CUDA pull kernel is
stamped for (`ACCProgram.kernel_compute`), so the pull runs its Compute in
PyTorch (`pull_impl="torch"`); the push Combine is still the
`segment_reduce` kernel on the card.

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""

import argparse
import heapq

import numpy as np
import torch

from repro_torch.core.acc import ACCProgram, Combiner
from repro_torch.core.engine import EngineConfig, run
from repro_torch.graph import generators, pack_ell


def widest_path(src: int) -> ACCProgram:
    """width[v] = max over paths of the min edge weight along the path."""

    def init(n, deg, source=src):
        w0 = torch.zeros((n + 1,), dtype=torch.float32, device=deg.device)
        w0[source] = float("inf")
        return {"width": w0}, torch.tensor([source], dtype=torch.int32, device=deg.device)

    # Compute: the width through edge (u -> v) is min(width[u], w_uv)
    def compute(sender, w, receiver):
        return torch.minimum(sender["width"], w)

    # Combine: keep the MAX candidate width per destination
    def active(new, old, it):
        return new["width"] > old["width"]

    return ACCProgram(
        name="widest_path",
        combiner=Combiner("max", "aggregation"),
        init=init, compute=compute, active=active, primary="width",
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    g = generators.rmat(11, 8, seed=7, device=args.device)   # 2048-node power-law graph
    pack = pack_ell(g.inc)
    cfg = EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges, pull_impl="torch")
    md, stats = run(widest_path(0), g, pack, cfg)

    width = md["width"][: g.n_nodes].cpu().numpy()
    reached = np.isfinite(width) & (width > 0)
    print(f"graph: {g.n_nodes} vertices / {g.n_edges} edges")
    print(f"iterations: {int(stats['iterations'])} "
          f"(push {int(stats['push_iters'])}, pull {int(stats['pull_iters'])}, "
          f"{int(stats['switches'])} JIT filter switches)")
    print(f"reachable: {int(reached.sum())} vertices; "
          f"median bottleneck width {np.median(width[reached]):.0f}")

    # sanity: verify against a numpy maximin Dijkstra
    rp, ci, w = (g.out.row_ptr.cpu().numpy(), g.out.col_idx.cpu().numpy(),
                 g.out.weights.cpu().numpy())
    exp = np.zeros(g.n_nodes)
    exp[0] = np.inf
    h = [(-np.inf, 0)]
    while h:
        negw, v = heapq.heappop(h)
        if -negw < exp[v]:
            continue
        for e in range(rp[v], rp[v + 1]):
            u, cand = ci[e], min(exp[v], w[e])
            if cand > exp[u]:
                exp[u] = cand
                heapq.heappush(h, (-cand, u))
    ok = np.allclose(np.where(np.isinf(width), np.inf, width),
                     np.where(np.isinf(exp), np.inf, exp))
    print("matches numpy maximin-dijkstra:", ok)
    assert ok


if __name__ == "__main__":
    main()
