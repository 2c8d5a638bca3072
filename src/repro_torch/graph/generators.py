"""Synthetic graph generators mirroring the paper's benchmark families.

Port of `repro.graph.generators`. The random draws stay on the host in numpy
`default_rng(seed)`, call for call as in the reference, so the same seed gives
the same edges; the sort and dedupe of `from_edges` run on `device`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import Graph, from_edges


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def uniform_random(n: int, m: int, seed: int = 0, weighted: bool = True,
                   directed: bool = False, device="cuda") -> Graph:
    """GTgraph-style uniform random graph (paper's RD): uniform degrees."""
    r = _rng(seed)
    src = r.integers(0, n, size=m, dtype=np.int64)
    dst = r.integers(0, n, size=m, dtype=np.int64)
    w = _weights(r, m, weighted)
    return from_edges(src, dst, n, w, directed=directed, device=device)


def rmat_edges(n_log2: int, edge_factor: int = 16, a: float = 0.57,
               b: float = 0.19, c: float = 0.19, seed: int = 0,
               weighted: bool = True):
    """The host R-MAT draw: (src, dst, w) numpy arrays before `from_edges`."""
    n = 1 << n_log2
    m = n * edge_factor
    r = _rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for _ in range(n_log2):
        u = r.random(m)
        bit_src = (u >= ab).astype(np.int64)
        pcol = np.where(u < ab, b / ab, (abc - ab) / (1.0 - ab))
        v = r.random(m)
        bit_dst = (v >= pcol).astype(np.int64)
        src = (src << 1) | bit_src
        dst = (dst << 1) | bit_dst
    w = _weights(r, m, weighted)
    return src, dst, w


def rmat(n_log2: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, weighted: bool = True,
         directed: bool = False, device="cuda") -> Graph:
    """R-MAT / Kronecker generator (paper's KR & RM; Graph500 parameters)."""
    src, dst, w = rmat_edges(n_log2, edge_factor, a, b, c, seed, weighted)
    return from_edges(src, dst, 1 << n_log2, w, directed=directed,
                      device=device)


def grid2d(side: int, seed: int = 0, weighted: bool = True,
           device="cuda") -> Graph:
    """Road-network analogue (paper's ER / RC): 2-D lattice, diameter O(side)."""
    n = side * side
    ids = np.arange(n, dtype=np.int64).reshape(side, side)
    right_s, right_d = ids[:, :-1].ravel(), ids[:, 1:].ravel()
    down_s, down_d = ids[:-1, :].ravel(), ids[1:, :].ravel()
    src = np.concatenate([right_s, down_s])
    dst = np.concatenate([right_d, down_d])
    r = _rng(seed)
    w = _weights(r, src.shape[0], weighted)
    return from_edges(src, dst, n, w, directed=False, device=device)


def chain(n: int, weighted: bool = True, seed: int = 0, device="cuda") -> Graph:
    """Pathological diameter-(n-1) chain; stress test for iteration counts."""
    src = np.arange(n - 1, dtype=np.int64)
    dst = src + 1
    r = _rng(seed)
    return from_edges(src, dst, n, _weights(r, n - 1, weighted),
                      directed=False, device=device)


def star(n: int, seed: int = 0, weighted: bool = True, device="cuda") -> Graph:
    """One hub of degree n-1: the extreme case for the huge bucket."""
    src = np.zeros(n - 1, dtype=np.int64)
    dst = np.arange(1, n, dtype=np.int64)
    r = _rng(seed)
    return from_edges(src, dst, n, _weights(r, n - 1, weighted),
                      directed=False, device=device)


def batched_molecules(n_graphs: int, nodes_per_graph: int,
                      edges_per_graph: int, seed: int = 0,
                      device="cuda") -> Graph:
    """Block-diagonal batch of small random graphs (the `molecule` shape)."""
    r = _rng(seed)
    srcs, dsts = [], []
    for gi in range(n_graphs):
        base = gi * nodes_per_graph
        s = r.integers(0, nodes_per_graph, size=edges_per_graph, dtype=np.int64)
        d = r.integers(0, nodes_per_graph, size=edges_per_graph, dtype=np.int64)
        srcs.append(base + s)
        dsts.append(base + d)
    n = n_graphs * nodes_per_graph
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    return from_edges(src, dst, n, _weights(r, src.shape[0], True),
                      directed=False, device=device)


def _weights(r: np.random.Generator, m: int, weighted: bool) -> np.ndarray:
    """Random positive integer weights in [1, 64], as in the paper."""
    if not weighted:
        return np.ones(m, dtype=np.float32)
    return r.integers(1, 65, size=m).astype(np.float32)


#: name -> constructor(device) for the benchmark suite (the reference's
#: reduced-scale stand-ins: power-law social, uniform, road).
SUITE = {
    "rmat_s": lambda device="cuda": rmat(12, edge_factor=16, seed=1, device=device),
    "rmat_m": lambda device="cuda": rmat(14, edge_factor=16, seed=2, device=device),
    "uniform_s": lambda device="cuda": uniform_random(4096, 65536, seed=3, device=device),
    "uniform_m": lambda device="cuda": uniform_random(16384, 262144, seed=4, device=device),
    "road_s": lambda device="cuda": grid2d(64, seed=5, device=device),
    "road_m": lambda device="cuda": grid2d(160, seed=6, device=device),
}
