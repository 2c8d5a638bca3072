"""The plain reference: BFS, SSSP and personalized PageRank worked out again
from the drawn edge list, in plain PyTorch.

It imports nothing of the port and takes nothing the port made: it builds
its own adjacency from the `gen.Edges` the benchmark drew and handed to
both sides. The graph is the undirected simple graph of those edges: self
loops dropped, both directions present, a repeated pair counted once (for
BFS and SSSP a repeat changes nothing, since only the least weight can win a
minimum; PPR divides by the degree of the simple graph).

`dtype` is the precision the values are held in. The default computes in
float64, above the port's float32. The control, the reference put in the
program's place where the comparison must fail, holds them in
`torch.bfloat16`, one precision below the configuration's float32: GAP's
weights in [1, 255] take distances past 256, where bfloat16 stops holding
integers.
"""

from __future__ import annotations

import math
import warnings

import torch

#: the distance the port writes for a vertex it never reaches is f32max / 4;
#: anything at or above this counts as unreached
UNREACHED = 1e37


class Adjacency:
    """Directed copies of every non-loop input edge: (2m',) endpoints and
    weights, for BFS and SSSP."""

    def __init__(self, edges):
        keep = edges.src != edges.dst
        s, d, w = edges.src[keep], edges.dst[keep], edges.w[keep]
        self.n = edges.n
        self.src = torch.cat([s, d])
        self.dst = torch.cat([d, s])
        self.w = torch.cat([w, w])


def bfs(adj: Adjacency, root: int) -> torch.Tensor:
    """(n,) float64 hop count from `root`, inf where unreached."""
    dev = adj.src.device
    level = torch.full((adj.n,), math.inf, dtype=torch.float64, device=dev)
    level[root] = 0
    frontier = torch.zeros(adj.n, dtype=torch.bool, device=dev)
    frontier[root] = True
    depth = 0
    while bool(frontier.any()):
        depth += 1
        hit = adj.dst[frontier[adj.src]]
        nxt = torch.zeros_like(frontier)
        nxt[hit] = True
        nxt &= torch.isinf(level)
        level[nxt] = depth
        frontier = nxt
    return level


def sssp(adj: Adjacency, root: int, dtype=torch.float64) -> torch.Tensor:
    """(n,) shortest distance from `root` (Bellman-Ford over the edges that
    leave a vertex whose distance fell), inf where unreached. Distances and
    their sums are held in `dtype`; the minimum picks one of its inputs, so
    it runs in float64 whatever `dtype` is."""
    dev = adj.src.device
    dist = torch.full((adj.n,), math.inf, dtype=torch.float64, device=dev)
    dist[root] = 0
    w = adj.w.to(dtype)
    changed = torch.zeros(adj.n, dtype=torch.bool, device=dev)
    changed[root] = True
    while bool(changed.any()):
        live = changed[adj.src]
        cand = (dist[adj.src[live]].to(dtype) + w[live]).to(torch.float64)
        new = dist.scatter_reduce(0, adj.dst[live], cand, reduce="amin")
        changed = new < dist
        dist = new
    return dist


def simple_csr(edges, dtype=torch.float64):
    """(A, deg): the simple undirected graph as an (n, n) sparse CSR matrix
    of ones, with A[v, u] = 1 for each neighbour u of v, and the (n,) degree."""
    n = edges.n
    keep = edges.src != edges.dst
    lo = torch.minimum(edges.src[keep], edges.dst[keep])
    hi = torch.maximum(edges.src[keep], edges.dst[keep])
    key = torch.unique(lo * n + hi)
    lo, hi = key // n, key % n
    rows = torch.cat([lo, hi])
    cols = torch.cat([hi, lo])
    order = torch.argsort(rows * n + cols)
    rows, cols = rows[order], cols[order]
    deg = torch.bincount(rows, minlength=n)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(deg, 0, out=crow[1:])
    ones = torch.ones(cols.shape[0], dtype=dtype, device=rows.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)      # "sparse CSR is in beta"
        a = torch.sparse_csr_tensor(crow, cols, ones, (n, n), check_invariants=False)
    return a, deg


def ppr(a_csr, deg: torch.Tensor, roots, damping: float, tol: float,
        max_iters: int, dtype=torch.float64) -> torch.Tensor:
    """(n, len(roots)) personalized PageRank by power iteration, one column
    a root: rank <- (1 - d) pref + d A (rank / max(deg, 1)), each column
    stopped after the first iteration in which no entry moved by more than
    `tol`, or after `max_iters`. Values are rounded to `dtype` after every
    operation; the products run in float64 (float32 for a `dtype` below it)."""
    n, q = a_csr.shape[0], len(roots)
    dev = deg.device
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    a = a_csr.to(acc) if a_csr.dtype != acc else a_csr
    degf = deg.clamp(min=1).to(dtype)[:, None]
    pref = torch.zeros((n, q), dtype=dtype, device=dev)
    pref[torch.as_tensor(roots, device=dev), torch.arange(q, device=dev)] = 1
    rank = pref.clone()
    live = torch.ones(q, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        contrib = (rank / degf).to(dtype)
        seg = (a @ contrib.to(acc)).to(dtype)
        new = ((1 - damping) * pref + damping * seg).to(dtype)
        moved = ((new - rank).abs() > tol).any(0)
        rank = torch.where(live[None, :], new, rank)
        live &= moved
        if not bool(live.any()):
            break
    return rank.to(torch.float64)


class RefGraph:
    """The reference's views of one edge list, built when first needed."""

    def __init__(self, edges):
        self.edges = edges
        self._adj = None
        self._csr = None

    @property
    def adj(self) -> Adjacency:
        if self._adj is None:
            self._adj = Adjacency(self.edges)
        return self._adj

    @property
    def csr(self):
        if self._csr is None:
            self._csr = simple_csr(self.edges)
        return self._csr
