"""Seeded graph inputs, drawn on the device with a `torch.Generator`.

Rewritten in torch from `repro_torch/graph/generators.py` (`rmat_edges`,
`uniform_random`, `_weights`), which draw on the host in numpy: at scale 22
that draw takes most of a minute, and every run would pay it in set-up. The
Kronecker draw follows the Graph500 specification's `kronecker_generator`
(initiator A/B/C/D, one bit of each endpoint a level) and relabels the
vertices by a random permutation, so vertex ids do not follow degree. The
spec's shuffle of the edge order is left out: the port's build sorts the
edges, so their order changes nothing it computes.

What a run's seed changes. The graph's structure and weights are the
configuration's: drawn from its `graph_seed`. The run's `--seed` relabels
every vertex by a further random permutation and orders the configuration's
fixed pools of sources and batches (search keys keep the configuration's
order). So every seed gets the same work, under other vertex ids: on
Kronecker graphs the work of a search turns on the push/pull switches of
the whole graph, and graphs of two seeds differed by 8 % in Graph500 TEPS
where two runs of one seed agreed within 0.4 % (PERF.md).

The same seed on the same kind of device gives the same tensors.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Edges:
    """The undirected input edge list as drawn: (m,) int64 endpoints and
    (m,) float32 weights, self loops and repeats included. The port and the
    reference both start from these tensors. `perm` maps each vertex of the
    configuration's graph to its id in this run; `graph_seed` drew that
    graph."""

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    n: int
    perm: torch.Tensor
    graph_seed: int


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def kronecker_ids(scale: int, edge_factor: int, a: float, b: float, c: float,
                  gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Graph500 Kronecker endpoints before relabelling: each level draws one
    bit of the source (1 with probability C + D) and one of the
    destination (given the source's bit, 1 with probability B / (A + B) or
    D / (C + D))."""
    m = edge_factor << scale
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        i_bit = torch.rand(m, generator=gen, device=device) > ab
        p_j = torch.where(i_bit, c_norm, a_norm)
        j_bit = torch.rand(m, generator=gen, device=device) > p_j
        src |= i_bit.to(torch.int64) << level
        dst |= j_bit.to(torch.int64) << level
    return src, dst


def permutation(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """A random permutation of range(n): the Graph500 spec's relabelling
    (vertex v becomes p[v]), and the order of a pool."""
    return torch.randperm(n, generator=gen, device=device)


def kronecker(scale: int, edge_factor: int, a: float, b: float, c: float,
              gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Graph500 Kronecker endpoints, relabelled by a random permutation."""
    src, dst = kronecker_ids(scale, edge_factor, a, b, c, gen, device)
    perm = permutation(1 << scale, gen, device)
    return perm[src], perm[dst]


def uniform(scale: int, edge_factor: int, gen: torch.Generator, device
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform random endpoints (GAP's `urand`, Erdos-Renyi by edge count)."""
    n, m = 1 << scale, edge_factor << scale
    src = torch.randint(0, n, (m,), generator=gen, device=device)
    dst = torch.randint(0, n, (m,), generator=gen, device=device)
    return src, dst


def weights(m: int, lo: int, hi: int, gen: torch.Generator, device) -> torch.Tensor:
    """Integer weights uniform in [lo, hi], as float32 (GAP's generator
    draws [1, 255])."""
    return torch.randint(lo, hi + 1, (m,), generator=gen, device=device).to(torch.float32)


def draw(config: dict, seed: int, device) -> Edges:
    """The configuration's edge list, relabelled for the run's `seed`."""
    graph_seed = int(config["graph_seed"])
    gen = generator(graph_seed, device)
    kind, scale, ef = config["generator"], config["scale"], config["edge_factor"]
    if kind == "kronecker":
        a, b, c = config["initiator"]
        src, dst = kronecker(scale, ef, a, b, c, gen, device)
    elif kind == "uniform":
        src, dst = uniform(scale, ef, gen, device)
    else:
        raise ValueError(f"unknown generator {kind!r}")
    lo, hi = config["weights"]
    w = weights(src.shape[0], lo, hi, gen, device)
    perm = permutation(1 << scale, generator(seed, device), device)
    return Edges(perm[src], perm[dst], w, 1 << scale, perm, graph_seed)


def degrees(edges: Edges) -> torch.Tensor:
    """(n,) int64 degree of each vertex in the undirected graph the edges
    make once self loops are dropped (repeats counted)."""
    keep = edges.src != edges.dst
    deg = torch.bincount(edges.src[keep], minlength=edges.n)
    return deg + torch.bincount(edges.dst[keep], minlength=edges.n)


def pool(edges: Edges, count: int, salt: int) -> list[int]:
    """The configuration's pool `salt` of `count` distinct vertices of
    nonzero degree (all of them, repeated, where the graph has fewer), in
    the configuration's order, as this run's vertex ids."""
    dev = edges.src.device
    base = permutation(edges.n, generator(edges.graph_seed * 7919 + salt, dev), dev)
    live = base[degrees(edges)[edges.perm[base]] > 0]
    if live.numel() == 0:
        raise ValueError("the graph has no vertex of nonzero degree")
    return edges.perm[live.repeat(-(-count // live.numel()))[:count]].tolist()


def sources(edges: Edges, count: int, seed: int, salt: int) -> list[int]:
    """`pool(edges, count, salt)` in the order the run's `seed` draws."""
    dev = edges.src.device
    order = permutation(count, generator(seed * 7919 + salt, dev), dev).tolist()
    fixed = pool(edges, count, salt)
    return [fixed[i] for i in order]
