"""Fanout neighbour sampler (GraphSAGE-style) for the `minibatch_lg` shape.

Port of `repro.graph.sampler`. Samples with replacement, uniformly over
each vertex's neighbour list: a vertex of degree d contributes exactly
`fanout` sampled edges, drawn as `rp[v] + (r % d)`, so every shape is
static. Zero-degree vertices loop to themselves.

  * `sample_block` — on the seeds' device, with a `torch.Generator` (the
    reference's `jax.random` draws cannot be matched; the block holds the
    same invariants: each neighbour lies in the adjacency, a zero-degree
    seed loops to itself, the shapes are static).
  * `host_sample`  — the numpy mirror for tests, bit-equal to the
    reference's.

A `Block` is one bipartite layer: edges from the sampled neighbours into
the seed set, with local destination indices. Multi-hop sampling composes
blocks: the nodes of hop k are the seeds of hop k + 1.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.graph.csr import CSR

INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class Block:
    """One sampled bipartite layer.

    src_nodes: (S*F,) int32 global ids of sampled neighbours (with repeats).
    dst_local: (S*F,) int32 local index of the seed each edge points to.
    seeds:     (S,)   int32 global ids of the destination side.
    """

    src_nodes: torch.Tensor
    dst_local: torch.Tensor
    seeds: torch.Tensor


def sample_block(csr: CSR, seeds: torch.Tensor, fanout: int,
                 generator: torch.Generator) -> Block:
    """Sample `fanout` neighbours a seed, with replacement; `generator`
    lives on the seeds' device."""
    s = seeds.shape[0]
    sl = seeds.long()
    deg = csr.row_ptr[sl + 1] - csr.row_ptr[sl]
    r = torch.randint(0, INT32_MAX, (s, fanout), generator=generator,
                      dtype=torch.int32, device=seeds.device)
    off = r % deg.clamp_min(1)[:, None]
    flat = csr.row_ptr[sl][:, None] + off
    nbrs = csr.col_idx[flat.long()]                                   # (S, F)
    nbrs = torch.where(deg[:, None] > 0, nbrs, seeds[:, None].to(nbrs.dtype))
    dst_local = torch.arange(s, dtype=torch.int32, device=seeds.device)[:, None]
    return Block(src_nodes=nbrs.reshape(-1).to(torch.int32),
                 dst_local=dst_local.expand(s, fanout).reshape(-1),
                 seeds=seeds.to(torch.int32))


def sample_multihop(csr: CSR, seeds: torch.Tensor, fanouts: Sequence[int],
                    generator: torch.Generator) -> list[Block]:
    """Compose blocks outward: block 0 samples around the seeds, block k
    around the previous hop's sampled nodes (applied in reverse in the
    forward pass, as GraphSAGE lays it out)."""
    blocks = []
    cur = seeds
    for f in fanouts:
        b = sample_block(csr, cur, f, generator)
        blocks.append(b)
        cur = b.src_nodes
    return blocks


def block_shapes(batch_nodes: int, fanouts: Sequence[int]) -> list[tuple[int, int]]:
    """Static (n_seeds, n_edges) of each hop."""
    shapes = []
    cur = batch_nodes
    for f in fanouts:
        shapes.append((cur, cur * f))
        cur = cur * f
    return shapes


def host_sample(csr_rp: np.ndarray, csr_ci: np.ndarray, seeds: np.ndarray,
                fanout: int, seed: int = 0):
    """Numpy mirror of `sample_block` for oracle tests."""
    r = np.random.default_rng(seed)
    deg = csr_rp[seeds + 1] - csr_rp[seeds]
    out_src = np.empty((len(seeds), fanout), dtype=np.int64)
    for i, v in enumerate(seeds):
        if deg[i] == 0:
            out_src[i] = v
        else:
            off = r.integers(0, deg[i], size=fanout)
            out_src[i] = csr_ci[csr_rp[v] + off]
    return out_src
