"""Graph partitioning for multi-device meshes.

Port of `repro.graph.partition`. Strategy (DESIGN.md §5): a 1-D *edge*
partition. Edges split into `n_shards` equal contiguous chunks (after the
CSR sort they are grouped by source); each shard holds (src, dst, w)
triples padded with the sentinel `n` to a multiple of 128 lanes. The
streaming overlay's COO lanes split round-robin (`shard_delta`), so each
inserted edge lands on exactly one shard.

The shards are built on the graph's device, where the sharded engine
keeps them; `*_np` copy the same arrays to the host, as the reference's
functions of those names return them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from repro_torch.core.acc import SUM_AGG
from repro_torch.graph.csr import EdgeDelta, Graph
from repro_torch.mesh import all_reduce


@dataclasses.dataclass(frozen=True)
class EdgeShards:
    """(S, E_pad) edge triples; sentinel src/dst == n_nodes."""

    src: torch.Tensor  # (S, E_pad) int32
    dst: torch.Tensor  # (S, E_pad) int32
    wgt: torch.Tensor  # (S, E_pad) float32
    n_nodes: int

    @property
    def n_shards(self) -> int:
        return self.src.shape[0]

    @property
    def edges_per_shard(self) -> int:
        return self.src.shape[1]


#: overlay re-slice counters (DESIGN.md §11): `full_reslice` counts the
#: round-robin re-slices of the overlay, `short_circuit` the single-shard
#: reshapes that copy nothing
SHARD_DELTA_STATS = {"full_reslice": 0, "short_circuit": 0}


def _edge_layout(m: int, n_shards: int, pad_multiple: int) -> int:
    per = -(-m // n_shards)
    return -(-per // pad_multiple) * pad_multiple


def shard_edges_np(g: Graph, n_shards: int, pad_multiple: int = 128) -> tuple:
    """Host (src, dst, wgt) slices of :func:`shard_edges`: (S, E_pad) numpy
    triples, the arrays the reference ships."""
    sh = shard_edges(g, n_shards, pad_multiple)
    return tuple(t.cpu().numpy() for t in (sh.src, sh.dst, sh.wgt))


def shard_edges(g: Graph, n_shards: int, pad_multiple: int = 128) -> EdgeShards:
    """Split the push-direction edge list into equal contiguous shards, on
    the graph's device."""
    n, m = g.n_nodes, g.n_edges
    per = _edge_layout(m, n_shards, pad_multiple)
    tot = per * n_shards

    def padded(t, fill):
        out = torch.full((tot,), fill, dtype=t.dtype, device=t.device)
        out[:m] = t
        return out.reshape(n_shards, per)

    return EdgeShards(src=padded(g.out.src_idx, n), dst=padded(g.out.col_idx, n),
                      wgt=padded(g.out.weights, 0.0), n_nodes=n)


def _deal(delta: EdgeDelta, n_shards: int, n_nodes: int = None) -> EdgeDelta:
    """The round-robin layout of :func:`shard_delta`, always copied and not
    counted."""
    cap = delta.src.shape[0]
    if n_nodes is None:
        n_nodes = int(delta.src.max()) if cap else 0  # the sentinel is the max by contract
    per = -(-cap // n_shards)
    tot = per * n_shards

    def rr(t, fill):
        out = torch.full((tot,), fill, dtype=t.dtype, device=t.device)
        out[:cap] = t
        return out.reshape(per, n_shards).T.contiguous()

    return EdgeDelta(src=rr(delta.src, n_nodes), dst=rr(delta.dst, n_nodes),
                     w=rr(delta.w, 0.0))


def shard_delta_np(delta: EdgeDelta, n_shards: int, n_nodes: int = None) -> tuple:
    """Host (src, dst, w) slices of :func:`shard_delta`: the (n_shards,
    ceil(cap / n_shards)) round-robin layout as numpy arrays."""
    d = _deal(delta, n_shards, n_nodes)
    return tuple(t.cpu().numpy() for t in (d.src, d.dst, d.w))


def shard_delta(delta: EdgeDelta, n_shards: int, n_nodes: int = None) -> EdgeDelta:
    """Split a streaming :class:`EdgeDelta` overlay into per-shard slices:
    (cap,) lanes -> (n_shards, ceil(cap / n_shards)), the lanes dealt
    round-robin, sentinel padding after them; on the overlay's device. The
    per-shard capacity depends only on (cap, n_shards).

    `n_shards == 1` is a reshape of the overlay's own lanes (no copy),
    counted in `SHARD_DELTA_STATS["short_circuit"]`; every other call is a
    `full_reslice`."""
    if n_shards == 1:
        SHARD_DELTA_STATS["short_circuit"] += 1
        cap = delta.src.shape[0]
        return EdgeDelta(src=delta.src.reshape(1, cap), dst=delta.dst.reshape(1, cap),
                         w=delta.w.reshape(1, cap))
    SHARD_DELTA_STATS["full_reslice"] += 1
    return _deal(delta, n_shards, n_nodes)


def shard_nodes(n_nodes: int, n_shards: int, pad_multiple: int = 8) -> int:
    """Padded per-shard node count for node-sharded state."""
    per = -(-n_nodes // n_shards)
    return -(-per // pad_multiple) * pad_multiple


def spmm_edge_sharded(shard_src: Sequence[torch.Tensor],
                      shard_dst: Sequence[torch.Tensor],
                      shard_wgt: Sequence[torch.Tensor],
                      feats: Sequence[torch.Tensor], n_nodes: int,
                      reduce: str = "sum") -> List[torch.Tensor]:
    """A distributed SpMM over an edge partition: each shard gathers its
    sources' rows of its copy of `feats` ((n+1, D), replicated), weights
    them, segment-combines them into a full (n, D) partial, and the
    partials meet in the mesh's sum all-reduce. Returns each shard's copy
    of the (n, D) result."""
    if reduce != "sum":
        raise ValueError(reduce)
    parts = []
    for src, dst, w, f in zip(shard_src, shard_dst, shard_wgt, feats):
        msg = f[src.long()] * w[:, None]
        parts.append(SUM_AGG.segment(msg, dst, n_nodes + 1)[:n_nodes])
    return all_reduce(parts, "sum")
