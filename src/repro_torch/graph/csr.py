"""Compressed-sparse-row graph structure (the paper's storage format, Sec. 6).

Port of `repro.graph.csr`. SIMD-X stores graphs in CSR and, for directed
graphs, keeps both the out-CSR (push) and the in-CSR (pull); :class:`Graph`
mirrors that. The pytrees of the reference become frozen dataclasses of
tensors that live on one device.

Construction takes host edge arrays (numpy, drawn by the seeded generators)
and sorts and deduplicates them on `device`, so a large graph is built on the
card; the arrays are equal to the reference's for the same inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class CSR:
    """One direction of adjacency in CSR form.

    Attributes:
      row_ptr: (n+1,) int32 — offsets into col_idx per source row.
      col_idx: (m,) int32 — neighbor ids.
      weights: (m,) float32 — edge weights (ones when unweighted).
      src_idx: (m,) int32 — row id per edge (CSR expanded).
    """

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    weights: torch.Tensor
    src_idx: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.col_idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def degrees(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]


@dataclasses.dataclass(frozen=True)
class Graph:
    """Push (out) + pull (in) adjacency. For undirected graphs both point at
    the same tensors (no copy)."""

    out: CSR  # push direction: row = src, col = dst
    inc: CSR  # pull direction: row = dst, col = src

    @property
    def n_nodes(self) -> int:
        return self.out.n_nodes

    @property
    def n_edges(self) -> int:
        return self.out.n_edges

    @property
    def device(self) -> torch.device:
        return self.out.device


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """Static-capacity COO overlay of inserted edges (push direction).

    Unused lanes hold the scratch sentinel `n` (src == dst == n, w == 0), so
    engines append all `cap` lanes to their edge buffers unconditionally.
    """

    src: torch.Tensor  # (cap,) int32; sentinel n when unused
    dst: torch.Tensor  # (cap,) int32; sentinel n when unused
    w: torch.Tensor    # (cap,) float32; 0 when unused

    @property
    def cap(self) -> int:
        return self.src.shape[0]


def empty_delta(n_nodes: int, cap: int, device="cuda") -> EdgeDelta:
    """All-sentinel delta (no insertions yet)."""
    dev = resolve_device(device)
    return EdgeDelta(
        src=torch.full((cap,), n_nodes, dtype=torch.int32, device=dev),
        dst=torch.full((cap,), n_nodes, dtype=torch.int32, device=dev),
        w=torch.zeros((cap,), dtype=torch.float32, device=dev),
    )


def delta_from_edges(src, dst, w, n_nodes: int, cap: int,
                     device="cuda") -> EdgeDelta:
    """Pack host insertion arrays into a sentinel-padded :class:`EdgeDelta`."""
    k = int(np.asarray(src).shape[0])
    if k > cap:
        raise ValueError(f"{k} inserted edges exceed delta capacity {cap}")
    s = np.full((cap,), n_nodes, dtype=np.int32)
    d = np.full((cap,), n_nodes, dtype=np.int32)
    ww = np.zeros((cap,), dtype=np.float32)
    if k:
        s[:k] = np.asarray(src, np.int32)
        d[:k] = np.asarray(dst, np.int32)
        ww[:k] = np.asarray(w, np.float32)
    dev = resolve_device(device)
    return EdgeDelta(torch.from_numpy(s).to(dev), torch.from_numpy(d).to(dev),
                     torch.from_numpy(ww).to(dev))


# ---------------------------------------------------------------------------
# construction (sort and dedupe on `device`)
# ---------------------------------------------------------------------------


def _csr_arrays(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, n: int
                ) -> CSR:
    """Sort edges by (src, dst) — stable, like the reference's lexsort — and
    build row_ptr/col_idx/weights/src_idx."""
    key = src * n + dst
    order = torch.sort(key, stable=True).indices
    src, dst, w = src[order], dst[order], w[order]
    counts = torch.bincount(src, minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    return CSR(row_ptr.to(torch.int32), dst.to(torch.int32),
               w.to(torch.float32), src.to(torch.int32))


def from_edges(
    src,
    dst,
    n_nodes: int,
    weights=None,
    directed: bool = False,
    dedupe: bool = True,
    device="cuda",
) -> Graph:
    """Build a :class:`Graph` from host edge arrays.

    Drops self loops; for undirected graphs stores both directions (in/out
    CSR then share tensors); with `dedupe` keeps the minimum-weight edge of
    each (u, v) pair. Arrays are equal to `repro.graph.csr.from_edges`'.
    """
    dev = resolve_device(device)
    src = torch.as_tensor(np.asarray(src, dtype=np.int64)).to(dev)
    dst = torch.as_tensor(np.asarray(dst, dtype=np.int64)).to(dev)
    if weights is None:
        weights = np.ones(src.shape[0], dtype=np.float32)
    w = torch.as_tensor(np.asarray(weights, dtype=np.float32)).to(dev)

    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]

    if not directed:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
        w = torch.cat([w, w])

    if dedupe:
        # lexsort((weights, key)): stable sort by weight, then by key
        key = src * n_nodes + dst
        order = torch.sort(w, stable=True).indices
        order = order[torch.sort(key[order], stable=True).indices]
        key_s = key[order]
        first = torch.ones(key_s.shape[0], dtype=torch.bool, device=dev)
        first[1:] = key_s[1:] != key_s[:-1]
        idx = order[first]
        src, dst, w = src[idx], dst[idx], w[idx]

    out = _csr_arrays(src, dst, w, n_nodes)
    inc = _csr_arrays(dst, src, w, n_nodes) if directed else out
    return Graph(out=out, inc=inc)


def to_undirected(g: Graph) -> Graph:
    """Symmetrize a directed graph (host round-trip, as in the reference)."""
    return from_edges(g.out.src_idx.cpu().numpy(), g.out.col_idx.cpu().numpy(),
                      g.n_nodes, g.out.weights.cpu().numpy(), directed=False,
                      device=g.device)


def host_degrees(g: Graph) -> np.ndarray:
    rp = g.out.row_ptr.cpu().numpy()
    return rp[1:] - rp[:-1]


def live_degrees(csr: CSR, delta: Optional[EdgeDelta] = None) -> torch.Tensor:
    """(n,) int32 live out-degrees of a possibly-overlaid CSR: non-sentinel
    slots plus the delta's COO lanes. On a plain graph equals `degrees()`.

    Sentinel delta lanes (src == n) land in an (n+1)-th scratch bin that is
    sliced off — the reference's `mode="drop"`.
    """
    n = csr.n_nodes
    live = (csr.col_idx != n).to(torch.int32)
    deg = torch.zeros((n + 1,), dtype=torch.int32, device=csr.device)
    deg.index_add_(0, csr.src_idx.long(), live)
    if delta is not None:
        dsrc = torch.clamp(delta.src.long(), max=n)
        deg.index_add_(0, dsrc, (delta.src < n).to(torch.int32))
    return deg[:n]
