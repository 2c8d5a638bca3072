"""Degree-bucketed ELL packing — SIMD-X worklist binning as dense slices.

Port of `repro.graph.packing`. Rows (vertices) are binned by degree into
buckets `(4, 32, 256)`; each bucket is padded to its width and laid out as an
(R, W) rectangle; rows above the last bucket are split into virtual rows of
`split` slots. On Hopper the buckets map back to the paper's own hierarchy:
the `ell_combine` kernel reduces a width-4 row in one thread and a width-32
or width-256 row in one warp (kernels/ell_spmv.py).

The packing runs with tensor ops on the CSR's device; slices are
array-equal to the reference's (same buckets, split, sentinel `n` and
`min_rows`). `pack_ell` builds no CSR-edge -> slot map; only
`pack_ell_with_positions` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.graph.csr import CSR

#: bucket upper bounds (inclusive): ~thread (4), ~warp (32), ~CTA (256)
DEFAULT_BUCKETS: tuple[int, ...] = (4, 32, 256)
#: virtual-row split width for the "huge" regime
DEFAULT_SPLIT: int = 256


@dataclasses.dataclass(frozen=True)
class EllSlice:
    """One degree bucket packed as a (rows, width) rectangle; nbr padded with
    the sentinel n, wgt with 0; `row_id` maps each (virtual) row to its
    vertex (sentinel rows map to the scratch slot n).

    `rows_ascending` says that `row_id` is ascending by construction, as
    the degree buckets of `pack_ell` are: the pull merges then hand the ids
    straight to `segment_reduce`, whose CUDA kernel needs them ascending.
    The streaming delta slice lists receivers in insertion order, so it
    keeps the default and its merge sorts first."""

    nbr: torch.Tensor     # (R, W) int32
    wgt: torch.Tensor     # (R, W) float32
    row_id: torch.Tensor  # (R,) int32
    rows_ascending: bool = False

    @property
    def rows(self) -> int:
        return self.nbr.shape[0]

    @property
    def width(self) -> int:
        return self.nbr.shape[1]


@dataclasses.dataclass(frozen=True)
class EllPack:
    """All buckets for one direction of a graph."""

    slices: tuple[EllSlice, ...]
    n_nodes: int


def _round_up(x: int, to: int) -> int:
    return ((x + to - 1) // to) * to


def pack_ell(csr: CSR, buckets: Sequence[int] = DEFAULT_BUCKETS,
             split: int = DEFAULT_SPLIT, min_rows: int = 8) -> EllPack:
    """Bucket rows of `csr` by degree and pack each bucket as an ELL slice,
    on the CSR's device."""
    return _pack(csr, buckets, split, min_rows, pos=None)


def pack_ell_with_positions(csr: CSR, buckets: Sequence[int] = DEFAULT_BUCKETS,
                            split: int = DEFAULT_SPLIT, min_rows: int = 8
                            ) -> tuple[EllPack, torch.Tensor]:
    """`pack_ell` plus the (m, 3) int64 map on the CSR's device: CSR edge e
    landed in `pack.slices[pos[e, 0]].nbr[pos[e, 1], pos[e, 2]]` (the
    reference returns the same map as a host array)."""
    pos = torch.full((csr.n_edges, 3), -1, dtype=torch.int64, device=csr.device)
    return _pack(csr, buckets, split, min_rows, pos=pos), pos


def _pack(csr: CSR, buckets, split, min_rows, pos: Optional[torch.Tensor]
          ) -> EllPack:
    rp = csr.row_ptr.long()
    n = csr.n_nodes
    deg = rp[1:] - rp[:-1]
    slices: list[EllSlice] = []
    lo = 0
    for hi in buckets:
        sel = torch.nonzero((deg > lo) & (deg <= hi)).flatten()
        slices.append(_pack_rows(sel, rp[sel], rp[sel + 1], csr, hi, min_rows,
                                 pos, len(slices)))
        lo = hi

    # huge bucket: ceil(deg/split) virtual rows of `split` slots each
    sel = torch.nonzero(deg > buckets[-1]).flatten()
    nchunk = (deg[sel] + split - 1) // split
    vid = torch.repeat_interleave(sel, nchunk)
    first = torch.cumsum(nchunk, 0) - nchunk
    k = torch.arange(vid.shape[0], device=rp.device) - torch.repeat_interleave(first, nchunk)
    vstart = rp[vid] + split * k
    vend = torch.minimum(vstart + split, rp[vid + 1])
    slices.append(_pack_rows(vid, vstart, vend, csr, split, min_rows, pos,
                             len(slices)))
    return EllPack(slices=tuple(slices), n_nodes=int(n))


def _pack_rows(row_ids, start, end, csr: CSR, width, min_rows, pos, slice_idx
               ) -> EllSlice:
    dev = csr.device
    n = csr.n_nodes
    r = row_ids.shape[0]
    rows = max(min_rows, _round_up(max(r, 1), min_rows))
    nbr = torch.full((rows, width), n, dtype=torch.int32, device=dev)
    wgt = torch.zeros((rows, width), dtype=torch.float32, device=dev)
    rid = torch.full((rows,), n, dtype=torch.int32, device=dev)
    if r > 0:
        lens = end - start
        rr = torch.repeat_interleave(torch.arange(r, device=dev), lens)
        offs = torch.cumsum(lens, 0) - lens
        cc = torch.arange(rr.shape[0], device=dev) - torch.repeat_interleave(offs, lens)
        flat_src = torch.repeat_interleave(start, lens) + cc
        nbr[rr, cc] = csr.col_idx[flat_src]
        wgt[rr, cc] = csr.weights[flat_src]
        rid[:r] = row_ids.to(torch.int32)
        if pos is not None:
            pos[flat_src, 0] = slice_idx
            pos[flat_src, 1] = rr
            pos[flat_src, 2] = cc
    return EllSlice(nbr, wgt, rid, rows_ascending=True)


def delta_ell_slice(dst, src, w, n: int, cap: int, min_rows: int = 8,
                    device="cuda") -> EllSlice:
    """Pack inserted in-edges as one static-shape width-1 ELL slice: one row
    per inserted edge (`row_id = dst`, `nbr = src`), padded to `cap` rows.
    Rows keep insertion order, as the reference's do, so `row_id` is not
    ascending (`rows_ascending` False)."""
    rows = max(min_rows, _round_up(max(cap, 1), min_rows))
    k = int(np.asarray(dst).shape[0])
    if k > cap:
        raise ValueError(f"{k} delta edges exceed the delta capacity {cap}")
    nbr = np.full((rows, 1), n, dtype=np.int32)
    wgt = np.zeros((rows, 1), dtype=np.float32)
    rid = np.full(rows, n, dtype=np.int32)
    if k:
        nbr[:k, 0] = np.asarray(src, np.int32)
        wgt[:k, 0] = np.asarray(w, np.float32)
        rid[:k] = np.asarray(dst, np.int32)
    dev = resolve_device(device)
    return EllSlice(torch.from_numpy(nbr).to(dev), torch.from_numpy(wgt).to(dev),
                    torch.from_numpy(rid).to(dev))


def pack_stats(pack: EllPack) -> dict:
    """Padding efficiency per bucket."""
    stats = {}
    for i, s in enumerate(pack.slices):
        real = int((s.nbr != pack.n_nodes).sum())
        total = int(s.nbr.numel())
        stats[f"bucket{i}_w{s.width}"] = {
            "rows": int(s.rows),
            "slots": total,
            "real": real,
            "fill": real / max(total, 1),
        }
    return stats
