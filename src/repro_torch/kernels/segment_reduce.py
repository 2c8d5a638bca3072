"""Deterministic segment reduction over sorted segment ids.

Port of `repro.kernels.segment_reduce.segment_reduce` (the Pallas
`_seg_kernel`); it also serves the engine's Combine stage
(`core.acc.Combiner.segment`), which the JAX engine does with an XLA scatter.
vals (E,) or (E, D) with ascending seg_ids (E,) -> (num, ) or (num, D) under
sum, min or max. Ids outside [0, num) drop; an empty segment holds `fill`,
by default the TPU kernel's identity (0 or +-f32max/4).

The CUDA kernel is `csrc/segment_reduce.cu`: no float atomics, each segment
reduced in a fixed order that depends only on its length, so a sum is
identical from run to run (PyTorch's `index_add_` on the card is not).
`segment_reduce_ordered` folds in exactly that order, so the kernel is
bit-equal to it for sum, min and max. Against the plain version it is
bit-equal for min and max; for sum the association differs (a warp or block
tree instead of a left fold), within rtol 1e-5 for float32 inputs of one
sign.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import _counting
from repro_torch.kernels import _build
from repro_torch.kernels.ell_spmv import _PAIR, COMBINE_OPS, halving_tree, identity

#: segment lengths of the kernel's tiers: a thread folds up to THREAD_SEG
#: rows, a warp up to LONG_SEG, a block longer segments (csrc header)
THREAD_SEG = 8
LONG_SEG = 2048
WARP = 32
BLOCK = 256


def segment_reduce_plain(vals: torch.Tensor, seg_ids: torch.Tensor, num: int,
                         combine: str = "sum", fill: Optional[float] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version (ids need not be sorted here)."""
    fill = identity(combine) if fill is None else fill
    e = vals.shape[0]
    d = vals.shape[1] if vals.dim() == 2 else 1
    v2 = vals.reshape(e, d)
    ok = (seg_ids >= 0) & (seg_ids < num)
    tgt = torch.where(ok, seg_ids, num).long()       # row `num` is dropped
    if combine == "sum":
        out = torch.zeros((num + 1, d), dtype=vals.dtype, device=vals.device)
        out.index_add_(0, tgt, v2)
    else:
        out = torch.full((num + 1, d), fill, dtype=vals.dtype, device=vals.device)
        out.scatter_reduce_(0, tgt[:, None].expand(e, d), v2,
                            reduce="amin" if combine == "min" else "amax",
                            include_self=False)
    hits = torch.bincount(tgt, minlength=num + 1)
    out = torch.where(hits[:, None] == 0, fill, out)[:num]
    return out.reshape((num,) + tuple(vals.shape[1:]))


def _lane_fold(v2: torch.Tensor, start: torch.Tensor, length: torch.Tensor,
               lanes: int, combine: str) -> torch.Tensor:
    """(S, lanes, D): lane l of each segment folds its rows l, l + lanes, ...
    left to right, starting from the identity (as a kernel lane does)."""
    ident = identity(combine)
    pair = _PAIR[combine]
    s, d = start.shape[0], v2.shape[1]
    acc = torch.full((s, lanes, d), ident, dtype=v2.dtype, device=v2.device)
    if s == 0:
        return acc
    lane = torch.arange(lanes, device=v2.device)
    end = (start + length)[:, None]
    for k in range((int(length.max()) + lanes - 1) // lanes):
        rows = start[:, None] + lane + k * lanes                  # (S, lanes)
        inside = rows < end
        x = v2[torch.where(inside, rows, 0)]
        # a row past the end leaves the lane as it was (no pair with it)
        acc = torch.where(inside[..., None], pair(acc, x), acc)
    return acc


def segment_reduce_ordered(vals: torch.Tensor, seg_ids: torch.Tensor, num: int,
                           combine: str = "sum", fill: Optional[float] = None
                           ) -> torch.Tensor:
    """Plain model of the CUDA kernel's fold order (ids sorted ascending).
    Each column of a segment of length L is reduced by its tier:
    L <= THREAD_SEG, one thread: a left fold; L <= LONG_SEG, one warp: lane
    l folds rows l, l + 32, ..., then a halving tree over the 32 lanes (the
    shuffle tree 16 .. 1); longer, one block: thread t folds rows t + 256k,
    then a halving tree within each warp and one over the 8 warps. The order
    does not depend on D, so column q of an (E, D) call is bit-equal to the
    (E,) call on column q."""
    fill = identity(combine) if fill is None else fill
    e = vals.shape[0]
    d = vals.shape[1] if vals.dim() == 2 else 1
    v2 = vals.reshape(e, d)
    out = torch.full((num, d), fill, dtype=vals.dtype, device=vals.device)
    lo = int(torch.searchsorted(seg_ids, 0))
    hi = int(torch.searchsorted(seg_ids, num))
    ids = seg_ids[lo:hi]
    if hi > lo:
        segs, counts = torch.unique_consecutive(ids, return_counts=True)
        starts = lo + torch.cumsum(counts, 0) - counts
        tiers = ((counts <= THREAD_SEG, 1, ()),
                 ((counts > THREAD_SEG) & (counts <= LONG_SEG), WARP, (WARP,)),
                 (counts > LONG_SEG, BLOCK, (BLOCK // WARP, WARP)))
        for pick, lanes, trees in tiers:
            acc = _lane_fold(v2, starts[pick], counts[pick], lanes, combine)
            if trees:
                acc = acc.reshape((acc.shape[0],) + trees + (d,))
                for axis in range(len(trees), 0, -1):      # innermost tree first
                    acc = halving_tree(acc, axis, combine)
            out[segs[pick].long()] = acc.reshape(-1, d)
    return out.reshape((num,) + tuple(vals.shape[1:]))


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def segment_reduce_cuda(vals: torch.Tensor, seg_ids: torch.Tensor, num: int,
                        combine: str = "sum", fill: Optional[float] = None
                        ) -> torch.Tensor:
    """Launch `csrc/segment_reduce.cu`; `seg_ids` must be sorted ascending."""
    dev = vals.device
    if combine not in COMBINE_OPS:
        raise ValueError(f"unsupported combine {combine!r}")
    fill = identity(combine) if fill is None else fill
    e = vals.shape[0]
    if vals.dim() not in (1, 2):
        raise ValueError(f"vals must be (E,) or (E, D), got {tuple(vals.shape)}")
    p_vals = _build.require(vals, "vals", torch.float32, vals.dim(), dev)
    p_ids = _build.require(seg_ids, "seg_ids", torch.int32, 1, dev)
    if seg_ids.shape[0] != e:
        raise ValueError(f"seg_ids {seg_ids.shape[0]} != vals rows {e}")
    d = vals.shape[1] if vals.dim() == 2 else 1
    out = torch.empty((num,) + tuple(vals.shape[1:]), dtype=torch.float32,
                      device=dev)
    # at most one segment longer than LONG_SEG in every LONG_SEG + 1 rows
    long_list = torch.empty((e // (LONG_SEG + 1) + 1,), dtype=torch.int32,
                            device=dev)
    state = torch.empty((3,), dtype=torch.int32, device=dev)   # lo, hi, count
    fn = _build.entry("segment_reduce", "segment_reduce_launch", _ARGTYPES)
    with _build.device_guard(dev):
        err = fn(p_vals, p_ids, e, d, num, COMBINE_OPS[combine], fill,
                 out.data_ptr(), long_list.data_ptr(), state.data_ptr(),
                 _build.stream_of(dev))
    _build.check(err, "segment_reduce")
    _build.LAUNCHES["segment_reduce"] += 1
    return out


def segment_reduce_meta(vals: torch.Tensor, seg_ids: torch.Tensor, num: int,
                        combine: str = "sum", fill: Optional[float] = None
                        ) -> torch.Tensor:
    """The meta route: `segment_reduce_cuda`'s checks and allocations (the
    output, the long-segment list and the state words) on meta tensors, and
    the kernel's work counted as its bound counts it: E * D operations, the
    ids, the values and the output moved once."""
    if combine not in COMBINE_OPS:
        raise ValueError(f"unsupported combine {combine!r}")
    if vals.dim() not in (1, 2):
        raise ValueError(f"vals must be (E,) or (E, D), got {tuple(vals.shape)}")
    _build.require_meta(vals, "vals", torch.float32, vals.dim())
    _build.require_meta(seg_ids, "seg_ids", torch.int32, 1)
    e = vals.shape[0]
    if seg_ids.shape[0] != e:
        raise ValueError(f"seg_ids {seg_ids.shape[0]} != vals rows {e}")
    d = vals.shape[1] if vals.dim() == 2 else 1
    dev = vals.device
    out = torch.empty((num,) + tuple(vals.shape[1:]), dtype=torch.float32, device=dev)
    long_list = torch.empty((e // (LONG_SEG + 1) + 1,), dtype=torch.int32, device=dev)
    state = torch.empty((3,), dtype=torch.int32, device=dev)
    del long_list, state              # allocated after the output, as the wrapper's
    _counting.kernel("segment_reduce", e * d, e * 4 + e * d * 4 + num * d * 4)
    return out
