"""Ballot-filter stream compaction (paper Fig. 6b).

Port of `repro.kernels.frontier_pack.frontier_pack` (the Pallas
`_pack_kernel`) with its `concat_blocks` epilogue: a dense (n,) bool mask
becomes the sorted, unique frontier `(ids (cap,), count, overflow)` padded
with the sentinel n — the triple of `core.frontier.compact_mask`.

The CUDA kernel is `csrc/frontier_pack.cu`: one pass over tiles of 4,096
lanes (warp `__ballot_sync` + `__popc` ranks, a scan with decoupled
look-back across tiles), then a small launch for the sentinel tail; its
header says what bounds it on the H100. The plain version keeps the TPU
kernel's two-level structure: a per-block compaction, then the epilogue.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _counting
from repro_torch.kernels import _build

BLOCK = 1024


def pack_blocks_plain(mask: torch.Tensor, block: int, sentinel: int):
    """Per-block compaction of a mask whose length is a multiple of `block`:
    ids[b, i] = global id of the i-th set lane of block b (sentinel after
    the set lanes), counts[b] = popcount of block b."""
    nb = mask.shape[0] // block
    m = mask.reshape(nb, block).to(torch.int32)
    pos = torch.cumsum(m, 1, dtype=torch.int32) - 1
    gids = torch.arange(nb * block, dtype=torch.int32, device=mask.device)
    tgt = torch.where(m > 0, pos, block).long()
    out = torch.full((nb, block + 1), sentinel, dtype=torch.int32,
                     device=mask.device)
    out.scatter_(1, tgt, gids.reshape(nb, block))
    return out[:, :block], m.sum(1, dtype=torch.int32)


def concat_blocks(ids: torch.Tensor, counts: torch.Tensor, cap: int,
                  sentinel: int):
    """Epilogue: exclusive scan over block counts, then one scatter into a
    (cap,) frontier; stays sorted and unique because blocks are in order."""
    nb, block = ids.shape
    offs = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    lane = torch.arange(block, dtype=torch.int32, device=ids.device)
    dst = offs[:, None] + lane[None, :]
    ok = (lane[None, :] < counts[:, None]) & (dst < cap)
    tgt = torch.where(ok, dst, cap).long()
    buf = torch.full((cap + 1,), sentinel, dtype=torch.int32, device=ids.device)
    buf.scatter_(0, tgt.reshape(-1), ids.reshape(-1))
    total = counts.sum(dtype=torch.int32)
    return buf[:cap], torch.clamp(total, max=cap), total > cap


def frontier_pack_plain(mask: torch.Tensor, cap: int, block: int = BLOCK):
    """Plain PyTorch version: (ids (cap,), count, overflow) of a (n,) mask,
    sentinel n; a ragged last block is padded with unset lanes."""
    n = mask.shape[0]
    nb = -(-n // block)
    padded = torch.zeros((nb * block,), dtype=torch.bool, device=mask.device)
    padded[:n] = mask
    ids, counts = pack_blocks_plain(padded, block, sentinel=n)
    return concat_blocks(ids, counts, cap, sentinel=n)


#: lanes per tile of the CUDA kernel (one status word each)
TILE = 4096

_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def frontier_pack_cuda(mask: torch.Tensor, cap: int):
    """Launch `csrc/frontier_pack.cu`; count and overflow stay on the card.
    The only scratch is one int64 status word per tile, the ticket and the
    total."""
    dev = mask.device
    p_mask = _build.require(mask, "mask", torch.bool, 1, dev)
    n = mask.shape[0]
    tiles = max(-(-n // TILE), 1)
    aux = torch.empty((tiles + 2,), dtype=torch.int64, device=dev)
    ids = torch.empty((cap,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    fn = _build.entry("frontier_pack", "frontier_pack_launch", _ARGTYPES)
    with _build.device_guard(dev):
        err = fn(p_mask, n, cap, aux.data_ptr(), ids.data_ptr(), count.data_ptr(),
                 overflow.data_ptr(), _build.stream_of(dev))
    _build.check(err, "frontier_pack")
    _build.LAUNCHES["frontier_pack"] += 1
    return ids, count, overflow


def frontier_pack_meta(mask: torch.Tensor, cap: int):
    """The meta route: `frontier_pack_cuda`'s checks and allocations (the
    status words, ids, count and overflow) on meta tensors, the kernel's
    work counted as its bound counts it (2n operations; the mask read, the
    ids and the two scalars written)."""
    _build.require_meta(mask, "mask", torch.bool, 1)
    dev = mask.device
    n = mask.shape[0]
    # the status words live to the end of the call, as the wrapper's do
    aux = torch.empty((max(-(-n // TILE), 1) + 2,), dtype=torch.int64, device=dev)
    ids = torch.empty((cap,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    del aux
    _counting.kernel("frontier_pack", 2 * n, n + cap * 4 + 5)
    return ids, count, overflow
