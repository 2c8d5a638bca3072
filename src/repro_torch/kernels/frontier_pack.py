"""Ballot-filter stream compaction (paper Fig. 6b).

Port of `repro.kernels.frontier_pack.frontier_pack` (the Pallas
`_pack_kernel`) with its `concat_blocks` epilogue: a dense (n,) bool mask
becomes the sorted, unique frontier `(ids (cap,), count, overflow)` padded
with the sentinel n — the triple of `core.frontier.compact_mask`.

The CUDA kernel is `csrc/frontier_pack.cu` (warp `__ballot_sync` +
`__popc` ranks, a block scan, then a scan over the block counts); its header
says what bounds it on the H100. The plain version keeps the TPU kernel's
two-level structure: a per-block compaction, then the epilogue.
"""

from __future__ import annotations

import ctypes

import torch

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


_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def frontier_pack_cuda(mask: torch.Tensor, cap: int):
    """Launch `csrc/frontier_pack.cu`; count and overflow stay on the card."""
    dev = mask.device
    p_mask = _build.require(mask, "mask", torch.bool, 1, dev)
    n = mask.shape[0]
    nb = -(-n // BLOCK)
    block_ids = torch.empty((max(nb, 1) * BLOCK,), dtype=torch.int32, device=dev)
    block_cnt = torch.empty((max(nb, 1),), dtype=torch.int32, device=dev)
    block_off = torch.empty((nb + 1,), dtype=torch.int32, device=dev)
    ids = torch.empty((cap,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    fn = _build.entry("frontier_pack", "frontier_pack_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(p_mask, n, cap, block_ids.data_ptr(), block_cnt.data_ptr(),
                 block_off.data_ptr(), ids.data_ptr(), count.data_ptr(),
                 overflow.data_ptr(), _build.stream_of(dev))
    _build.check(err, "frontier_pack")
    _build.LAUNCHES["frontier_pack"] += 1
    return ids, count, overflow
