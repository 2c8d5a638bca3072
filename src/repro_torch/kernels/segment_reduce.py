"""Deterministic segment reduction over sorted segment ids.

Port of `repro.kernels.segment_reduce.segment_reduce` (the Pallas
`_seg_kernel`); it also serves the engine's Combine stage
(`core.acc.Combiner.segment`), which the JAX engine does with an XLA scatter.
vals (E,) or (E, D) with ascending seg_ids (E,) -> (num, ) or (num, D) under
sum, min or max. Ids outside [0, num) drop; an empty segment holds `fill`,
by default the TPU kernel's identity (0 or +-f32max/4).

The CUDA kernel is `csrc/segment_reduce.cu`: no float atomics, each segment
reduced in a fixed order, so a sum is identical from run to run (PyTorch's
`index_add_` on the card is not). Against the plain version it is bit-equal
for min and max; for sum the association differs (a warp or block tree
instead of a left fold), within rtol 1e-5 for float32 inputs of one sign.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_spmv import COMBINE_OPS, identity

LONG_SEG = 2048


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
    long_list = torch.empty(((e // LONG_SEG + 1) * d,), dtype=torch.int32,
                            device=dev)
    long_count = torch.empty((1,), dtype=torch.int32, device=dev)
    fn = _build.entry("segment_reduce", "segment_reduce_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(p_vals, p_ids, e, d, num, COMBINE_OPS[combine], fill,
                 out.data_ptr(), long_list.data_ptr(), long_count.data_ptr(),
                 _build.stream_of(dev))
    _build.check(err, "segment_reduce")
    _build.LAUNCHES["segment_reduce"] += 1
    return out
