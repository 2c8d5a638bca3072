"""ELL gather -> Compute -> Combine: the ACC pull hot path.

Port of `repro.kernels.ell_spmv.ell_combine` (the Pallas `_ell_kernel`).
For one ELL slice (nbr, wgt of shape (R, W)) and metadata vals (n+1,):

    partial[r] = COMBINE_j COMPUTE(vals[nbr[r, j]], wgt[r, j])

with each sentinel slot (nbr == n) contributing the combine identity.

The CUDA kernel is `csrc/ell_combine.cu`; its header says what bounds it on
the H100 and how its design answers that. Where the Pallas kernel took any
traced Compute function, the CUDA template is stamped per named op — the
four the catalog uses (`COMPUTE_OPS`); an `ACCProgram` declares its op in
`kernel_compute`. The row reduction is the power-of-two halving tree of
`halving_tree`, in the kernel and in the plain version alike, so the two are
bit-equal for sums as well as for min and max.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

#: the ACC identity magnitude, float32(f32max / 4)
BIG = float(np.finfo(np.float32).max / np.float32(4))

#: Compute ops the kernel template is stamped for (csrc enum order)
COMPUTE_OPS = {"hop": 0, "add_w": 1, "copy": 2, "mul_w": 3}
#: Combine ops (csrc enum order)
COMBINE_OPS = {"min": 0, "max": 1, "sum": 2}
MAX_WIDTH = 256

_IDENT = {"min": BIG, "max": -BIG, "sum": 0.0}
_PAIR = {"min": torch.minimum, "max": torch.maximum, "sum": torch.add}


def identity(combine: str) -> float:
    return _IDENT[combine]


def compute_op(op: str, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of a named Compute op on gathered values `v`."""
    if op == "hop":
        return torch.where(v < BIG, v + 1.0, BIG)
    if op == "add_w":
        return torch.where(v < BIG, v + w, BIG)
    if op == "copy":
        return v
    if op == "mul_w":
        return v * w
    raise ValueError(f"unknown compute op {op!r}")


def halving_tree(vals: torch.Tensor, axis: int, combine: str) -> torch.Tensor:
    """Reduce `axis` with an explicit balanced halving tree: pad to a power
    of two with the identity, then pair halves. The association order is the
    same for every layout of the other axes (and in the CUDA kernel)."""
    axis = axis % vals.dim()
    length = vals.shape[axis]
    ident = _IDENT[combine]
    if length == 0:
        shape = vals.shape[:axis] + vals.shape[axis + 1:]
        return torch.full(shape, ident, dtype=vals.dtype, device=vals.device)
    p = 1 << max(length - 1, 0).bit_length()
    if p != length:
        pad_shape = list(vals.shape)
        pad_shape[axis] = p - length
        pad = torch.full(pad_shape, ident, dtype=vals.dtype, device=vals.device)
        vals = torch.cat([vals, pad], dim=axis)
    pair = _PAIR[combine]
    while p > 1:
        half = p // 2
        vals = pair(vals.narrow(axis, 0, half), vals.narrow(axis, half, half))
        p = half
    return vals.squeeze(axis)


def ell_combine_plain(nbr: torch.Tensor, wgt: torch.Tensor, vals: torch.Tensor,
                      compute: str, combine: str) -> torch.Tensor:
    """Plain PyTorch version: gather, Compute, identity on sentinel slots,
    halving-tree row reduce."""
    n = vals.shape[0] - 1
    v = vals[torch.clamp(nbr, max=n)]
    upd = compute_op(compute, v, wgt)
    upd = torch.where(nbr == n, _IDENT[combine], upd)
    return halving_tree(upd, 1, combine)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)


def ell_combine_cuda(nbr: torch.Tensor, wgt: torch.Tensor, vals: torch.Tensor,
                     compute: str, combine: str) -> torch.Tensor:
    """Launch `csrc/ell_combine.cu` on PyTorch's current stream."""
    dev = vals.device
    if compute not in COMPUTE_OPS or combine not in COMBINE_OPS:
        raise ValueError(f"unsupported ops {compute!r}/{combine!r}")
    p_nbr = _build.require(nbr, "nbr", torch.int32, 2, dev)
    p_wgt = _build.require(wgt, "wgt", torch.float32, 2, dev)
    p_vals = _build.require(vals, "vals", torch.float32, 1, dev)
    r, w = nbr.shape
    if wgt.shape != nbr.shape:
        raise ValueError(f"wgt {tuple(wgt.shape)} != nbr {tuple(nbr.shape)}")
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"slice width {w} outside [1, {MAX_WIDTH}]")
    out = torch.empty((r,), dtype=torch.float32, device=dev)
    fn = _build.entry("ell_combine", "ell_combine_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(p_nbr, p_wgt, p_vals, out.data_ptr(), r, w, vals.shape[0] - 1,
                 COMPUTE_OPS[compute], COMBINE_OPS[combine], _build.stream_of(dev))
    _build.check(err, "ell_combine")
    _build.LAUNCHES["ell_combine"] += 1
    return out
