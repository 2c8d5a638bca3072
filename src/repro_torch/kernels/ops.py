"""Device dispatcher over the hand-written kernels.

Port of `repro.kernels.ops` for the three kernels on the solo engine's path.
The pick is by the device of the tensor given: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the CUDA kernel — or the call
raises (nvcc missing, a refused launch). There is no fallback from one to the
other.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ell_spmv as _ell
from repro_torch.kernels import frontier_pack as _fp
from repro_torch.kernels import segment_reduce as _sr


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel route for device {t.device}")


def ell_combine(nbr, wgt, vals, compute: str, combine: str = "min"):
    """partial (R,) for one ELL slice; `compute` is a `COMPUTE_OPS` name."""
    if _route(vals) == "cuda":
        return _ell.ell_combine_cuda(nbr, wgt, vals, compute, combine)
    return _ell.ell_combine_plain(nbr, wgt, vals, compute, combine)


def frontier_pack(mask, cap: int):
    """(ids (cap,), count, overflow) of a dense (n,) bool mask, sentinel n."""
    if _route(mask) == "cuda":
        return _fp.frontier_pack_cuda(mask, cap)
    return _fp.frontier_pack_plain(mask, cap)


def segment_reduce(vals, seg_ids, num_segments: int, combine: str = "sum",
                   fill: Optional[float] = None):
    """(num,) or (num, D) reduction over ascending `seg_ids`; empty segments
    hold `fill` (default: the combine identity)."""
    if _route(vals) == "cuda":
        return _sr.segment_reduce_cuda(vals, seg_ids, num_segments, combine, fill)
    return _sr.segment_reduce_plain(vals, seg_ids, num_segments, combine, fill)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last `reset_launches()`."""
    return dict(_build.LAUNCHES)


def reset_launches() -> None:
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
