"""Device dispatcher over the hand-written kernels.

Port of `repro.kernels.ops`, the public kernel API: the three kernels on
the solo engine's path, the deletion overlay, ELL SpMM, EmbeddingBag and
flash attention; beside them the batched engine's Q-wide pull, which the
reference leaves to XLA. The pick is by the device of the tensor given: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the CUDA kernel — or the call
raises (nvcc missing, a refused launch). There is no fallback from one to the
other.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ell_spmv as _ell
from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import frontier_pack as _fp
from repro_torch.kernels import segment_reduce as _sr


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel route for device {t.device}")


def ell_combine(nbr, wgt, vals, compute: str, combine: str = "min", dead=None):
    """partial (R,) for one ELL slice; `compute` is a `COMPUTE_OPS` name.
    `dead` (optional (R, W) bool/int8) is the streaming deletion overlay:
    flagged slots give the combine identity, bit-equal to the call without
    it on `ell_spmv.neutralize(nbr, dead, n)`."""
    if _route(vals) == "cuda":
        return _ell.ell_combine_cuda(nbr, wgt, vals, compute, combine, dead)
    return _ell.ell_combine_plain(nbr, wgt, vals, compute, combine, dead)


def ell_combine_batched(nbr, wgt, vals, compute: str, combine: str = "min"):
    """(R, Q) partials of one ELL slice for vertex-major vals (n+1, Q): the
    batched engine's dense pull, the same halving tree over W per column."""
    if _route(vals) == "cuda":
        return _ell.ell_combine_batched_cuda(nbr, wgt, vals, compute, combine)
    return _ell.ell_combine_batched_plain(nbr, wgt, vals, compute, combine)


def ell_spmm(nbr, wgt, feats):
    """(R, D) weighted neighbour sum over one ELL slice for (n+1, D) feats."""
    if _route(feats) == "cuda":
        return _ell.ell_spmm_cuda(nbr, wgt, feats)
    return _ell.ell_spmm_plain(nbr, wgt, feats)


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


def embedding_bag(table, idx, mode: str = "sum"):
    """(B, D) sum, mean or max over each bag of (B, K) rows of `table`."""
    if _route(table) == "cuda":
        return _bag.embedding_bag_cuda(table, idx, mode)
    return _bag.embedding_bag_plain(table, idx, mode)


def attention(q, k, v, causal: bool = True):
    """Causal GQA attention, (B, Hq, Sq, D) in q's dtype; head h reads kv
    head h % Hkv."""
    if _route(q) == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal)
    return _fa.attention_plain(q, k, v, causal)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last `reset_launches()`."""
    return dict(_build.LAUNCHES)


def reset_launches() -> None:
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
