"""EmbeddingBag (multi-hot gather + reduce) for recsys.

Port of `repro.kernels.embedding_bag.embedding_bag` (the Pallas
`_bag_kernel`): a float32 table (V, D) and bags idx (B, K) int32 give
(B, D), the sum, mean or max of each bag's K rows. The modes follow
`repro.kernels.ref.embedding_bag_ref` (torch.nn.EmbeddingBag): the Pallas
kernel ignores mode "max" and returns the sum, and this port does not copy
that. Indices are clamped to [0, V), as a JAX gather clamps them.

The CUDA kernel is `csrc/embedding_bag.cu`: a group of lanes per bag, lanes
over D, the bag's rows folded in order; against the plain version it is
bit-equal for max and within rtol 1e-5 for sum and mean (another order of
the same float32 adds).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MODES = {"sum": 0, "mean": 1, "max": 2}
MAX_FEATURES = 256


def embedding_bag_plain(table: torch.Tensor, idx: torch.Tensor,
                        mode: str = "sum") -> torch.Tensor:
    """Plain PyTorch version: gather (B, K, D), then reduce over K (the mean
    is the sum over K divided by K, as the Pallas kernel finishes it)."""
    if mode not in MODES:
        raise ValueError(f"unsupported mode {mode!r}")
    g = table[torch.clamp(idx, 0, table.shape[0] - 1).long()]
    if mode == "max":
        return g.amax(dim=1)
    s = g.sum(dim=1)
    return s / idx.shape[1] if mode == "mean" else s


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def embedding_bag_cuda(table: torch.Tensor, idx: torch.Tensor,
                       mode: str = "sum") -> torch.Tensor:
    """Launch `csrc/embedding_bag.cu` on PyTorch's current stream."""
    dev = table.device
    if mode not in MODES:
        raise ValueError(f"unsupported mode {mode!r}")
    p_tab = _build.require(table, "table", torch.float32, 2, dev)
    p_idx = _build.require(idx, "idx", torch.int32, 2, dev)
    v, d = table.shape
    b, k = idx.shape
    if not 1 <= d <= MAX_FEATURES:
        raise ValueError(f"embedding width {d} outside [1, {MAX_FEATURES}]")
    if k < 1 or v < 1:
        raise ValueError(f"empty bags or table: K={k}, V={v}")
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    fn = _build.entry("embedding_bag", "embedding_bag_launch", _ARGTYPES)
    with _build.device_guard(dev):
        err = fn(p_tab, p_idx, out.data_ptr(), b, k, d, v, MODES[mode],
                 _build.stream_of(dev))
    _build.check(err, "embedding_bag")
    _build.LAUNCHES["embedding_bag"] += 1
    return out
