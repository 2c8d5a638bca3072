"""EmbeddingBag (multi-hot gather + reduce) for recsys.

Port of `repro.kernels.embedding_bag.embedding_bag` (the Pallas
`_bag_kernel`): a float32 table (V, D) and bags idx (B, K) int32 give
(B, D), the sum, mean or max of each bag's K rows. The modes follow
`repro.kernels.ref.embedding_bag_ref` (torch.nn.EmbeddingBag): the Pallas
kernel ignores mode "max" and returns the sum, and this port does not copy
that. Indices are read as `ref.py`'s `table[idx]` reads them in JAX: an
index in [-V, -1] wraps to idx + V, then every index is clamped to
[0, V - 1], as a JAX gather clamps (`wrap_indices`).

The CUDA kernel is `csrc/embedding_bag.cu`: a bag's rows are spread over a
warp's lanes, lanes over the row in 4-, 8- or 16-byte pieces, and every row
a lane holds is gathered before the first add. `bag_layout` gives the split
it picks and `embedding_bag_ordered` folds in its order: on the card the
kernel is bit-equal to it for sum and mean, and bit-equal to the plain
version for max (NaN propagates, as in `amax`). The ordered model is within
rtol 1e-5 of the plain version (another order of the same float32 adds).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

MODES = {"sum": 0, "mean": 1, "max": 2}
MAX_FEATURES = 256
WARP = 32


def wrap_indices(idx: torch.Tensor, v: int) -> torch.Tensor:
    """Rows that `table[idx]` reads in JAX: [-V, -1] wraps to idx + V (once),
    then everything is clamped to [0, V - 1]."""
    return torch.where(idx < 0, idx + v, idx).clamp(0, v - 1)


def embedding_bag_plain(table: torch.Tensor, idx: torch.Tensor,
                        mode: str = "sum") -> torch.Tensor:
    """Plain PyTorch version: gather (B, K, D), then reduce over K (the mean
    is the sum over K divided by K, as the Pallas kernel finishes it)."""
    if mode not in MODES:
        raise ValueError(f"unsupported mode {mode!r}")
    g = table[wrap_indices(idx, table.shape[0]).long()]
    if mode == "max":
        return g.amax(dim=1)
    s = g.sum(dim=1)
    return s / idx.shape[1] if mode == "mean" else s


def bag_layout(d: int, k: int, table_ptr: int) -> tuple[int, int, int]:
    """(floats a load, lanes a row, row groups a bag) as the kernel splits a
    bag: 16-byte loads where D % 4 == 0 and the table is 16-byte aligned,
    8-byte ones where D is even and it is 8-byte aligned, else 4-byte ones;
    a row's loads over min(loads a row, 32) lanes; as many rows at once as
    fit in a warp, at most K (D = 10: 5 lanes a row, 6 rows)."""
    vec = 4 if d % 4 == 0 and table_ptr % 16 == 0 else (
        2 if d % 2 == 0 and table_ptr % 8 == 0 else 1)
    lanes = min(d // vec, WARP)
    return vec, lanes, min(WARP // lanes, k)


def embedding_bag_ordered(table: torch.Tensor, idx: torch.Tensor, mode: str = "sum",
                          groups: Optional[int] = None) -> torch.Tensor:
    """Plain model of the CUDA kernel's fold order. With G row groups a bag
    (`groups`, by default `bag_layout`'s), group g folds rows g, g + G,
    g + 2G, ... left to right from the identity (0, or -inf for max); then a
    halving tree over the G groups, padded with the identity to a power of
    two, pairs group i with group i + half. The mean divides that sum by K."""
    if mode not in MODES:
        raise ValueError(f"unsupported mode {mode!r}")
    v, d = table.shape
    b, k = idx.shape
    if groups is None:
        groups = bag_layout(d, k, table.data_ptr())[2]
    rows = -(-k // groups)
    ident = float("-inf") if mode == "max" else 0.0
    pair = torch.maximum if mode == "max" else torch.add     # maximum propagates NaN
    g = table[wrap_indices(idx, v).long()]                          # (B, K, D)
    pad = torch.full((b, rows * groups - k, d), ident, dtype=table.dtype, device=table.device)
    g = torch.cat([g, pad], dim=1).view(b, rows, groups, d)
    acc = torch.full((b, groups, d), ident, dtype=table.dtype, device=table.device)
    for j in range(rows):       # a padded row folds the identity in: no change
        acc = pair(acc, g[:, j])
    width = 1 << (groups - 1).bit_length()
    acc = torch.cat([acc, acc.new_full((b, width - groups, d), ident)], dim=1)
    while width > 1:
        width //= 2
        acc = pair(acc[:, :width], acc[:, width:])
    out = acc[:, 0]
    if mode != "mean":
        return out
    # a divisor on the device: CUDA divides by a host scalar as a product
    # with its reciprocal, and the kernel divides, rounded once
    return out / torch.tensor(float(k), dtype=out.dtype, device=out.device)


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
    if b == 0:
        return out
    fn = _build.entry("embedding_bag", "embedding_bag_launch", _ARGTYPES)
    with _build.device_guard(dev):
        err = fn(p_tab, p_idx, out.data_ptr(), b, k, d, v, MODES[mode],
                 _build.stream_of(dev))
    _build.check(err, "embedding_bag")
    _build.LAUNCHES["embedding_bag"] += 1
    return out
