"""ELL gather -> Compute -> Combine (the ACC pull hot path), and ELL SpMM.

Port of `repro.kernels.ell_spmv`: `ell_combine` (the Pallas `_ell_kernel`,
and `_ell_kernel_overlay` when a deletion mask is given) and `ell_spmm`
(`_spmm_kernel`). For one ELL slice (nbr, wgt of shape (R, W)) and
metadata vals (n+1,):

    partial[r] = COMBINE_j COMPUTE(vals[nbr[r, j]], wgt[r, j])

with each sentinel slot (nbr == n) contributing the combine identity, and
with the overlay each slot whose `dead` mask is set as well. For features
F (n+1, D):

    out[r, :] = SUM_j w'[r, j] * F[nbr[r, j], :],   w' = 0 on sentinel slots

The CUDA kernel is `csrc/ell_combine.cu`; its header says what bounds it on
the H100 and how its design answers that. It has a 16-byte vector variant,
taken where `vector_layout` allows it, and a scalar one for other widths
and unaligned views; `ell_combine_lanes_model` folds a row in the vector
variant's lane order. Where the Pallas kernel took any
traced Compute function, the CUDA template is stamped per named op — the
four the catalog uses (`COMPUTE_OPS`); an `ACCProgram` declares its op in
`kernel_compute`. The row reduction is the power-of-two halving tree of
`halving_tree`, in the kernel and in the plain version alike, so the two are
bit-equal for sums as well as for min and max.

`ell_combine_batched` is the batched engine's dense pull, where the
reference builds an (R, W, Q) gather in XLA: for vertex-major vals
(n+1, Q) each column gets `ell_combine`'s halving tree over W, bit-equal to
the 1-D kernel at Q = 1. Its kernel is `csrc/ell_combine_batched.cu`, with
two routes that `batched_layout` picks by Q: slot lanes for narrow Q (about
four slots a lane, whole Q-vectors a lane; `ell_combine_slot_lanes_model`)
and column lanes for wide Q (16-byte column groups, ids staged in shared
memory; `ell_combine_column_lanes_model`). Its plain version works in row
chunks.

`ell_spmm`'s kernel is `csrc/ell_spmm.cu`: one warp a row walks the live
slots only, with f32 accumulation in a fixed order, output in F's dtype
(float32 or bfloat16); `spmm_layout` picks its loads (16-byte ids and
weights where W and the alignment allow it; 16-, 8-, 4- or 2-byte feature
loads by D, dtype and alignment). Its plain version works in row chunks, so
that the gathered (rows, W, D) block stays small at full graph size.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import _counting
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


def vector_layout(width: int, nbr_ptr: int, wgt_ptr: int,
                  dead_ptr: Optional[int] = None) -> bool:
    """Whether `ell_combine`'s 16-byte variant takes a slice: W % 4 == 0, nbr
    and wgt 16-byte aligned, the overlay mask (if any) 4-byte aligned. Every
    slice `pack_ell` makes qualifies; other widths and unaligned views take
    the scalar variant."""
    return (width % 4 == 0 and nbr_ptr % 16 == 0 and wgt_ptr % 16 == 0
            and (dead_ptr is None or dead_ptr % 4 == 0))


def vector_lanes(width: int) -> tuple[int, int]:
    """(G, V) of the vector variant for a slice of `width` slots: G lanes a
    row, V 16-byte vectors a lane, 4 * G * V = the padded width p >= 4."""
    p = max(1 << max(width - 1, 0).bit_length(), 4)
    lanes = min(p // 4, 32)
    return lanes, p // (4 * lanes)


def ell_combine_lanes_model(upd: torch.Tensor, combine: str) -> torch.Tensor:
    """Row reduce of per-slot values (R, W) in the vector variant's order:
    pad to p with the identity; lane l holds slots v * 4G + 4l + i (vector
    v < V, i < 4); pair the two vectors of a lane (V = 2, the level
    k + p/2), then lanes l and l + off for off = G/2 .. 1 (the shuffles),
    then in-lane (k, k + 2) and (k, k + 1). The same tree as `halving_tree`,
    written in the kernel's layout."""
    r, w = upd.shape
    lanes, vecs = vector_lanes(w)
    p = 4 * lanes * vecs
    ident = _IDENT[combine]
    pair = _PAIR[combine]
    if p != w:
        pad = torch.full((r, p - w), ident, dtype=upd.dtype, device=upd.device)
        upd = torch.cat([upd, pad], dim=1)
    a = upd.reshape(r, vecs, lanes, 4)
    if vecs == 2:
        a = pair(a[:, :1], a[:, 1:])
    a = a[:, 0]                                                  # (R, G, 4)
    off = lanes // 2
    while off >= 1:                      # lane 0 ends with lanes 0 .. off-1
        a = pair(a[:, :off], a[:, off:2 * off])
        off //= 2
    a = a[:, 0]                                                  # (R, 4)
    return pair(pair(a[:, 0], a[:, 2]), pair(a[:, 1], a[:, 3]))


def ell_combine_plain(nbr: torch.Tensor, wgt: torch.Tensor, vals: torch.Tensor,
                      compute: str, combine: str,
                      dead: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: gather, Compute, identity on sentinel (and
    dead) slots, halving-tree row reduce."""
    n = vals.shape[0] - 1
    v = vals[torch.clamp(nbr, max=n)]
    upd = compute_op(compute, v, wgt)
    drop = nbr == n
    if dead is not None:
        drop = drop | (dead != 0)
    upd = torch.where(drop, _IDENT[combine], upd)
    return halving_tree(upd, 1, combine)


def neutralize(nbr: torch.Tensor, dead: torch.Tensor, n: int) -> torch.Tensor:
    """A copy of `nbr` whose dead slots hold the sentinel `n`: without a mask,
    the kernels on it give what the overlay gives on `nbr` (the contract of
    `repro.kernels.ops.ell_combine`'s fold)."""
    return torch.where(dead != 0, n, nbr)


def _dead_int8(dead: torch.Tensor) -> torch.Tensor:
    """The overlay mask as the kernel's int8 (a bool mask is viewed, not
    copied)."""
    if dead.dtype not in (torch.bool, torch.int8, torch.uint8):
        raise TypeError(f"dead has dtype {dead.dtype}, expected bool or int8")
    return dead.view(torch.int8)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def ell_combine_cuda(nbr: torch.Tensor, wgt: torch.Tensor, vals: torch.Tensor,
                     compute: str, combine: str,
                     dead: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch `csrc/ell_combine.cu` on PyTorch's current stream; with `dead`
    (bool or int8, (R, W)) the overlay variant, counted apart."""
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
    p_dead = None
    if dead is not None:
        if dead.shape != nbr.shape:
            raise ValueError(f"dead {tuple(dead.shape)} != nbr {tuple(nbr.shape)}")
        dead = _dead_int8(dead)
        p_dead = _build.require(dead, "dead", torch.int8, 2, dev)
    out = torch.empty((r,), dtype=torch.float32, device=dev)
    vec = vector_layout(w, p_nbr, p_wgt, p_dead)
    fn = _build.entry("ell_combine", "ell_combine_launch", _ARGTYPES)
    with _build.device_guard(dev):
        err = fn(p_nbr, p_wgt, p_dead, p_vals, out.data_ptr(), r, w,
                 vals.shape[0] - 1, COMPUTE_OPS[compute], COMBINE_OPS[combine],
                 int(vec), _build.stream_of(dev))
    _build.check(err, "ell_combine")
    _build.LAUNCHES["ell_combine" if dead is None else "ell_combine_overlay"] += 1
    return out


# ---------------------------------------------------------------------------
# ELL SpMM: out[r] = sum_j w'[r, j] * F[nbr[r, j]]
# ---------------------------------------------------------------------------

#: feature widths the SpMM kernel takes (lanes over D, at most 8 per lane)
MAX_FEATURES = 256
SPMM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: gathered elements per chunk of the plain version (2^24 floats = 64 MiB)
_PLAIN_CHUNK = 1 << 24


def ell_spmm_plain(nbr: torch.Tensor, wgt: torch.Tensor, feats: torch.Tensor
                   ) -> torch.Tensor:
    """Plain PyTorch version: weights zeroed on sentinel slots, the weighted
    row sum as a batched (1, W) x (W, D) product in float32, cast to F's
    dtype; in row chunks of at most 2^24 gathered elements."""
    n = feats.shape[0] - 1
    r, w = nbr.shape
    d = feats.shape[1]
    out = torch.empty((r, d), dtype=feats.dtype, device=feats.device)
    step = max(1, _PLAIN_CHUNK // max(w * d, 1))
    for lo in range(0, r, step):
        nb = nbr[lo:lo + step]
        ww = torch.where(nb == n, 0.0, wgt[lo:lo + step].float())
        f = feats[torch.clamp(nb, max=n).long()].float()          # (c, W, D)
        out[lo:lo + step] = torch.bmm(ww[:, None, :], f)[:, 0, :].to(feats.dtype)
    return out


def spmm_layout(width: int, d: int, dtype: torch.dtype, nbr_ptr: int, wgt_ptr: int,
                feats_ptr: int, out_ptr: int) -> tuple[bool, int]:
    """(vec_ids, fvec) of `ell_spmm`'s kernel for a slice of `width` slots
    and D = `d` features of `dtype`: ids and weights in 16-byte loads where
    `vector_layout` takes the slice (every `pack_ell` slice), else 4-byte
    ones; fvec feature columns a load, the widest of 16, 8, 4 and 2 bytes
    (bfloat16 down to one element) that divides the row and to which feats
    and out are aligned: 4 at D = 64 in float32, 2 at D = 70."""
    vec_ids = vector_layout(width, nbr_ptr, wgt_ptr)
    size = 4 if dtype == torch.float32 else 2
    for nbytes in (16, 8, 4, 2):
        v = max(nbytes // size, 1)
        if d % v == 0 and feats_ptr % (v * size) == 0 and out_ptr % (v * size) == 0:
            return vec_ids, v
    raise ValueError(f"feats at {feats_ptr:#x} is not aligned to its {dtype}")


_SPMM_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p)


def ell_spmm_cuda(nbr: torch.Tensor, wgt: torch.Tensor, feats: torch.Tensor
                  ) -> torch.Tensor:
    """Launch `csrc/ell_spmm.cu`: nbr int32 (R, W), wgt float32 (R, W),
    feats float32 or bfloat16 (n+1, D) with a finite row n -> (R, D) in
    feats' dtype."""
    dev = feats.device
    if feats.dtype not in SPMM_DTYPES:
        raise TypeError(f"feats has dtype {feats.dtype}, expected float32 or bfloat16")
    p_nbr = _build.require(nbr, "nbr", torch.int32, 2, dev)
    p_wgt = _build.require(wgt, "wgt", torch.float32, 2, dev)
    p_f = _build.require(feats, "feats", feats.dtype, 2, dev)
    r, w = nbr.shape
    npad, d = feats.shape
    if wgt.shape != nbr.shape:
        raise ValueError(f"wgt {tuple(wgt.shape)} != nbr {tuple(nbr.shape)}")
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"slice width {w} outside [1, {MAX_WIDTH}]")
    if not 1 <= d <= MAX_FEATURES:
        raise ValueError(f"feature width {d} outside [1, {MAX_FEATURES}]")
    out = torch.empty((r, d), dtype=feats.dtype, device=dev)
    vec_ids, fvec = spmm_layout(w, d, feats.dtype, p_nbr, p_wgt, p_f, out.data_ptr())
    fn = _build.entry("ell_spmm", "ell_spmm_launch", _SPMM_ARGTYPES)
    with _build.device_guard(dev):
        err = fn(p_nbr, p_wgt, p_f, out.data_ptr(), r, w, d, npad - 1,
                 SPMM_DTYPES[feats.dtype], int(vec_ids), fvec, _build.stream_of(dev))
    _build.check(err, "ell_spmm")
    _build.LAUNCHES["ell_spmm"] += 1
    return out


# ---------------------------------------------------------------------------
# Q-wide ELL combine: out[r, q] = TREE_j Compute(vals[nbr[r, j], q], wgt[r, j])
# ---------------------------------------------------------------------------


def ell_combine_batched_plain(nbr: torch.Tensor, wgt: torch.Tensor, vals: torch.Tensor,
                              compute: str, combine: str) -> torch.Tensor:
    """Plain PyTorch version of the batched engine's dense pull over one
    slice, for vertex-major vals (n+1, Q): gather, Compute, identity on
    sentinel slots, halving-tree reduce over W; in row chunks of at most
    2^24 gathered elements, so (rows, W, Q) stays small at full size."""
    n = vals.shape[0] - 1
    r, w = nbr.shape
    q = vals.shape[1]
    out = torch.empty((r, q), dtype=vals.dtype, device=vals.device)
    step = max(1, _PLAIN_CHUNK // max(w * q, 1))
    ident = _IDENT[combine]
    for lo in range(0, r, step):
        nb = nbr[lo:lo + step]
        v = vals[torch.clamp(nb, max=n).long()]                   # (c, W, Q)
        upd = compute_op(compute, v, wgt[lo:lo + step, :, None])
        upd = torch.where((nb == n)[..., None], ident, upd)
        out[lo:lo + step] = halving_tree(upd, 1, combine)
    return out


#: the widest Q the slot-lanes route takes; wider Q takes column lanes
SLOT_LANES_MAX_Q = 8
#: `ell_combine_batched`'s routes (csrc enum order)
BATCHED_ROUTES = {"slots": 0, "columns": 1}


class BatchedLayout(NamedTuple):
    """How `ell_combine_batched`'s kernel spreads a row over a warp: G
    `column_lanes` x S `slot_groups` lanes (a power of two <= 32); group s
    holds the slots s, s + S, ...; `vector`: 16-byte column loads."""
    route: str
    vector: bool
    column_lanes: int
    slot_groups: int


def slot_lanes(width: int) -> int:
    """Lanes a row of the slot-lanes route for a slice of `width` slots
    (padded width p): about four slots a lane, p / 4, at least min(p, 2) and
    at most 32 (p / L <= 8 at p = 256)."""
    p = 1 << max(width - 1, 0).bit_length()
    return min(32, max(p // 4, min(p, 2)))


def route_layout(route: str, q: int, width: int, vector: bool) -> BatchedLayout:
    """The layout of one route of `ell_combine_batched`'s kernel for Q
    columns and a slice of `width` slots (padded width p). Slot lanes:
    `slot_lanes(width)` lanes a row, each lane gathering whole Q-vectors.
    Column lanes: G = the power of two that covers the column groups (4
    columns a lane with `vector`, else 1), at most 32, and S = p / 64 slot
    groups, at least 1 and at most 32 / G (Q = 64: 16 x 2 on a 256-wide
    slice, one row a warp; 16 x 1 on narrower ones)."""
    if route == "slots":
        return BatchedLayout("slots", vector, 1, slot_lanes(width))
    p = 1 << max(width - 1, 0).bit_length()
    groups = -(-q // (4 if vector else 1))
    lanes = min(32, 1 << max(groups - 1, 0).bit_length())
    return BatchedLayout("columns", vector, lanes, min(32 // lanes, max(1, p // 64)))


def batched_layout(q: int, width: int, vals_ptr: int, out_ptr: int) -> BatchedLayout:
    """The layout `ell_combine_batched_cuda` launches: slot lanes for
    Q <= SLOT_LANES_MAX_Q, column lanes beyond (`route_layout`), with
    16-byte column loads where Q % 4 == 0 and vals and out are 16-byte
    aligned."""
    vec = q % 4 == 0 and vals_ptr % 16 == 0 and out_ptr % 16 == 0
    return route_layout("slots" if q <= SLOT_LANES_MAX_Q else "columns", q, width, vec)


def _pad_slots(upd: torch.Tensor, p: int, combine: str) -> torch.Tensor:
    r, w = upd.shape[:2]
    if p == w:
        return upd
    pad = torch.full((r, p - w, *upd.shape[2:]), _IDENT[combine], dtype=upd.dtype,
                     device=upd.device)
    return torch.cat([upd, pad], dim=1)


def _pair_groups(a: torch.Tensor, combine: str) -> torch.Tensor:
    """The shuffles: lane groups k and k + off on axis 1, off = half .. 1,
    the lower on the left; returns group 0."""
    pair = _PAIR[combine]
    off = a.shape[1] // 2
    while off >= 1:
        a = pair(a[:, :off], a[:, off:2 * off])
        off //= 2
    return a[:, 0]


def ell_combine_slot_lanes_model(upd: torch.Tensor, combine: str, lanes: int) -> torch.Tensor:
    """Row reduce of per-slot values (R, W, ...) in the slot-lanes route's
    order for L = `lanes` lanes a row (a power of two, p / 8 <= L <=
    min(p, 32); `slot_lanes(W)` on the card): pad to p with the identity;
    lane l holds the slots l + L i (i < p / L); it folds them in chunks of
    min(p / L, 4) (chunk h: i = h + 2 j at p / L = 8), halving over each
    chunk, then pairs its chunks, then lanes l and l + off for off = L/2 ..
    1 (the shuffles). The same tree as `halving_tree`, written in the
    kernel's layout."""
    w = upd.shape[1]
    p = 1 << max(w - 1, 0).bit_length()
    if not (max(p // 8, 1) <= lanes <= min(p, 32) and lanes & (lanes - 1) == 0):
        raise ValueError(f"{lanes} slot lanes for a padded width of {p}")
    ns = p // lanes
    cs = min(ns, 4)
    pair = _PAIR[combine]
    a = _pad_slots(upd, p, combine).reshape(upd.shape[0], ns, lanes, *upd.shape[2:])
    acc = None
    for h in range(ns // cs):
        x = a[:, h::ns // cs]                                   # the chunk's slots
        s = cs // 2
        while s >= 1:
            x = pair(x[:, :s], x[:, s:2 * s])
            s //= 2
        acc = x[:, 0] if acc is None else pair(acc, x[:, 0])
    return _pair_groups(acc, combine)


def ell_combine_column_lanes_model(upd: torch.Tensor, combine: str,
                                   slot_groups: int) -> torch.Tensor:
    """Row reduce of per-slot values (R, W, ...) in the column-lanes route's
    order for S = `slot_groups` (a power of two <= p): group s walks its
    slots s + S i in bit-reversed order of i, 8 (or p / S) a chunk, folds
    each chunk as a halving tree, and merges chunks like a binary counter;
    then groups s and s + off for off = S/2 .. 1 (the shuffles). The same
    tree as `halving_tree`, written in the kernel's layout."""
    w = upd.shape[1]
    p = 1 << max(w - 1, 0).bit_length()
    if not (1 <= slot_groups <= p and slot_groups & (slot_groups - 1) == 0):
        raise ValueError(f"{slot_groups} slot groups for a padded width of {p}")
    ps = p // slot_groups
    logps = ps.bit_length() - 1
    ch = min(ps, 8)
    up = (ps // ch).bit_length() - 1
    pair = _PAIR[combine]
    a = _pad_slots(upd, p, combine)
    brev = [int(format(t, f"0{logps}b")[::-1], 2) if logps else 0 for t in range(ps)]
    groups = []
    for s in range(slot_groups):
        st = [None] * up
        for h in range(ps // ch):
            x = [a[:, s + slot_groups * brev[h * ch + i]] for i in range(ch)]
            d = 1
            while d < ch:
                for i in range(0, ch, 2 * d):
                    x[i] = pair(x[i], x[i + d])
                d *= 2
            y = x[0]
            for lvl in range(up):
                if (h >> lvl) & 1:
                    y = pair(st[lvl], y)
                else:
                    st[lvl] = y
                    break
        groups.append(y)
    return _pair_groups(torch.stack(groups, dim=1), combine)


_BATCHED_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def ell_combine_batched_cuda(nbr: torch.Tensor, wgt: torch.Tensor, vals: torch.Tensor,
                             compute: str, combine: str) -> torch.Tensor:
    """Launch `csrc/ell_combine_batched.cu` on the route `batched_layout`
    picks: nbr int32 (R, W), wgt float32 (R, W), vals float32 (n+1, Q) ->
    (R, Q)."""
    return _launch_batched(nbr, wgt, vals, compute, combine, None)


def _launch_batched(nbr: torch.Tensor, wgt: torch.Tensor, vals: torch.Tensor,
                    compute: str, combine: str,
                    layout: Optional[BatchedLayout]) -> torch.Tensor:
    """The launch behind `ell_combine_batched_cuda`; a `layout` other than
    `batched_layout`'s is for the card tests and the design probe, which
    hold both routes to the plain version at the same Q and time them."""
    dev = vals.device
    if compute not in COMPUTE_OPS or combine not in COMBINE_OPS:
        raise ValueError(f"unsupported ops {compute!r}/{combine!r}")
    p_nbr = _build.require(nbr, "nbr", torch.int32, 2, dev)
    p_wgt = _build.require(wgt, "wgt", torch.float32, 2, dev)
    p_vals = _build.require(vals, "vals", torch.float32, 2, dev)
    r, w = nbr.shape
    npad, q = vals.shape
    if wgt.shape != nbr.shape:
        raise ValueError(f"wgt {tuple(wgt.shape)} != nbr {tuple(nbr.shape)}")
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"slice width {w} outside [1, {MAX_WIDTH}]")
    out = torch.empty((r, q), dtype=torch.float32, device=dev)
    lay = layout or batched_layout(q, w, p_vals, out.data_ptr())
    fn = _build.entry("ell_combine_batched", "ell_combine_batched_launch",
                      _BATCHED_ARGTYPES)
    with _build.device_guard(dev):
        err = fn(p_nbr, p_wgt, p_vals, out.data_ptr(), r, w, npad - 1, q,
                 BATCHED_ROUTES[lay.route], lay.column_lanes, lay.slot_groups,
                 COMPUTE_OPS[compute], COMBINE_OPS[combine], int(lay.vector),
                 _build.stream_of(dev))
    _build.check(err, "ell_combine_batched")
    _build.LAUNCHES["ell_combine_batched"] += 1
    return out


# ---------------------------------------------------------------------------
# meta routes: the CUDA wrappers' checks and outputs on meta tensors, each
# kernel's work counted as its bound counts it (every slot taken as real:
# a meta tensor holds no ids to tell the padding apart)
# ---------------------------------------------------------------------------


def _require_slice_meta(nbr: torch.Tensor, wgt: torch.Tensor) -> tuple[int, int]:
    _build.require_meta(nbr, "nbr", torch.int32, 2)
    _build.require_meta(wgt, "wgt", torch.float32, 2)
    r, w = nbr.shape
    if wgt.shape != nbr.shape:
        raise ValueError(f"wgt {tuple(wgt.shape)} != nbr {tuple(nbr.shape)}")
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"slice width {w} outside [1, {MAX_WIDTH}]")
    return r, w


def ell_combine_meta(nbr: torch.Tensor, wgt: torch.Tensor, vals: torch.Tensor,
                     compute: str, combine: str,
                     dead: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Meta route of `ell_combine_cuda`: (R,) float32; 2 operations a
    slot, nbr, wgt (and dead), vals and the output moved once."""
    if compute not in COMPUTE_OPS or combine not in COMBINE_OPS:
        raise ValueError(f"unsupported ops {compute!r}/{combine!r}")
    r, w = _require_slice_meta(nbr, wgt)
    _build.require_meta(vals, "vals", torch.float32, 1)
    if dead is not None:
        if dead.shape != nbr.shape:
            raise ValueError(f"dead {tuple(dead.shape)} != nbr {tuple(nbr.shape)}")
        _build.require_meta(_dead_int8(dead), "dead", torch.int8, 2)
    out = torch.empty((r,), dtype=torch.float32, device=vals.device)
    slots = r * w
    _counting.kernel("ell_combine" if dead is None else "ell_combine_overlay", 2 * slots,
                     slots * (8 if dead is None else 9) + vals.shape[0] * 4 + r * 4)
    return out


def ell_spmm_meta(nbr: torch.Tensor, wgt: torch.Tensor, feats: torch.Tensor
                  ) -> torch.Tensor:
    """Meta route of `ell_spmm_cuda`: (R, D) in feats' dtype; 2 D
    operations a slot, nbr, wgt, feats and the output moved once."""
    if feats.dtype not in SPMM_DTYPES:
        raise TypeError(f"feats has dtype {feats.dtype}, expected float32 or bfloat16")
    r, w = _require_slice_meta(nbr, wgt)
    _build.require_meta(feats, "feats", feats.dtype, 2)
    npad, d = feats.shape
    if not 1 <= d <= MAX_FEATURES:
        raise ValueError(f"feature width {d} outside [1, {MAX_FEATURES}]")
    out = torch.empty((r, d), dtype=feats.dtype, device=feats.device)
    es = feats.element_size()
    _counting.kernel("ell_spmm", 2 * r * w * d, r * w * 8 + npad * d * es + r * d * es)
    return out


def ell_combine_batched_meta(nbr: torch.Tensor, wgt: torch.Tensor, vals: torch.Tensor,
                             compute: str, combine: str) -> torch.Tensor:
    """Meta route of `ell_combine_batched_cuda`: (R, Q) float32; Q
    operations a slot, nbr, wgt, vals and the output moved once."""
    if compute not in COMPUTE_OPS or combine not in COMBINE_OPS:
        raise ValueError(f"unsupported ops {compute!r}/{combine!r}")
    r, w = _require_slice_meta(nbr, wgt)
    _build.require_meta(vals, "vals", torch.float32, 2)
    npad, q = vals.shape
    out = torch.empty((r, q), dtype=torch.float32, device=vals.device)
    _counting.kernel("ell_combine_batched", r * w * q, r * w * 8 + npad * q * 4 + r * q * 4)
    return out
