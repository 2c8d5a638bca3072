"""Frozen yardstick for the kernels' roofline shares: the data-sheet peaks
of one NVIDIA H100 SXM and the bytes and operations each kernel call needs.

The peaks and the bound (`bound_s`: the larger of bytes over the HBM rate
and operations over the float32 rate) are copied from `chip_smoke.py`
(`HBM_BYTES_PER_S`, `F32_OPS_PER_S`, `bound_ms`); the benchmark never reads
the port's own tables (`kernels/tuning.py`, `launch/cost.py`).

Counting rule: each input byte read once and each output byte written once,
whatever the kernel reads again; where the work depends on the data, only
what these inputs need: the live slots of an ELL slice, not its padding,
each distinct neighbour's value once, and one output a row that has a live
slot.
"""

from __future__ import annotations

import dataclasses

import torch

#: NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

#: Compute ops whose value depends on the edge weight (the others read none)
WEIGHTED_OPS = ("add_w", "mul_w")


@dataclasses.dataclass(frozen=True)
class SliceWork:
    """What one ELL slice holds: live slots (neighbour id below the sentinel
    `n`), rows with a live slot, and distinct neighbours."""

    slots: int
    rows: int
    distinct: int


def slice_work(nbr: torch.Tensor, n: int) -> SliceWork:
    live = nbr != n
    return SliceWork(slots=int(live.sum()), rows=int(live.any(1).sum()),
                     distinct=int(torch.unique(nbr[live]).numel()))


def ell_combine_cost(work: SliceWork, compute: str, lanes: int) -> tuple[int, int]:
    """(bytes, operations) of one `ell_combine` (lanes = 1) or
    `ell_combine_batched` (lanes = Q) call over a slice: int32 neighbour ids
    and, for a weighted op, float32 weights of the live slots; the float32
    value of each distinct neighbour in every lane; one float32 partial a
    live row and lane. Operations: one Compute and one Combine a live slot
    and lane."""
    nbytes = 4 * work.slots
    if compute in WEIGHTED_OPS:
        nbytes += 4 * work.slots
    nbytes += 4 * lanes * (work.distinct + work.rows)
    return nbytes, 2 * lanes * work.slots


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the chip could take: bytes or operations, whichever
    bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
