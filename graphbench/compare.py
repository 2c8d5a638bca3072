"""The comparisons that decide `correct`, shared by the check modules."""

from __future__ import annotations

import torch

from graphbench import reference


def mismatches(got, want: torch.Tensor) -> int:
    """Vertices where a distance `got` (the port's float32 plane, f32max/4
    where unreached) differs from the reference's `want` (inf where
    unreached); unreached on one side only counts."""
    got = torch.as_tensor(got).to(want.device, torch.float64)
    lost = got >= reference.UNREACHED
    far = torch.isinf(want)
    return int(((lost != far) | (~far & (got != want))).sum())


def max_gap(got, want: torch.Tensor) -> float:
    """The largest |got - want| over all entries."""
    got = torch.as_tensor(got).to(want.device, torch.float64)
    return float((got - want).abs().max())
