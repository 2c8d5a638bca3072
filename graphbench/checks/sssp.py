"""SSSP answers against the reference's distances: the number of vertices
whose distance differs, exact (integer weights, so float32 sums are exact
far past any distance here)."""

from __future__ import annotations

import torch

from graphbench import reference
from graphbench.compare import mismatches

LIMITS = {"sssp_mismatch": 0}


def check(ref, outputs, params) -> dict:
    return {"sssp_mismatch": sum(mismatches(got, reference.sssp(ref.adj, s))
                                 for s, got in outputs)}


def control(ref, sources, params, kind):
    """The control's answers in the program's place: distances and their
    sums held in the dtype named `kind`."""
    return [reference.sssp(ref.adj, s, dtype=getattr(torch, kind)) for s in sources]
