"""BFS answers against the reference's hop counts: the number of vertices
whose distance differs, exact."""

from __future__ import annotations

import torch

from graphbench import reference
from graphbench.compare import mismatches

LIMITS = {"bfs_mismatch": 0}


def check(ref, outputs, params) -> dict:
    return {"bfs_mismatch": sum(mismatches(got, reference.bfs(ref.adj, s))
                                for s, got in outputs)}


def control(ref, sources, params, kind):
    """The control's answers in the program's place: hop counts held in the
    dtype named `kind`."""
    return [reference.bfs(ref.adj, s).to(getattr(torch, kind)) for s in sources]
