"""Personalized PageRank answers against the reference's float64 power
iteration with the same stopping rule: the widest gap |port - reference|
over every vertex of every checked query. The limit lies between the
port's own readings and the bfloat16 control's (PERF.md)."""

from __future__ import annotations

import torch

from graphbench import reference
from graphbench.compare import max_gap

LIMITS = {"ppr_gap": 1e-4}
#: columns of one reference product (memory: a few (n, COLS) float64 planes)
COLS = 16


def ranks(ref, sources, params, dtype=torch.float64) -> torch.Tensor:
    a, deg = ref.csr
    cols = [reference.ppr(a, deg, sources[i:i + COLS], params["damping"], params["tol"],
                          params["max_iters"], dtype=dtype)
            for i in range(0, len(sources), COLS)]
    return torch.cat(cols, dim=1)


def check(ref, outputs, params) -> dict:
    want = ranks(ref, [s for s, _ in outputs], params)
    return {"ppr_gap": max(max_gap(got, want[:, j]) for j, (_, got) in enumerate(outputs))}


def control(ref, sources, params, kind):
    """The control's answers in the program's place: ranks held in the dtype
    named `kind`."""
    got = ranks(ref, sources, params, dtype=getattr(torch, kind))
    return [got[:, j] for j in range(len(sources))]
