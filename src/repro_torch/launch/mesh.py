"""The dry-run's production meshes, and the local mesh.

Counterpart of `repro.launch.mesh`. The meshes keep the reference's shapes,
so that the two packages' records compare cell for cell: (16, 16) on
('data', 'model'), 256 devices, and (2, 16, 16) on ('pod', 'data',
'model'), 512.

On the H100 the 256-GPU mesh reads as one NVLink Switch domain (every GPU
reaches every other at NVLink's 450 GB/s each way, as a GB200 NVL-class or
an NVLink-Switch H100 system joins them), and 'pod' as two such domains
joined by InfiniBand. The dry-run's collective term uses NVLink's rate
alone, as the reference uses one ICI rate: a collective over 'pod' would
run at InfiniBand's lower rate, which the term does not see.

`make_production_mesh` is a shape-only stand-in: `shape` is the axis
extents (what `distributed.sharding.spec` reads) and `grid()` gives the
('data', 'model') grid of `meta` devices on which a step that runs the
port's mesh paths (the pipeline, edge-sharded and split-KV variants) runs
one pod's program. No card is needed, and none is touched.
`make_local_mesh` is `repro_torch.mesh.make_mesh`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch import mesh as M


class ProductionMesh:
    """A production mesh's shape, for the dry-run: no devices behind it."""

    def __init__(self, shape: dict):
        #: axis name -> extent, in the reference's axis order
        self.shape = dict(shape)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def grid(self) -> M.ServingMesh:
        """One pod's ('data', 'model') grid, every position on `meta`."""
        dev = torch.device("meta")
        return M.ServingMesh([[dev] * self.shape[M.MODEL_AXIS]
                              for _ in range(self.shape[M.DATA_AXIS])])

    def __repr__(self) -> str:
        return f"ProductionMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    if multi_pod:
        return ProductionMesh({"pod": 2, M.DATA_AXIS: 16, M.MODEL_AXIS: 16})
    return ProductionMesh({M.DATA_AXIS: 16, M.MODEL_AXIS: 16})


def make_local_mesh(data: int = 1, model: int = 1,
                    devices: Optional[Sequence] = None) -> M.ServingMesh:
    """A (data, model) mesh over `devices` (default: the visible CUDA
    devices): `repro_torch.mesh.make_mesh`."""
    return M.make_mesh(data, model, devices)
