"""A single-controller device mesh and its collectives.

The reference runs sharded serving under `shard_map`: one process drives
every device of a ('data', 'model') mesh, and `psum`/`pmin`/`pmax` sit
between the shards' bodies. The port keeps that model. A `ServingMesh` is a
(D, S) grid of `torch.device`s; a shard's body is plain PyTorch on that
shard's tensors; a collective is a function over the list of per-shard
tensors:

  * `all_reduce(parts, op)` folds the shards in index order on shard 0's
    device (`sum` is therefore deterministic; `min`/`max` and the union's
    `or` are exact whatever the order) and hands the result back to every
    shard's device. `Tensor.to` returns the tensor itself when the device
    already matches, so a mesh whose shards share one card copies nothing.

A device may appear in the grid more than once: ["cpu"] * 4 is a 4-shard
mesh on the CPU (the reference forces host devices with
`--xla_force_host_platform_device_count` for the same purpose), and
["cuda:0"] * 4 runs a 4-shard placement on one card, the shards one after
another.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch import _counting

DATA_AXIS = "data"     # query shards
MODEL_AXIS = "model"   # edge shards


class ServingMesh:
    """A (D, S) grid of devices: D query shards ('data') by S edge shards
    ('model')."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = tuple(tuple(torch.device(d) for d in row) for row in devices)
        widths = {len(row) for row in self.devices}
        if not self.devices or len(widths) != 1 or 0 in widths:
            raise ValueError("a mesh is a non-empty rectangle of devices")
        #: axis name -> extent, as the reference's `mesh.shape`
        self.shape = {DATA_AXIS: len(self.devices), MODEL_AXIS: widths.pop()}

    def device(self, d: int, s: int = 0) -> torch.device:
        return self.devices[d][s]

    def column(self, s: int) -> tuple:
        return tuple(row[s] for row in self.devices)

    def distinct(self) -> List[torch.device]:
        """Each device of the grid once, in grid order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))

    def __repr__(self) -> str:
        d, s = self.shape[DATA_AXIS], self.shape[MODEL_AXIS]
        return f"ServingMesh({d}x{s}, {[str(x) for x in self.distinct()]})"


def make_mesh(n_query_shards: int = 1, n_edge_shards: int = 1,
              devices: Optional[Sequence] = None) -> ServingMesh:
    """A (D, S) mesh over `devices` (default: the visible CUDA devices, in
    order), filled row by row. Raises when there are fewer devices than
    D * S; list a device several times to put several shards on it."""
    need = n_query_shards * n_edge_shards
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if len(devs) < need:
        raise RuntimeError(
            f"mesh ({n_query_shards}, {n_edge_shards}) needs {need} devices, "
            f"have {len(devs)}; pass devices= (a device may repeat) to put "
            "several shards on one device")
    return ServingMesh([devs[d * n_edge_shards:(d + 1) * n_edge_shards]
                        for d in range(n_query_shards)])


_FOLD = {
    "sum": torch.add,
    "min": torch.minimum,
    "max": torch.maximum,
    "or": torch.logical_or,
}


def reduce_to(parts: Sequence[torch.Tensor], op: str,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """Fold the per-shard tensors in shard order on `device` (default:
    shard 0's). Counted as one all-reduce of one shard's operand when
    there are several shards (`launch.cost`)."""
    fold = _FOLD[op]
    if len(parts) > 1:      # the reference's psum/pmin/pmax, for the dry-run's count
        _counting.collective("all-reduce", parts[0].numel() * parts[0].element_size())
    dev = parts[0].device if device is None else device
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = fold(acc, p.to(dev))
    return acc


def all_reduce(parts: Sequence[torch.Tensor], op: str) -> List[torch.Tensor]:
    """`reduce_to` on shard 0's device, handed back to each shard's device
    (the shard's own tensor object where the devices match)."""
    acc = reduce_to(parts, op)
    return [acc.to(p.device) for p in parts]
