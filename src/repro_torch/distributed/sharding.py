"""Logical-axis sharding rules on the single-controller mesh.

Port of `repro.distributed.sharding`. Models name each tensor dimension by a
*logical* axis ('batch', 'heads', 'ff', 'vocab', 'experts', 'kv_seq',
'fsdp', ...); `spec(mesh, ...)` maps those names onto the mesh's axes, and
names bound to mesh axes that the mesh lacks shard nothing. The port's mesh
(`repro_torch.mesh.ServingMesh`) has the axes ('data', 'model'), as the
reference's single-pod mesh has: 'pod' always collapses. `spec` reads the
axis names from `mesh.shape`, so a stand-in with a 'pod' axis (the
dry-run's production mesh, `launch.mesh`) maps as the reference's
multi-pod mesh does.

Placement on a single controller is explicit: no compiler propagates
layouts, so the reference's active mesh (`activate`, `current_mesh`) and
its `constrain` have no counterpart, and `spec` takes the mesh as an
argument. The counterpart of the reference's `named`/`tree_named`
followed by `jax.device_put` is `shard`/`tree_shard`: a tensor (or a tree,
by its tree of logical tuples) is cut into the block each grid position
holds, on that position's device, and `unshard` puts the blocks back
together.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

#: logical axis -> preferred mesh axes (in order; several axes shard over
#: their product)
RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),      # pure DP across pods
    "fsdp": ("data",),             # ZeRO-3 parameter/optimizer sharding
    "heads": ("model",),           # TP over attention heads
    "kv_heads": ("model",),
    "ff": ("model",),              # TP over FFN hidden
    "vocab": ("model",),           # TP over embedding/logits vocab
    "experts": ("model",),         # EP over MoE experts
    # split-KV decode; takes 'data' too when the batch doesn't occupy it
    "kv_seq": ("data", "model"),
    "edges": ("pod", "data", "model"),   # GNN edge partition: whole mesh
    "table_rows": ("model",),      # recsys embedding-table row sharding
    "candidates": ("model",),      # retrieval candidate sharding
    "nodes": ("data",),            # GNN node-feature sharding
    # batched graph serving: the trailing Q axis of the (n+1, Q) state
    "queries": ("data",),
}

def spec(mesh, *logical: Optional[str]) -> tuple:
    """The partition entries (None, a mesh axis, or a tuple of mesh axes) of
    a tensor whose dims carry these logical names (None = replicated dim),
    on `mesh` (None: no mesh, every dim replicated). Unknown names shard
    nothing; a mesh axis serves at most one dim."""
    axes = set(mesh.shape) if mesh is not None else set()
    entries: list = []
    used: set = set()
    for name in logical:
        if name is None:
            entries.append(None)
            continue
        cand = tuple(a for a in RULES.get(name, ()) if a in axes and a not in used)
        used.update(cand)
        entries.append(None if not cand else cand[0] if len(cand) == 1 else cand)
    return tuple(entries)


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def parts(mesh, entry) -> int:
    """How many blocks a dim with this partition entry is cut into."""
    return math.prod(mesh.shape[a] for a in _axes(entry))


def block_index(mesh, entry, d: int, s: int) -> int:
    """The block of a dim with this entry that grid position (d, s) holds:
    its coordinates on the entry's axes, read row-major."""
    coord = {"data": d, "model": s}
    idx = 0
    for a in _axes(entry):
        idx = idx * mesh.shape[a] + coord[a]
    return idx


def _block(x: torch.Tensor, mesh, entries: Sequence, d: int, s: int) -> torch.Tensor:
    for dim, entry in enumerate(entries):
        n = parts(mesh, entry)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
        size = x.shape[dim] // n
        x = x.narrow(dim, block_index(mesh, entry, d, s) * size, size)
    return x.to(mesh.device(d, s))


def shard(mesh, x: torch.Tensor, *logical: Optional[str]) -> List[List[torch.Tensor]]:
    """`x` cut by its logical axes on `mesh`: grid[d][s] is the block that
    position (d, s) holds, on its device (a view of `x` where the device is
    x's own)."""
    entries = spec(mesh, *logical)
    d_n, s_n = mesh.shape["data"], mesh.shape["model"]
    return [[_block(x, mesh, entries, d, s) for s in range(s_n)] for d in range(d_n)]


def unshard(mesh, grid: Sequence[Sequence[torch.Tensor]], *logical: Optional[str],
            device=None) -> torch.Tensor:
    """The inverse of `shard`, on `device` (default: position (0, 0)'s):
    each block taken once, from the first position that holds it."""
    entries = spec(mesh, *logical)
    dev = mesh.device(0, 0) if device is None else torch.device(device)
    split = [(dim, parts(mesh, e), e) for dim, e in enumerate(entries) if parts(mesh, e) > 1]
    blocks: dict = {}
    for d, row in enumerate(grid):
        for s, t in enumerate(row):
            key = tuple(block_index(mesh, e, d, s) for _, _, e in split)
            blocks.setdefault(key, t)

    def join(level: int, prefix: tuple) -> torch.Tensor:
        if level == len(split):
            return blocks[prefix].to(dev)
        dim, n, _ = split[level]
        return torch.cat([join(level + 1, prefix + (i,)) for i in range(n)], dim=dim)

    return join(0, ())


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and all(a is None or isinstance(a, str) for a in v)


def tree_shard(mesh, tree, logical_tree):
    """`shard` of each leaf of a tree of tensors by its logical tuple in
    `logical_tree` (dicts and lists nest alike): the reference's
    `tree_named` + `jax.device_put`."""
    if _is_axes(logical_tree):
        return shard(mesh, tree, *logical_tree)
    if isinstance(logical_tree, dict):
        return {k: tree_shard(mesh, tree[k], v) for k, v in logical_tree.items()}
    return [tree_shard(mesh, t, v) for t, v in zip(tree, logical_tree)]
