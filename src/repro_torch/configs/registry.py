"""Architecture registry: the assigned archs and their shape grids (40 cells).

Port of `repro.configs.registry`, copied so that the port imports nothing of
the reference. Every assigned architecture is a selectable config; each
carries its own input-shape set, so every (arch x shape) cell is defined,
plus a `make_reduced()` config for CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

#: LM shape grid (seq_len, global_batch, kind)
LM_SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    # long-context decode: 1 new token against a 512k cache; the reference
    # skips it for the five pure full-attention archs
    "long_500k": dict(seq=524288, batch=1, kind="decode", skip_full_attn=True),
}

GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433, kind="full"),
    "minibatch_lg": dict(
        n_nodes=232965, n_edges=114615892, batch_nodes=1024,
        fanout=(15, 10), d_feat=602, kind="sampled",
    ),
    "ogb_products": dict(n_nodes=2449029, n_edges=61859140, d_feat=100, kind="full"),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, kind="batched"),
}

RECSYS_SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="infer"),
    "serve_bulk": dict(batch=262144, kind="infer"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                     # 'lm' | 'gnn' | 'dimenet' | 'recsys'
    make_config: Callable[[], Any]  # full assigned config
    make_reduced: Callable[[], Any]  # CPU test config
    shapes: dict
    notes: str = ""


_REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec):
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> ArchSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)


def cells() -> list[tuple[str, str]]:
    """All (arch, shape) cells, 40 with the ten archs registered."""
    return [(n, s) for n in names() for s in _REGISTRY[n].shapes]
