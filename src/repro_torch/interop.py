"""Carry state from the JAX reference into the port.

The caller hands over the reference's arrays as numpy (`np.asarray` on the
JAX side), so this package still imports nothing of `repro`. Used by the
tests to run both packages on one graph, one packing and one initial state.

    g = graph_from_numpy(csr_arrays(jax_graph.out), csr_arrays(jax_graph.inc),
                         device="cuda")
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.graph.csr import CSR, Graph
from repro_torch.graph.packing import EllPack, EllSlice

CSR_FIELDS = ("row_ptr", "col_idx", "weights", "src_idx")
SLICE_FIELDS = ("nbr", "wgt", "row_id")
_DTYPES = {"row_ptr": np.int32, "col_idx": np.int32, "weights": np.float32,
           "src_idx": np.int32, "nbr": np.int32, "wgt": np.float32,
           "row_id": np.int32}


def _t(name: str, arr, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=_DTYPES[name])).to(dev)


def csr_arrays(obj) -> dict:
    """The CSR fields of any object that has them, as numpy arrays."""
    return {k: np.asarray(getattr(obj, k)) for k in CSR_FIELDS}


def csr_from_numpy(arrays: Mapping, device="cuda") -> CSR:
    dev = resolve_device(device)
    return CSR(*(_t(k, arrays[k], dev) for k in CSR_FIELDS))


def graph_from_numpy(out: Mapping, inc: Optional[Mapping] = None,
                     device="cuda") -> Graph:
    """A `Graph` from numpy CSR fields; `inc=None` shares the out-CSR
    (undirected graphs, as in the reference)."""
    o = csr_from_numpy(out, device)
    return Graph(out=o, inc=o if inc is None else csr_from_numpy(inc, device))


def pack_from_numpy(slices: Sequence[Mapping], n_nodes: int,
                    device="cuda") -> EllPack:
    """An `EllPack` from per-slice numpy fields (`nbr`, `wgt`, `row_id`)."""
    dev = resolve_device(device)
    return EllPack(
        slices=tuple(EllSlice(*(_t(k, s[k], dev) for k in SLICE_FIELDS))
                     for s in slices),
        n_nodes=int(n_nodes))


def meta_from_numpy(meta: Mapping, device="cuda") -> dict:
    """A metadata dict of numpy arrays as tensors (dtypes kept)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in meta.items()}
