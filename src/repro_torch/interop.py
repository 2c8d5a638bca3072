"""Carry state from the JAX reference into the port.

The caller hands over the reference's arrays as numpy (`np.asarray` on the
JAX side), so this package still imports nothing of `repro`. Used by the
tests to run both packages on one graph, one packing and one initial state.

    g = graph_from_numpy(csr_arrays(jax_graph.out), csr_arrays(jax_graph.inc),
                         device="cuda")
    p = attn_params_from_numpy({k: np.asarray(v[0]) for k, v in layers.items()})
    st = batch_state_from_numpy({"m": {k: np.asarray(v) for k, v in ref.m.items()},
                                 "it": np.asarray(ref.it), ...}, device="cuda")
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), device="cuda")
    opt = opt_state_from_numpy(jax.tree.map(np.asarray, jax_opt_state), device="cuda")
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
    """An `EllPack` from per-slice numpy fields (`nbr`, `wgt`, `row_id`);
    a slice is marked `rows_ascending` where its host `row_id` is."""
    dev = resolve_device(device)
    return EllPack(
        slices=tuple(EllSlice(*(_t(k, s[k], dev) for k in SLICE_FIELDS),
                              rows_ascending=bool(np.all(np.diff(s["row_id"]) >= 0)))
                     for s in slices),
        n_nodes=int(n_nodes))


def meta_from_numpy(meta: Mapping, device="cuda") -> dict:
    """A metadata dict of numpy arrays as tensors (dtypes kept)."""
    return {k: tensor_from_numpy(v, device) for k, v in meta.items()}


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """A numpy array as a tensor of the same dtype, JAX's bfloat16 included:
    `np.asarray` of a bf16 JAX array is an `ml_dtypes.bfloat16` array, which
    `torch.from_numpy` refuses, so its 16 bits go over as int16."""
    dev = resolve_device(device)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr)).to(dev)


ATTN_FIELDS = ("wq", "wk", "wv", "wo", "attn_norm")


def attn_params_from_numpy(layer: Mapping, device="cuda") -> dict:
    """One layer's attention weights (`wq`, `wk`, `wv`, `wo`, `attn_norm`,
    numpy, dtypes kept) as the dict `nn.layers.gqa_attention` takes."""
    return {k: tensor_from_numpy(layer[k], device) for k in ATTN_FIELDS}


def params_from_numpy(tree, device="cuda"):
    """A model's parameters, nested dicts and lists of numpy arrays (dtypes
    kept), as the same nesting of tensors. The port's models take the
    reference's layouts as they are, so this carries the parameters of the
    transformer (dense and MoE), DeepFM, the GNNs and DimeNet alike."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def opt_state_from_numpy(state: Mapping, device="cuda") -> dict:
    """The reference's AdamW state (`step`, `m`, `v`, numpy, dtypes kept;
    an int8 moment leaf is a dict {'q', 's'}) as `optim.adamw` keeps it:
    `step` an int32 scalar tensor, the moments the same nesting of
    tensors."""
    return {"step": tensor_from_numpy(np.asarray(state["step"], np.int32), device),
            "m": params_from_numpy(state["m"], device),
            "v": params_from_numpy(state["v"], device)}


def cache_from_numpy(cache: Mapping, device="cuda") -> dict:
    """A transformer kv cache (`k`, `v` numpy, dtypes kept; `len` a
    scalar) as `models.transformer.decode_step` takes it, `len` an int."""
    return {"k": tensor_from_numpy(cache["k"], device),
            "v": tensor_from_numpy(cache["v"], device), "len": int(cache["len"])}


def batch_state_from_numpy(arrays: Mapping, device="cuda"):
    """A `serving.batch_engine.BatchState` from a mapping of its field names
    to numpy arrays (`m` a dict of them, `pseg` a tuple; dtypes kept, `None`
    planes kept as `None`): a reference state carried into the port, e.g.
    to resume `run_state` from it."""
    from repro_torch.serving.batch_engine import BatchState

    kw = {}
    for k in BatchState._fields:
        v = arrays.get(k)
        if k == "m":
            kw[k] = meta_from_numpy(v, device)
        elif k == "pseg":
            kw[k] = tuple(tensor_from_numpy(a, device) for a in (v or ()))
        else:
            kw[k] = None if v is None else tensor_from_numpy(v, device)
    return BatchState(**kw)
