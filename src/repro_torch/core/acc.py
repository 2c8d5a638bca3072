"""The ACC (Active-Compute-Combine) programming model — paper Sec. 3.

Port of `repro.core.acc`. A program supplies Active, Compute and a Combine
monoid (min/max/sum) plus an init and an optional apply; vertex metadata is
a dict of (n+1,) tensors whose slot `n` is the scratch slot that absorbs
sentinel-padded edges and always holds the combiner identity.

The Combine stage's keyed segment reduction (`Combiner.segment`) runs on the
deterministic `segment_reduce` kernel on the card: ids are sorted stably
first (the push buffer's destinations are unsorted), so a sum is the same
from run to run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ell_spmv import BIG as _BIG
from repro_torch.kernels.ell_spmv import halving_tree, identity

Meta = Dict[str, torch.Tensor]

#: fill of an empty segment in `Combiner.segment` — jax.ops.segment_min/max
#: give +-inf there (the Pallas kernel's contract is +-f32max/4 instead)
_EMPTY = {"min": math.inf, "max": -math.inf, "sum": 0.0}


@dataclasses.dataclass(frozen=True)
class Combiner:
    """⊕: commutative, associative, with identity."""

    name: str                      # 'min' | 'max' | 'sum'
    kind: str                      # 'vote' | 'aggregation'  (paper Sec. 3.2)

    @property
    def idempotent(self) -> bool:
        return self.name in ("min", "max")

    def identity(self, dtype=torch.float32, device=None) -> torch.Tensor:
        if self.name == "min":
            return torch.tensor(_BIG, dtype=dtype, device=device)
        if self.name == "max":
            return torch.tensor(-_BIG, dtype=dtype, device=device)
        if self.name == "sum":
            return torch.tensor(0, dtype=dtype, device=device)
        raise ValueError(self.name)

    def identity_value(self) -> float:
        return identity(self.name)

    def segment(self, vals: torch.Tensor, ids: torch.Tensor, num: int,
                sorted_ids: bool = False) -> torch.Tensor:
        """(num,) keyed combine; ids outside [0, num) drop; an empty segment
        is +-inf for min/max (0 for sum), as in jax.ops.segment_*."""
        if self.name not in _EMPTY:
            raise ValueError(self.name)
        ids = ids.to(torch.int32)
        if not sorted_ids:
            ids, order = torch.sort(ids, stable=True)
            vals = vals[order]
        return kops.segment_reduce(vals.contiguous(), ids.contiguous(), num,
                                   self.name, fill=_EMPTY[self.name])

    def segment_stacked(self, vals: torch.Tensor, ids: torch.Tensor, num: int
                        ) -> torch.Tensor:
        """Independent per-row segment combine: (..., E) -> (..., num), the
        leading axes folded into the segment-id space (one flat combine)."""
        lead = vals.shape[:-1]
        if not lead:
            return self.segment(vals, ids, num)
        q = math.prod(lead)
        offs = (torch.arange(q, dtype=ids.dtype, device=ids.device) * num
                ).reshape(lead + (1,))
        # out-of-range ids must still drop, not alias a neighbouring row
        ok = (ids >= 0) & (ids < num)
        flat_ids = torch.where(ok, ids + offs, q * num)
        flat = self.segment(vals.reshape(-1), flat_ids.reshape(-1), q * num)
        return flat.reshape(lead + (num,))

    def pair(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "min":
            return torch.minimum(a, b)
        if self.name == "max":
            return torch.maximum(a, b)
        if self.name == "sum":
            return a + b
        raise ValueError(self.name)

    def reduce_axis(self, vals: torch.Tensor, axis: int) -> torch.Tensor:
        if self.name == "min":
            return torch.amin(vals, dim=axis)
        if self.name == "max":
            return torch.amax(vals, dim=axis)
        if self.name == "sum":
            return torch.sum(vals, dim=axis)
        raise ValueError(self.name)

    def reduce_axis_tree(self, vals: torch.Tensor, axis: int) -> torch.Tensor:
        """Reduce `axis` with an explicit balanced halving tree (pad to a
        power of two with the identity, then pair halves) — the association
        order of `repro`'s tree and of the `ell_combine` kernel."""
        return halving_tree(vals, axis, self.name)


MIN_VOTE = Combiner("min", "vote")
MIN_AGG = Combiner("min", "aggregation")
SUM_AGG = Combiner("sum", "aggregation")
MAX_VOTE = Combiner("max", "vote")


@dataclasses.dataclass(frozen=True)
class ACCProgram:
    """A graph algorithm expressed in the ACC model (paper Fig. 4a).

    `params` is the reference's declarative metadata, unchanged (DESIGN.md
    §15). `kernel_compute` names the Compute op (`hop`, `add_w`, `copy`,
    `mul_w`) that stamps the CUDA `ell_combine` template for the kernel pull;
    it must compute exactly what `compute` computes from the sender's primary
    field and the edge weight.
    """

    name: str
    combiner: Combiner
    #: init(n, degrees, **kw) -> (M0, frontier0 ids int tensor)
    init: Callable[..., tuple[Meta, torch.Tensor]]
    #: per-edge message; sender/receiver are dicts of gathered metadata
    compute: Callable[[Meta, torch.Tensor, Meta], torch.Tensor]
    #: which vertices are active next iteration
    active: Callable[[Meta, Meta, torch.Tensor], torch.Tensor]
    #: merge combined updates into metadata; default = monoid on primary
    apply: Optional[Callable[[Meta, torch.Tensor, torch.Tensor], Meta]] = None
    primary: str = "val"
    modes: str = "both"
    fixed_iters: Optional[int] = None
    params: tuple = ()
    with_tol: Optional[Callable[[float], "ACCProgram"]] = None
    kernel_compute: Optional[str] = None

    def param(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default

    def default_apply(self, m: Meta, seg: torch.Tensor, it: torch.Tensor) -> Meta:
        del it
        out = dict(m)
        out[self.primary] = self.combiner.pair(m[self.primary], seg)
        return out

    def run_apply(self, m: Meta, seg: torch.Tensor, it: torch.Tensor) -> Meta:
        f = self.apply if self.apply is not None else self.default_apply
        new = f(m, seg, it)
        # keep the scratch slot at identity so sentinel gathers stay inert
        return {k: torch.cat([v[:-1], m[k][-1:]]) for k, v in new.items()}


def gather_meta(m: Meta, idx: torch.Tensor, fields: Optional[tuple] = None) -> Meta:
    keys = fields if fields is not None else tuple(m.keys())
    return {k: m[k][idx] for k in keys}
