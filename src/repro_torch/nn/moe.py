"""Sort-based top-k MoE layer (GShard semantics).

Port of `repro.nn.moe`. Dispatch is by sort, as in the reference: the
(token, k) pairs are sorted stably by expert, ranked within their expert's
group and scattered into an (E, C + 1, d) buffer whose slot C takes the pairs
past the capacity (dropped). The expert products are batched matmuls; the
aux load-balance loss is Switch's (mean fraction x mean router prob).

The combine, the reference's `segment_sum(gathered, st_, t)`, is the
Combine stage's keyed sum (`core.acc.Combiner.segment`): the pairs are in
expert order, so it sorts them stably by token first, then runs
`kernels.ops.segment_reduce`, the hand-written kernel on the card. That
kernel sums float32, so the pairs go in as float32 and the sum is cast back
to the activations' dtype: in float32 the combine is the reference's sum in
another order; in bfloat16 it rounds once, at the end (within 2^-9 of the
float32 sum, relative), where a bfloat16 scatter-add rounds after each of
the top_k adds.

Gradients flow as in the reference: through the router's softmax and the
normalised top-k weights, the expert products, the combine (whose backward
is a gather) and the aux loss's mean router probability. The two gathers
whose backward is a scatter-add, the tokens into the buffer (`x[st_]`) and
the expert outputs back to the pairs (`ye[se, rank]`, flattened to one
index), are `kernels.ops.gather_rows`, whose backward is the deterministic
scatter.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.acc import SUM_AGG
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, the lower index first
    among equal values, as `jax.lax.top_k` orders them (capacity ranks
    depend on it; `torch.topk` promises no order among ties)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch(topi: torch.Tensor, n_experts: int, c: int):
    """Sort-based dispatch of the (T, k) expert picks at capacity c: the
    pairs sorted stably by expert (`se`), their tokens (`st_`), the order
    that sorts them (`order`), each pair's rank within its expert's group
    capped at c (`rank_c`, c = dropped) and the kept mask (rank < c)."""
    t, k = topi.shape
    dev = topi.device
    se, order = torch.sort(topi.reshape(-1), stable=True)
    st_ = torch.arange(t, device=dev).repeat_interleave(k)[order]
    grp_start = torch.searchsorted(se, torch.arange(n_experts, device=dev, dtype=se.dtype))
    rank = torch.arange(t * k, device=dev) - grp_start[se]
    return se, st_, order, rank.clamp_max(c), rank < c


def moe_ffn(x: torch.Tensor, p: dict, cfg: MoEConfig):
    """x: (T, d) tokens; p: router (d, E), we1/we3 (E, d, f), we2 (E, f, d).
    Returns (out (T, d) in x's dtype, aux_loss float32 scalar)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(t, cfg)

    gates = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    topv, topi = top_k(gates, k)                               # (T, k)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- sort-based dispatch into an (E, C + 1, d) buffer, slot C dropped --
    se, st_, order, rank_c, keep = dispatch(topi, e, c)
    sw = topv.reshape(-1)[order]
    buf = torch.zeros((e * (c + 1), d), dtype=x.dtype, device=x.device)
    buf[se * (c + 1) + rank_c] = kops.gather_rows(x, st_)
    xe = buf.view(e, c + 1, d)[:, :c]

    # ---- expert products ------------------------------------------------
    h = F.silu(torch.bmm(xe, p["we1"])) * torch.bmm(xe, p["we3"])
    ye = torch.bmm(h, p["we2"])                                # (E, C, d)

    # ---- combine --------------------------------------------------------
    gathered = kops.gather_rows(ye.reshape(e * c, d), se * c + rank_c.clamp_max(c - 1))
    gathered = torch.where(keep[:, None], gathered * sw[:, None].to(x.dtype), 0.0)
    out = SUM_AGG.segment(gathered.float(), st_, t)

    # ---- Switch aux loss -------------------------------------------------
    frac = F.one_hot(topi[:, 0], e).float().mean(dim=0)
    prob = gates.mean(dim=0)
    aux = e * (frac * prob).sum()
    return out.to(x.dtype), aux
