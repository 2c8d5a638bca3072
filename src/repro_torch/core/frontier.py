"""Just-in-time task management — paper Sec. 4.

Port of `repro.core.frontier`. Three filters build the next active list:

  * online_filter  — O(frontier edges): compacts the changed destinations
    straight out of the push step's edge buffer; unsorted, may overflow.
  * ballot_filter  — O(|V|): full scan of the changed mask; sorted and
    unique. On the card it is the `frontier_pack` CUDA kernel, the paper's
    `__ballot` + `__popc` filter.
  * batch_filter   — the Gunrock-style baseline (paper Fig. 6a).

`dedupe_winners` keeps exactly one lane per destination (the highest edge
index wins). Every function has static output shapes; a scatter that the
reference drops out of range goes to an extra (size+1)-th slot here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops as kops

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def mask_from_ids(ids: torch.Tensor, n_nodes: int, q: int = 0) -> torch.Tensor:
    """Dense (n+1,) frontier mask from a vertex-id list (out-of-range ids
    drop; the scratch row stays False); with q > 0 the (n+1, q) broadcast."""
    ids = ids.long()
    ok = (ids >= 0) & (ids <= n_nodes)
    base = torch.zeros((n_nodes + 2,), dtype=torch.bool, device=ids.device)
    base[torch.where(ok, ids, n_nodes + 1)] = True
    base = base[: n_nodes + 1].clone()
    base[-1] = False
    if q == 0:
        return base
    return base[:, None].expand(n_nodes + 1, q)


def _compact(flags: torch.Tensor, values: torch.Tensor, cap: int, fill: int
             ) -> Triple:
    """Order-preserving compaction of values[flags] into (cap,) over the
    last axis; returns (ids, min(count, cap), count > cap)."""
    f = flags.to(torch.int32)
    pos = torch.cumsum(f, -1, dtype=torch.int32) - 1
    if f.shape[-1] > 0:
        count = pos[..., -1] + 1
    else:
        count = torch.zeros(f.shape[:-1], dtype=torch.int32, device=f.device)
    overflow = count > cap
    tgt = torch.where((f > 0) & (pos < cap), pos, cap).long()
    buf = torch.full(f.shape[:-1] + (cap + 1,), fill, dtype=torch.int32,
                     device=f.device)
    buf.scatter_(-1, tgt, values.to(torch.int32).expand(f.shape))
    return buf[..., :cap], torch.clamp(count, max=cap), overflow


def compact_mask(mask: torch.Tensor, cap: int, fill: int) -> Triple:
    """Stream-compact the indices of True lanes of `mask` into (cap,).
    Returns (ids, count, overflow); sorted and unique."""
    ids_src = torch.arange(mask.shape[-1], dtype=torch.int32, device=mask.device)
    return _compact(mask, ids_src, cap, fill)


def compact_values(flags: torch.Tensor, values: torch.Tensor, cap: int,
                   fill: int) -> Triple:
    """Compact `values[flags]` into a (cap,) buffer (order-preserving)."""
    return _compact(flags, values, cap, fill)


def online_filter(changed_e: torch.Tensor, dst_e: torch.Tensor, cap: int,
                  n_nodes: int) -> Triple:
    """Paper's online filter: the activated destinations of the edge buffer."""
    return compact_values(changed_e, dst_e, cap, fill=n_nodes)


def ballot_filter(changed_v: torch.Tensor, cap: int, n_nodes: int) -> Triple:
    """Paper's ballot filter: full metadata scan -> sorted unique active
    list; the `frontier_pack` kernel on the card.

    changed_v: (n+1,) bool dense mask (scratch lane must be False).
    """
    return kops.frontier_pack(changed_v[:n_nodes].contiguous(), cap)


def select_edges(eactive: torch.Tensor, cap: int) -> Triple:
    """Compact the active lanes of an (E,) edge mask: (safe_ids, lane_ok,
    overflow); unused lanes clamp to E-1. The compaction is the
    `frontier_pack` kernel on the card (the edge-sharded scan's)."""
    e = eactive.shape[0]
    ids, cnt, ovf = kops.frontier_pack(eactive.contiguous(), cap)
    safe = torch.clamp(ids, max=e - 1)
    lane_ok = torch.arange(cap, dtype=torch.int32, device=ids.device) < cnt
    return safe, lane_ok, ovf


#: scratch bins for the lanes that hold no ticket in `dedupe_winners`
_SPREAD = 4096


def dedupe_winners(changed_e: torch.Tensor, dst_e: torch.Tensor, n_nodes: int
                   ) -> torch.Tensor:
    """Keep exactly one True lane per destination: the highest edge index
    wins (scatter-max tournament). `dst_e` lies in [0, n].

    A lane without a ticket cannot raise a maximum, so it is sent to one of
    `_SPREAD` scratch bins past the vertices instead of its own destination:
    on the card a push buffer's many sentinel lanes (dst == n) would
    otherwise serialize their atomics on one address. The result is the
    reference's.
    """
    lanes = torch.arange(changed_e.shape[-1], dtype=torch.int32,
                         device=changed_e.device)
    ticket = torch.where(changed_e, lanes + 1, 0)
    lead = changed_e.shape[:-1]
    winner = torch.zeros(lead + (n_nodes + 1 + _SPREAD,), dtype=torch.int32,
                         device=changed_e.device)
    idx = dst_e.long()
    spread = torch.where(changed_e, idx, n_nodes + 1 + (lanes % _SPREAD).long())
    winner.scatter_reduce_(-1, spread, ticket, reduce="amax")
    return changed_e & (torch.gather(winner, -1, idx) == ticket)


# ---------------------------------------------------------------------------
# query-major batched variants: row q equals the unbatched function on row q
# ---------------------------------------------------------------------------


def compact_mask_batched(mask: torch.Tensor, cap: int, fill: int) -> Triple:
    """`compact_mask` over the last axis of a (..., L) mask."""
    return compact_mask(mask, cap, fill)


def compact_values_batched(flags: torch.Tensor, values: torch.Tensor, cap: int,
                           fill: int) -> Triple:
    """`compact_values` over the last axis of (..., E) flags/values."""
    return _compact(flags, values, cap, fill)


def online_filter_batched(changed_e, dst_e, cap: int, n_nodes: int) -> Triple:
    """Per-query online filter over a (..., E) edge buffer."""
    return compact_values_batched(changed_e, dst_e, cap, fill=n_nodes)


def ballot_filter_batched(changed_v, cap: int, n_nodes: int) -> Triple:
    """Per-query ballot filter over a (..., n+1) dense changed-mask."""
    return compact_mask_batched(changed_v[..., :n_nodes], cap, fill=n_nodes)


def dedupe_winners_batched(changed_e, dst_e, n_nodes: int) -> torch.Tensor:
    """Per-query `dedupe_winners` on (..., E) buffers."""
    return dedupe_winners(changed_e, dst_e, n_nodes)


def batch_filter(upd_e, dst_e, old_vals, cap: int, n_nodes: int, better
                 ) -> Triple:
    """Gunrock-style batch filter baseline (paper Fig. 6a)."""
    changed_e = better(upd_e, old_vals[dst_e.long()])
    return compact_values(changed_e, dst_e, cap, fill=n_nodes)


def frontier_degree_histogram(ids, count, degrees, bounds=(4, 32, 256)
                              ) -> torch.Tensor:
    """Small/med/large/huge classification of the current frontier."""
    valid = torch.arange(ids.shape[0], device=ids.device) < count
    safe = torch.clamp(ids.long(), max=degrees.shape[0] - 1)
    deg = torch.where(valid, degrees[safe], -1)
    outs = []
    lo = 0
    for hi in bounds:
        outs.append(((deg > lo) & (deg <= hi)).sum())
        lo = hi
    outs.append((deg > bounds[-1]).sum())
    return torch.stack(outs).to(torch.int32)
