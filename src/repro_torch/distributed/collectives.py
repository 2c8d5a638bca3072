"""Gradient-compression collectives over one axis of the single-controller
mesh.

Port of `repro.distributed.collectives`:

  * bf16 all-reduce with error feedback: each shard sends its gradient plus
    carried residual rounded to bf16 and keeps the rounding error as its
    next residual, so the float32 update stays unbiased over steps;
  * top-k all-reduce (Deep Gradient Compression): each shard sends its k
    largest-magnitude entries (value and index) and keeps the rest as its
    residual.

The reference's bodies run under `shard_map` over the 'data' axis with
`psum`/`all_gather`; here a collective is a function over the per-shard
tensors (`repro_torch.mesh`): the sum folds the shards in shard order on
shard 0's device and hands the result back to each shard's device, and the
gather concatenates in shard order. `jax.lax.top_k` breaks ties by the lower
index; the port takes the k-th largest magnitude (`torch.topk`, whose tie
order PyTorch does not fix) as a threshold and keeps the entries above it
and the lowest-indexed of those equal to it, which is the same set.
The top-k reduction adds the gathered (index, value) pairs with the
deterministic scatter (`kernels.ops.scatter_rows`: stable sort by index,
then `segment_reduce`), so indices that collide across shards are summed in
shard order, from 0, as XLA's scatter-add sums them.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch import mesh as M
from repro_torch import tree as T
from repro_torch.kernels import ops as kops


def compress_bf16(grad: torch.Tensor, residual: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sent, new_residual), both float32: sent = bf16(grad + residual),
    new_residual = (grad + residual) - sent, so sent + new_residual is the
    float32 sum exactly."""
    want = grad.float() + residual
    sent = want.to(torch.bfloat16).float()
    return sent, want - sent


def bf16_psum_ef(grads: Sequence[torch.Tensor], residuals: Sequence[torch.Tensor]
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per-shard gradients and residuals -> (each shard's copy of the sum of
    the bf16-compressed sends, float32; each shard's new residual)."""
    sent, res = zip(*(compress_bf16(g, r) for g, r in zip(grads, residuals)))
    return M.all_reduce(list(sent), "sum"), list(res)


def compress_topk(grad: torch.Tensor, residual: torch.Tensor, k: int):
    """(idx (k,) int64, sel (k,) float32, new_residual like grad): the k
    entries of grad + residual largest in magnitude (ties: lower index
    first; idx in no particular order), and the sum with those entries
    zeroed."""
    want = (grad.float() + residual).reshape(-1)
    mag = want.abs()
    # the k-th largest magnitude, then everything above it and the first of
    # its ties in index order: the set `jax.lax.top_k` picks (the order
    # within a shard's pairs does not matter: its indices are distinct)
    thr = torch.topk(mag, k, sorted=False).values.min()
    above = torch.nonzero(mag > thr).reshape(-1)
    idx = torch.cat([above, torch.nonzero(mag == thr).reshape(-1)[:k - above.numel()]])
    del mag
    sel = want[idx]
    new_res = want.clone()
    new_res[idx] = 0.0
    return idx, sel, new_res.reshape(grad.shape)


def topk_psum_ef(grads: Sequence[torch.Tensor], residuals: Sequence[torch.Tensor], k: int
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per-shard gradients and residuals -> (each shard's copy of the sum of
    every shard's top-k entries, float32, shaped like a gradient; each
    shard's new residual). The k (index, value) pairs of every shard are
    gathered in shard order and added into zeros."""
    picked = [compress_topk(g, r, k) for g, r in zip(grads, residuals)]
    dev = grads[0].device
    g_idx = torch.cat([p[0].to(dev) for p in picked])
    g_val = torch.cat([p[1].to(dev) for p in picked])
    size = grads[0].numel()
    red = kops.scatter_rows(g_val[:, None], g_idx, size).reshape(grads[0].shape)
    return [red.to(g.device) for g in grads], [p[2] for p in picked]


def make_compressed_allreduce(mesh, axis: str = M.DATA_AXIS, method: str = "bf16",
                              k_frac: float = 0.01):
    """f(grads, residuals) -> (reduced, new_residuals). `grads` is a list of
    per-shard gradient trees, one a shard along `axis` of `mesh` (its
    partial gradient), each leaf on that shard's device; `residuals` is
    alike. Each leaf is reduced on its own, as the reference's `apply`
    reduces each leaf, and comes back as a list of per-shard trees."""
    if method not in ("bf16", "topk"):
        raise ValueError(f"unknown method {method!r}")
    n = mesh.shape[axis]

    def one(gs, rs):
        if method == "bf16":
            return bf16_psum_ef(gs, rs)
        k = max(1, int(gs[0].numel() * k_frac))
        return topk_psum_ef(gs, rs, k)

    def apply(grads, residuals):
        if len(grads) != n or len(residuals) != n:
            raise ValueError(f"{len(grads)} gradient trees for {n} shards on {axis!r}")
        flat_g = [T.leaves(g) for g in grads]
        flat_r = [T.leaves(r) for r in residuals]
        outs = [one([fg[i] for fg in flat_g], [fr[i] for fr in flat_r])
                for i in range(len(flat_g[0]))]
        red = [T.unflatten(grads[d], [o[0][d] for o in outs]) for d in range(n)]
        res = [T.unflatten(grads[d], [o[1][d] for o in outs]) for d in range(n)]
        return red, res

    return apply
