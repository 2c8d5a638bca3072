"""Device dispatcher over the hand-written kernels.

Port of `repro.kernels.ops`, the public kernel API: the three kernels on
the solo engine's path, the deletion overlay, ELL SpMM, EmbeddingBag and
flash attention; beside them the batched engine's Q-wide pull, which the
reference leaves to XLA. The pick is by the device of the tensor given: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the CUDA kernel — or the call
raises (nvcc missing, a refused launch). There is no fallback from one to the
other.

Gradients. A kernel writes into a fresh tensor and carries no `grad_fn`, so
the ops that training differentiates are `torch.autograd.Function`s, whose
output has no `grad_fn` where no input requires a gradient (as in serving):
`segment_reduce` (sum: the backward is a gather, `grad[seg_id]`, 0 for a
dropped id), `embedding_bag` (sum, mean: the deterministic scatter of each
bag's gradient over its ids, [-V, -1] wrapped to id + V; an id still
outside [0, V) drops, as `jax.grad` of the reference's `table[idx]` drops
it, though its forward clamps it), `attention` (the flash backward kernel
that `flash_attention.route_bwd` picks; on the card the forward also writes
each row's log-sum-exp, kept for the backward, but only when an input needs
a gradient, so serving pays nothing for it) and `gather_rows`
(`table[idx]`, whose backward is the deterministic scatter). The
deterministic scatter sorts the flat ids stably, gathers the gradient rows
in that order and sums them with `segment_reduce` (the kernel on the card),
so every row's sum is taken in one fixed order: autograd's backward of
plain indexing is an accumulating `index_put_`, whose order PyTorch does
not fix. The min/max backwards of `segment_reduce` and `embedding_bag` are
not ported and raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ell_spmv as _ell
from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import frontier_pack as _fp
from repro_torch.kernels import segment_reduce as _sr


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel route for device {t.device}")


def ell_combine(nbr, wgt, vals, compute: str, combine: str = "min", dead=None):
    """partial (R,) for one ELL slice; `compute` is a `COMPUTE_OPS` name.
    `dead` (optional (R, W) bool/int8) is the streaming deletion overlay:
    flagged slots give the combine identity, bit-equal to the call without
    it on `ell_spmv.neutralize(nbr, dead, n)`."""
    if _route(vals) == "cuda":
        return _ell.ell_combine_cuda(nbr, wgt, vals, compute, combine, dead)
    return _ell.ell_combine_plain(nbr, wgt, vals, compute, combine, dead)


def ell_combine_batched(nbr, wgt, vals, compute: str, combine: str = "min"):
    """(R, Q) partials of one ELL slice for vertex-major vals (n+1, Q): the
    batched engine's dense pull, the same halving tree over W per column."""
    if _route(vals) == "cuda":
        return _ell.ell_combine_batched_cuda(nbr, wgt, vals, compute, combine)
    return _ell.ell_combine_batched_plain(nbr, wgt, vals, compute, combine)


def ell_spmm(nbr, wgt, feats):
    """(R, D) weighted neighbour sum over one ELL slice for (n+1, D) feats."""
    if _route(feats) == "cuda":
        return _ell.ell_spmm_cuda(nbr, wgt, feats)
    return _ell.ell_spmm_plain(nbr, wgt, feats)


def frontier_pack(mask, cap: int):
    """(ids (cap,), count, overflow) of a dense (n,) bool mask, sentinel n."""
    if _route(mask) == "cuda":
        return _fp.frontier_pack_cuda(mask, cap)
    return _fp.frontier_pack_plain(mask, cap)


def _segment_reduce(vals, seg_ids, num_segments, combine, fill):
    if _route(vals) == "cuda":
        return _sr.segment_reduce_cuda(vals, seg_ids, num_segments, combine, fill)
    return _sr.segment_reduce_plain(vals, seg_ids, num_segments, combine, fill)


def _embedding_bag(table, idx, mode):
    if _route(table) == "cuda":
        return _bag.embedding_bag_cuda(table, idx, mode)
    return _bag.embedding_bag_plain(table, idx, mode)


def _attention(q, k, v, causal):
    if _route(q) == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal)
    return _fa.attention_plain(q, k, v, causal)


def _attention_bwd(q, k, v, out, dout, causal, lse):
    if _route(q) == "cuda":
        return _fa.flash_attention_bwd_cuda(q, k, v, out, dout, causal, lse)
    return _fa.attention_bwd_plain(q, k, v, out, dout, causal)


def _scatter_rows(rows: torch.Tensor, ids: torch.Tensor, num: int) -> torch.Tensor:
    """The deterministic scatter: (num, ...) float32 sums of `rows` (N, ...)
    by `ids` (N,), ids outside [0, num) dropped. The ids are sorted stably,
    the rows gathered in that order and summed by `segment_reduce`, so each
    sum runs over its rows in their original order, on the kernel on the
    card."""
    ids, order = torch.sort(ids.reshape(-1).to(torch.int32), stable=True)
    flat = rows[order].float().reshape(ids.shape[0], -1)
    out = _segment_reduce(flat.contiguous(), ids.contiguous(), num, "sum", None)
    return out.reshape((num,) + tuple(rows.shape[1:]))


class _SegmentReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, seg_ids, num, combine, fill):
        ctx.save_for_backward(seg_ids)
        ctx.num, ctx.combine = num, combine
        return _segment_reduce(vals, seg_ids, num, combine, fill)

    @staticmethod
    def backward(ctx, grad):
        if ctx.combine != "sum":
            raise NotImplementedError(
                f"the backward of segment_reduce {ctx.combine!r} is not ported (only sum)")
        (seg_ids,) = ctx.saved_tensors
        num = ctx.num
        ok = (seg_ids >= 0) & (seg_ids < num)
        pad = torch.cat([grad, grad.new_zeros((1,) + tuple(grad.shape[1:]))])
        return pad[torch.where(ok, seg_ids, num).long()], None, None, None, None


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, mode):
        ctx.save_for_backward(idx)
        ctx.mode, ctx.rows, ctx.dtype = mode, table.shape[0], table.dtype
        return _embedding_bag(table, idx, mode)

    @staticmethod
    def backward(ctx, grad):
        if ctx.mode not in ("sum", "mean"):
            raise NotImplementedError(
                f"the backward of embedding_bag {ctx.mode!r} is not ported (sum, mean)")
        (idx,) = ctx.saved_tensors
        b, k = idx.shape
        if ctx.mode == "mean":
            grad = grad / k
        rows = grad[:, None, :].expand(b, k, grad.shape[-1]).reshape(b * k, -1)
        # wrapped once but not clamped: an id the forward clamped drops here
        ids = torch.where(idx < 0, idx + ctx.rows, idx)
        return _scatter_rows(rows, ids, ctx.rows).to(ctx.dtype), None, None


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, grads):
        lse = None
        if grads and _route(q) == "cuda":
            out, lse = _fa.flash_attention_cuda(q, k, v, causal, with_lse=True)
        else:
            out = _attention(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _attention_bwd(q, k, v, out, dout.contiguous(), ctx.causal, lse)
        return dq, dk, dv, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype = tuple(table.shape), table.dtype
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        rows = grad.reshape((-1,) + ctx.shape[1:])
        ids = torch.where(idx < 0, idx + ctx.shape[0], idx)
        return _scatter_rows(rows, ids, ctx.shape[0]).to(ctx.dtype), None


def segment_reduce(vals, seg_ids, num_segments: int, combine: str = "sum",
                   fill: Optional[float] = None):
    """(num,) or (num, D) reduction over ascending `seg_ids`; empty segments
    hold `fill` (default: the combine identity). Differentiable for sum."""
    return _SegmentReduce.apply(vals, seg_ids, num_segments, combine, fill)


def embedding_bag(table, idx, mode: str = "sum"):
    """(B, D) sum, mean or max over each bag of (B, K) rows of `table`.
    Differentiable in `table` for sum and mean."""
    return _EmbeddingBag.apply(table, idx, mode)


def attention(q, k, v, causal: bool = True):
    """Causal GQA attention, (B, Hq, Sq, D) in q's dtype; head h reads kv
    head h % Hkv. Differentiable in q, k and v (the flash backward on the
    card). The forward keeps what the backward needs only when a gradient
    can flow (grad mode on and an input that requires one)."""
    grads = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _Attention.apply(q, k, v, causal, grads)


def gather_rows(table, idx):
    """`table[idx]` for an integer `idx` of any shape (ids in [-V, V), a
    negative id counting from the end): (*idx.shape, *table.shape[1:]).
    Differentiable in `table`, by the deterministic scatter."""
    return _GatherRows.apply(table, idx.long())


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last `reset_launches()`."""
    return dict(_build.LAUNCHES)


def reset_launches() -> None:
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
