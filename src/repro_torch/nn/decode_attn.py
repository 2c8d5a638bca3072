"""Split-KV decode attention (flash-decoding) on the single-controller mesh.

Port of `repro.nn.decode_attn`. For long-context decode the KV cache is cut
along its sequence axis over the mesh's 'model' axis. Each shard computes
the partial attention of every query head against its slice of the cache,
carrying the softmax statistics (acc, m, l); the partials are combined
exactly by the log-sum-exp algebra, folded over the shards in shard order
on the first shard's device (the reference's `pmax` and two `psum`s), with
the reference's 1e-30 floor on the normalizer.

The batch is cut over 'data' when it divides the axis, and replicated
otherwise (batch-1 long-context decode). Every shard runs one after another
in this process, each on its own grid position's device. GQA is group-major
(query head h reads kv head h % Hkv), taken by a grouped einsum so the
cache slice is never repeated per query head.
"""

from __future__ import annotations

import math

import torch

from repro_torch import mesh as M


def _local_partial(q, k, v, valid):
    """q (B, H, 1, D); k, v (B, Hkv, Sl, D); valid (Sl,) bool ->
    (acc (B, H, 1, D), m, l (B, H, 1, 1)), float32."""
    b, h, sq, dh = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, h // hkv, hkv, sq, dh)
    root = torch.tensor(math.sqrt(dh), dtype=torch.float32, device=q.device).to(q.dtype)
    logits = torch.einsum("bghqd,bhkd->bghqk", qg, k) / root
    logits = torch.where(valid, logits.float(), -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bghqk,bhkd->bghqd", p.to(q.dtype), v).float()
    return (acc.reshape(b, h, sq, dh), m.reshape(b, h, sq, 1), l.reshape(b, h, sq, 1))


def decode_attention_splitkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             valid_len: int, mesh) -> torch.Tensor:
    """Exact attention of q (B, H, 1, Dh) against a cache k, v (B, Hkv, S,
    Dh) whose first `valid_len` positions are valid, with S cut over the
    mesh's 'model' axis and B over its 'data' axis when it divides; (B, H,
    1, Dh) in q's dtype on the mesh's first device."""
    nshard = mesh.shape[M.MODEL_AXIS]
    s_total = k.shape[2]
    if s_total % nshard:
        raise ValueError(f"cache length {s_total} does not split over {nshard} shards")
    s_local = s_total // nshard
    b_parts = mesh.shape[M.DATA_AXIS]
    if q.shape[0] % b_parts:
        b_parts = 1                      # batch-1 long-context decode: replicate
    b_local = q.shape[0] // b_parts
    outs = []
    for d in range(b_parts):
        bs = slice(d * b_local, (d + 1) * b_local)
        parts = []
        for s in range(nshard):
            dev = mesh.device(d, s)
            ks = slice(s * s_local, (s + 1) * s_local)
            kpos = s * s_local + torch.arange(s_local, device=dev)
            parts.append(_local_partial(q[bs].to(dev), k[bs, :, ks].to(dev),
                                        v[bs, :, ks].to(dev), kpos < valid_len))
        first = mesh.device(d, 0)
        m_g = M.reduce_to([p[1] for p in parts], "max", first)
        corr = [torch.exp(m - m_g.to(m.device)) for _, m, _ in parts]
        l_g = M.reduce_to([l * c for (_, _, l), c in zip(parts, corr)], "sum", first)
        acc_g = M.reduce_to([a * c for (a, _, _), c in zip(parts, corr)], "sum", first)
        outs.append((acc_g / l_g.clamp_min(1e-30)).to(q.dtype))
    out = mesh.device(0, 0)
    return torch.cat([o.to(out) for o in outs]) if len(outs) > 1 else outs[0].to(out)
