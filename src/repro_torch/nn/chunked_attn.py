"""Memory-efficient (chunked, online-softmax) attention in plain PyTorch.

Port of `repro.nn.chunked_attn.chunked_attention`: for long sequences
(`layers.gqa_attention` takes it at S >= 2048) the (B, H, S, S) scores do
not fit, so queries are taken in chunks and, for each, the kv chunks in
order, carrying the running max, sum and float32 accumulator — the flash
kernel's algorithm in tensor code. The reference computes it in XLA, not in
a kernel, so the port keeps it as PyTorch. What the reference adds for its
mesh (`pvary` over manual axes, `jax.checkpoint` of the scan bodies) has
no counterpart without a mesh and is left out; under causal masking the kv
chunks wholly past a query chunk's last row are skipped instead of masked,
which leaves the result as it is (they would add exp(-1e30 - m) = 0).
"""

from __future__ import annotations

import torch


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_chunk: int = 1024,
                      kv_chunk: int = 1024, kv_offset: int = 0) -> torch.Tensor:
    """q (B, H, Sq, D), k and v (B, Hkv, Skv, D) -> (B, H, Sq, D). Heads are
    grouped group-major (head h reads kv head h % Hkv); `kv_offset` is the
    first kv position relative to query position 0."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    if sq % qc or skv % kc:
        raise ValueError(f"Sq={sq} and Skv={skv} must divide by chunks {qc}, {kc}")
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, group, hkv, sq, d)
    rows = torch.arange(qc, device=q.device)[:, None]
    cols = torch.arange(kc, device=q.device)[None, :]
    outs = []
    for q0 in range(0, sq, qc):
        q_blk = qg[:, :, :, q0:q0 + qc]
        m = torch.full((b, group, hkv, qc, 1), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, group, hkv, qc, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, skv, kc):
            if causal and k0 > q0 + qc - 1 + kv_offset:
                break
            k_blk = k[:, :, k0:k0 + kc]
            v_blk = v[:, :, k0:k0 + kc]
            s = (torch.einsum("bghqd,bhkd->bghqk", q_blk, k_blk) * scale).float()
            if causal:
                ok = (k0 + cols) <= (q0 + rows + kv_offset)
                s = torch.where(ok, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            pv = torch.einsum("bghqk,bhkd->bghqd", p.to(v_blk.dtype), v_blk)
            acc = acc * corr + pv.float()
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)).to(q.dtype))
    return torch.cat(outs, dim=3).reshape(b, h, sq, d)
