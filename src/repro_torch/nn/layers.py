"""Transformer building blocks (functions over dicts of tensors).

Port of `repro.nn.layers`: `rms_norm`, `rope`, `swiglu`, `gqa_attention`
(with its kv-cache decode branch, `_decode_attention`) and `cross_entropy`.
Layouts are the reference's: activations (B, S, d), weights (d_in, d_out),
attention heads (B, H, S, Dh), kv heads grouped group-major (query head h
reads kv head h % n_kv).

`gqa_attention(use_flash=True)` without a cache and at S < 2048 calls
`kernels.ops.attention`, which on the card is the hand-written flash kernel;
`use_flash=False` takes the plain attention, as the reference takes
`ref.attention_ref`. The projections are `torch.matmul`, as the reference
leaves them to XLA. `attn_override`, given, replaces the decode branch's
masked attention: it is called as attn_override(q, k, v, valid_len) with
the whole updated cache, as the reference calls it (split-KV decode,
`nn.decode_attn.decode_attention_splitkv` with a mesh bound). The
reference's sharding constraints (`sh.constrain`, its `constrain=` flag)
have no counterpart: a single controller places tensors explicitly
(`distributed.sharding.constrain` is the identity).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ops as kops
from repro_torch.nn.chunked_attn import chunked_attention

#: from this sequence length on, attention goes through `chunked_attention`
CHUNKED_FROM = 2048


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) rotary over D; positions: (..., S)."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    ang = positions[..., None].float() * freq                  # (..., S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)             # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def _cache_update(cache: torch.Tensor, new: torch.Tensor, start: int) -> torch.Tensor:
    """A copy of `cache` with `new` written along axis 2 from `start`, the
    start clamped so the block fits (as `lax.dynamic_update_slice` does)."""
    s = new.shape[2]
    start = min(max(start, 0), cache.shape[2] - s)
    out = cache.clone()
    out[:, :, start:start + s] = new
    return out


def gqa_attention(x: torch.Tensor, p: dict, *, n_heads: int, n_kv: int,
                  positions: torch.Tensor, rope_theta: float = 10000.0,
                  kv_cache: tuple | None = None, cache_len=None,
                  causal: bool = True, use_flash: bool = False, attn_override=None):
    """x: (B, S, d). Returns (out, (k, v)), k and v laid out
    (B, n_kv, S_total, head_dim); with `kv_cache` = (ck, cv), the new keys and
    values are written into a copy of the cache at `cache_len`, and the
    decode's attention is `attn_override(q, k, v, cache_len + S)` when given."""
    b, s, _ = x.shape
    dh = p["wq"].shape[-1] // n_heads
    q = (x @ p["wq"]).reshape(b, s, n_heads, dh)
    k = (x @ p["wk"]).reshape(b, s, n_kv, dh)
    v = (x @ p["wv"]).reshape(b, s, n_kv, dh)
    q = rope(q, positions, rope_theta).transpose(1, 2)        # (B, H, S, Dh)
    k = rope(k, positions, rope_theta).transpose(1, 2)        # (B, Hkv, S, Dh)
    v = v.transpose(1, 2)

    if kv_cache is not None:
        start = int(cache_len)
        k = _cache_update(kv_cache[0], k, start)
        v = _cache_update(kv_cache[1], v, start)
        if s >= CHUNKED_FROM and k.shape[2] == s:
            # long prefill into an exactly-sized cache
            out = chunked_attention(q, k, v, causal=True)
        elif attn_override is not None:
            # e.g. split-KV decode over a mesh
            out = attn_override(q, k, v, start + s)
        else:
            # decode: mask beyond the valid length, no causal within the step
            out = _decode_attention(q, k, v, start + s)
    elif s >= CHUNKED_FROM:
        out = chunked_attention(q, k, v, causal=causal)
    elif use_flash:
        out = kops.attention(q.contiguous(), k.contiguous(), v.contiguous(), causal)
    else:
        out = _fa.attention_plain(q, k, v, causal)

    out = out.transpose(1, 2).reshape(b, s, n_heads * dh) @ p["wo"]
    return out, (k, v)


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid_len: int) -> torch.Tensor:
    """Masked attention against a (possibly longer) cache, GQA by a grouped
    einsum (the cache is never repeated per query head)."""
    b, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, h // hkv, hkv, sq, dh)
    root = torch.sqrt(torch.tensor(float(dh))).to(q.dtype)
    logits = torch.einsum("bghqd,bhkd->bghqk", qg, k) / root.to(q.device)
    kpos = torch.arange(skv, device=q.device)
    qpos = valid_len - sq + torch.arange(sq, device=q.device)
    logits = torch.where(kpos[None, :] <= qpos[:, None], logits, -1e30)
    pr = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bghqk,bhkd->bghqd", pr, v).reshape(b, h, sq, dh)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, float32 accumulation."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
