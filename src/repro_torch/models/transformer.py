"""Decoder-only transformer LM (dense and MoE), forward and serving.

Port of `repro.models.transformer` for the five assigned LM architectures
(minitron-4b, granite-3-8b, llama3-405b, moonshot-v1-16b-a3b,
granite-moe-1b-a400m). The parameter layout is the reference's: layer
weights stacked on a leading (L, ...) axis, `embed` (V_pad, d) and
`lm_head` (d, V_pad) over the vocab padded to a multiple of 2048. Layers run
in a Python loop over the stack (the reference's `lax.scan`).

`forward` (no cache, S < 2048) takes attention through
`gqa_attention(use_flash=True)`, which is the flash kernel on the card; the
reference takes XLA's attention there (`use_flash=False`), the same
function. `decode_step` keeps the reference's cache branch (masked
attention against the whole cache, in PyTorch ops, as the reference leaves
it to XLA). A cache's `len` is a Python int, so no step reads the device
for it. The sharding hints and the split-kv `attn_override` are the
distributed slice's and are left out.

Training: `loss_fn` is the reference's (padded vocab lanes masked to -1e30,
plus `aux_loss_weight` times the MoE aux loss), differentiated by autograd.
The embedding lookup is `kernels.ops.gather_rows`, whose backward is the
deterministic scatter; attention's backward is the flash backward kernel.
With `cfg.remat`, when a gradient is to be taken, each layer runs under
`torch.utils.checkpoint` (the reference's per-layer `jax.checkpoint`): its
activations are recomputed in the backward. The recomputed MoE forward takes
the same routes, as nothing in it draws random numbers and its sorts are
stable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.nn import layers as L
from repro_torch.nn.moe import MoEConfig, moe_ffn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None        # default d_model // n_heads
    moe: Optional[MoEConfig] = None       # None = dense FFN
    rope_theta: float = 10000.0
    dtype: str = "float32"                # activations and parameters
    remat: bool = True                    # recompute each layer in the backward
    aux_loss_weight: float = 0.01

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 2048, as the reference pads it
        (so the embedding shards evenly over its 'model' axis)."""
        return ((self.vocab + 2047) // 2048) * 2048

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.n_heads * self.dh * 2 + d * self.n_kv * self.dh * 2
        if self.moe:
            ffn = 3 * d * f * self.moe.n_experts + d * self.moe.n_experts
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * v * d + d

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        attn = d * self.n_heads * self.dh * 2 + d * self.n_kv * self.dh * 2
        ffn = 3 * d * f * self.moe.top_k + d * self.moe.n_experts
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random weights in the reference's layout and scales (normal times
    fan_in^-0.5 unless noted), drawn from `generator`, which lives on
    `device`. Each (fan_in, fan_out) block is drawn in float32 and stored in
    the config's dtype one block at a time, so the float32 draw of a whole
    stack is never held (granite-3-8b's `w1` would be 8.4 GB of it)."""
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]
    d, dh, h, hkv, f, v, l = (
        cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv, cfg.d_ff,
        cfg.padded_vocab, cfg.n_layers,
    )

    def w(*shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        out = torch.empty(shape, dtype=dt, device=dev)
        for block in out.view(-1, *shape[-2:]):
            block.copy_(torch.randn(shape[-2:], generator=generator, device=dev) * scale)
        return out

    layers = {
        "attn_norm": torch.ones((l, d), dtype=dt, device=dev),
        "mlp_norm": torch.ones((l, d), dtype=dt, device=dev),
        "wq": w(l, d, h * dh),
        "wk": w(l, d, hkv * dh),
        "wv": w(l, d, hkv * dh),
        "wo": w(l, h * dh, d),
    }
    if cfg.moe:
        e = cfg.moe.n_experts
        layers.update(
            router=w(l, d, e, scale=d ** -0.5),
            we1=w(l, e, d, f),
            we3=w(l, e, d, f),
            we2=w(l, e, f, d, scale=f ** -0.5),
        )
    else:
        layers.update(
            w1=w(l, d, f),
            w3=w(l, d, f),
            w2=w(l, f, d, scale=f ** -0.5),
        )
    return {
        "embed": w(v, d, scale=1.0 / (d ** 0.5)),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
        "lm_head": w(d, v),
    }


def layer_stack(params: dict) -> list[dict]:
    """Every layer's weights: views into the stacked (L, ...) tensors by one
    `unbind` of each (whose backward stacks the L gradients once, where L
    separate views would each add a gradient of the whole stack)."""
    per_key = {k: t.unbind(0) for k, t in params["layers"].items()}
    return [dict(zip(per_key, views)) for views in zip(*per_key.values())]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layer(cfg: TransformerConfig, x, lp, positions, kv_cache=None, cache_len=None):
    h = L.rms_norm(x, lp["attn_norm"])
    attn_out, new_kv = L.gqa_attention(
        h, lp, n_heads=cfg.n_heads, n_kv=cfg.n_kv, positions=positions,
        rope_theta=cfg.rope_theta, kv_cache=kv_cache, cache_len=cache_len,
        use_flash=True,
    )
    x = x + attn_out
    h = L.rms_norm(x, lp["mlp_norm"])
    if cfg.moe:
        b, s, d = h.shape
        out, aux = moe_ffn(h.reshape(b * s, d), lp, cfg.moe)
        out = out.reshape(b, s, d)
    else:
        out, aux = L.swiglu(h, lp["w1"], lp["w3"], lp["w2"]), 0.0
    return x + out, new_kv, aux


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens (B, S) -> (logits (B, S, V_pad), aux_loss float32 scalar)."""
    b, s = tokens.shape
    dev = tokens.device
    x = kops.gather_rows(params["embed"], tokens).to(DTYPES[cfg.dtype])
    positions = torch.arange(s, device=dev).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    # remat only where a backward will follow (serving's forwards run as is)
    remat = cfg.remat and torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in params["layers"].values()))
    for lp in layer_stack(params):
        if remat:
            x, _, a = checkpoint(_layer, cfg, x, lp, positions, use_reentrant=False)
        else:
            x, _, a = _layer(cfg, x, lp, positions)
        aux = aux + a
    x = L.rms_norm(x, params["final_norm"])
    return x @ params["lm_head"], aux


def loss_fn(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Mean token cross-entropy over the real vocab, plus the weighted aux
    loss: a float32 scalar."""
    logits, aux = forward(params, tokens, cfg)
    if cfg.padded_vocab != cfg.vocab:
        # mask the padded vocab lanes out of the softmax
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
        logits = torch.where(pad, -1e30, logits)
    return L.cross_entropy(logits, labels) + cfg.aux_loss_weight * aux


# ---------------------------------------------------------------------------
# serving: prefill + decode with a static KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """k and v (L, B, n_kv, max_len, Dh), zero; `len` 0 (a Python int)."""
    dev = resolve_device(device)
    dt = dtype or DTYPES[cfg.dtype]
    shape = (cfg.n_layers, batch, cfg.n_kv, max_len, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev), "len": 0}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: TransformerConfig):
    """One serving step: tokens (B, S_new) written at cache['len'], for
    prefill (S_new = prompt) and decode (S_new = 1). Returns (logits of the
    last position (B, 1, V_pad), the new cache)."""
    b, s = tokens.shape
    dev = tokens.device
    x = kops.gather_rows(params["embed"], tokens).to(DTYPES[cfg.dtype])
    pos0 = cache["len"]
    positions = pos0 + torch.arange(s, device=dev).expand(b, s)
    nks, nvs = [], []
    for i, lp in enumerate(layer_stack(params)):
        x, (nk, nv), _ = _layer(cfg, x, lp, positions,
                                kv_cache=(cache["k"][i], cache["v"][i]), cache_len=pos0)
        nks.append(nk)
        nvs.append(nv)
    x = L.rms_norm(x, params["final_norm"])
    logits = x[:, -1:] @ params["lm_head"]
    return logits, {"k": torch.stack(nks), "v": torch.stack(nvs), "len": pos0 + s}
