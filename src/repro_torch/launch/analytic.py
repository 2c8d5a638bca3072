"""Analytic per-cell FLOP and HBM-traffic models of the LM cells.

The port's own copy of `repro.launch.analytic` (the port imports nothing of
the reference), on `repro_torch.models.transformer.TransformerConfig`; the
formulas are the reference's, term for term.

Why the reference has them: XLA's cost analysis counts a `scan` body once,
so its LM cells' compiled flops and bytes under-report by ~L x accum. The
port counts eager runs, which have no such undercount (`launch.cost`), and
keeps these models as the reference does: the dry-run's compute and memory
terms of an LM cell come from them, so the two packages' rooflines compare
cell for cell, and the port's counted flops stand beside them in the
record.

All byte numbers are PER DEVICE; flops are GLOBAL (divide by chips).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import TransformerConfig

BF16 = 2
F32 = 4


@dataclasses.dataclass(frozen=True)
class LmCellModel:
    flops_global: float
    bytes_per_device: float
    detail: dict


def _param_counts(cfg: TransformerConfig):
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.dh
    attn = d * cfg.n_heads * dh * 2 + d * cfg.n_kv * dh * 2
    if cfg.moe:
        ffn_total = 3 * d * f * cfg.moe.n_experts + d * cfg.moe.n_experts
        ffn_active = 3 * d * f * cfg.moe.top_k + d * cfg.moe.n_experts
    else:
        ffn_total = ffn_active = 3 * d * f
    embed = 2 * cfg.padded_vocab * d
    total = cfg.n_layers * (attn + ffn_total + 2 * d) + embed + d
    active = cfg.n_layers * (attn + ffn_active + 2 * d) + embed + d
    return total, active


def lm_train(cfg: TransformerConfig, batch: int, seq: int, accum: int,
             dp: int, tp: int, moment_bytes: int = 4) -> LmCellModel:
    chips = dp * tp
    tokens = batch * seq
    n_total, n_active = _param_counts(cfg)
    # --- flops (global): fwd+bwd = 3x2x params-touched x tokens + attention
    flops_mm = 6.0 * n_active * tokens
    flops_attn = 6.0 * batch * cfg.n_layers * cfg.n_heads * cfg.dh * seq ** 2
    # remat recompute: one extra forward
    flops_remat = 2.0 * n_active * tokens + flops_attn / 3.0
    flops = flops_mm + flops_attn + flops_remat

    # --- HBM bytes per device
    p_dev = n_total * BF16 / chips          # ZeRO-3 + TP fully shards params
    g_dev = n_total * F32 / chips           # f32 grad accumulator
    micro_tokens = tokens // accum
    t_loc = micro_tokens / dp               # tokens per device per micro
    d = cfg.d_model
    act_ckpt = cfg.n_layers * t_loc * d * BF16        # layer-boundary saves
    # per-layer working traffic (x, attn io, ff intermediate) per micro
    f_eff = (cfg.d_ff * cfg.moe.top_k if cfg.moe else cfg.d_ff) / tp
    layer_traffic = cfg.n_layers * t_loc * (8 * d + 4 * f_eff) * BF16
    logits = 3 * t_loc * cfg.padded_vocab / tp * BF16
    per_micro = (
        3 * p_dev               # fwd read + bwd read + remat read
        + 2 * g_dev             # grad accumulate read+write
        + 2 * act_ckpt          # write + read checkpoints
        + 2 * layer_traffic     # fwd + bwd
        + logits
    )
    opt = 2 * p_dev + g_dev + 4 * (n_total * moment_bytes / chips)
    bytes_dev = accum * per_micro + opt
    return LmCellModel(
        flops_global=flops,
        bytes_per_device=bytes_dev,
        detail=dict(flops_mm=flops_mm, flops_attn=flops_attn,
                    flops_remat=flops_remat, p_dev=p_dev,
                    per_micro=per_micro, opt=opt, accum=accum),
    )


def lm_prefill(cfg: TransformerConfig, batch: int, seq: int,
               dp: int, tp: int, kv_chunk: int = 1024) -> LmCellModel:
    chips = dp * tp
    tokens = batch * seq
    n_total, n_active = _param_counts(cfg)
    flops = (2.0 * n_active * tokens
             + 2.0 * batch * cfg.n_layers * cfg.n_heads * cfg.dh * seq ** 2)
    p_dev = n_total * BF16 / chips
    b_loc = max(batch // dp, 1)
    kv_layer = b_loc * seq * cfg.n_kv * cfg.dh * 2 * BF16   # K+V per layer
    nq = max(seq // kv_chunk, 1)
    d = cfg.d_model
    f_eff = (cfg.d_ff * cfg.moe.top_k if cfg.moe else cfg.d_ff) / tp
    t_loc = b_loc * seq
    layer_traffic = cfg.n_layers * t_loc * (8 * d + 2 * f_eff) * BF16
    # chunked attention re-reads the K/V stream once per q-chunk
    attn_traffic = cfg.n_layers * kv_layer * (nq / 2 + 1)   # causal ~half
    cache_write = cfg.n_layers * kv_layer / tp              # seq-sharded cache
    logits = b_loc * cfg.padded_vocab / tp * BF16
    bytes_dev = p_dev + layer_traffic + attn_traffic + cache_write + logits
    return LmCellModel(flops, bytes_dev,
                       dict(p_dev=p_dev, attn_traffic=attn_traffic,
                            layer_traffic=layer_traffic, nq=nq))


def lm_decode(cfg: TransformerConfig, batch: int, seq: int,
              dp: int, tp: int) -> LmCellModel:
    """One token per sequence against a seq-long cache."""
    chips = dp * tp
    n_total, n_active = _param_counts(cfg)
    flops = (2.0 * n_active * batch
             + 4.0 * batch * cfg.n_layers * cfg.n_heads * cfg.dh * seq)
    p_dev = n_total * BF16 / chips
    kv_total = batch * seq * cfg.n_kv * cfg.dh * 2 * BF16 * cfg.n_layers
    kv_dev = kv_total / chips               # batch x 'data', seq x 'model'
    d = cfg.d_model
    t_loc = max(batch // dp, 1)
    layer_traffic = cfg.n_layers * t_loc * (8 * d) * BF16
    logits = t_loc * cfg.padded_vocab / tp * BF16
    bytes_dev = p_dev + kv_dev + layer_traffic + logits
    return LmCellModel(flops, bytes_dev,
                       dict(p_dev=p_dev, kv_dev=kv_dev))


def lm_cell(cfg: TransformerConfig, kind: str, batch: int, seq: int,
            dp: int, tp: int, accum: int = 1,
            moment_bytes: int = 4) -> LmCellModel:
    if kind == "train":
        return lm_train(cfg, batch, seq, accum, dp, tp, moment_bytes)
    if kind == "prefill":
        return lm_prefill(cfg, batch, seq, dp, tp)
    return lm_decode(cfg, batch, seq, dp, tp)
