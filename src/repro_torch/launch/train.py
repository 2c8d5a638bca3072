"""Training launcher of the port: for now only `tiny_config`, which the serve
launcher uses (`repro.launch.train.tiny_config`). The training loop itself
(optimizer, data, checkpoints, fault handling) is a later slice."""

from __future__ import annotations

import dataclasses

from repro_torch.models import transformer as tfm


def tiny_config(base: tfm.TransformerConfig, d_model=256, n_layers=4,
                vocab=2048) -> tfm.TransformerConfig:
    """Scale an assigned config down for CPU execution, preserving family
    (GQA ratio, MoE-ness)."""
    moe = base.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=min(moe.n_experts, 8),
                                  top_k=min(moe.top_k, 2))
    return dataclasses.replace(
        base, d_model=d_model, n_layers=n_layers,
        n_heads=max(4, d_model // 64), n_kv=max(2, d_model // 128),
        head_dim=64, d_ff=d_model * 4 if moe is None else d_model,
        vocab=vocab, moe=moe, dtype="float32",
    )
