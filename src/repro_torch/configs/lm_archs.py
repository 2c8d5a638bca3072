"""Assigned LM-family transformer configs (published numbers), as in
`repro.configs.lm_archs`.

minitron-4b           [arXiv:2407.14679; hf]      pruned nemotron
granite-3-8b          [hf:ibm-granite/granite-3.0-2b-base; hf]
llama3-405b           [arXiv:2407.21783; unverified]
moonshot-v1-16b-a3b   [hf:moonshotai/Moonlight-16B-A3B; hf]   MoE 64e top-6
granite-moe-1b-a400m  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf] 32e top-8
"""

from __future__ import annotations

from repro_torch.configs.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import TransformerConfig
from repro_torch.nn.moe import MoEConfig


def _reduced_dense():
    return TransformerConfig(
        "reduced-dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_ff=128, vocab=512, head_dim=16,
    )


def _reduced_moe(top_k=2):
    return TransformerConfig(
        "reduced-moe", n_layers=2, d_model=64, n_heads=4, n_kv=4,
        d_ff=64, vocab=512, head_dim=16, moe=MoEConfig(8, top_k),
    )


register(ArchSpec(
    name="minitron-4b",
    family="lm",
    make_config=lambda: TransformerConfig(
        "minitron-4b", n_layers=32, d_model=3072, n_heads=24, n_kv=8,
        d_ff=9216, vocab=256000, head_dim=128, dtype="bfloat16",
    ),
    make_reduced=_reduced_dense,
    shapes=LM_SHAPES,
    notes="dense GQA, 256k vocab (vocab-sharded embedding dominates)",
))

register(ArchSpec(
    name="granite-3-8b",
    family="lm",
    make_config=lambda: TransformerConfig(
        "granite-3-8b", n_layers=40, d_model=4096, n_heads=32, n_kv=8,
        d_ff=12800, vocab=49155, head_dim=128, dtype="bfloat16",
    ),
    make_reduced=_reduced_dense,
    shapes=LM_SHAPES,
))

register(ArchSpec(
    name="llama3-405b",
    family="lm",
    make_config=lambda: TransformerConfig(
        "llama3-405b", n_layers=126, d_model=16384, n_heads=128, n_kv=8,
        d_ff=53248, vocab=128256, head_dim=128, dtype="bfloat16",
    ),
    make_reduced=_reduced_dense,
    shapes=LM_SHAPES,
    notes="does not fit 256 v5e with f32 moments: ZeRO-3 + bf16 moments "
          "(DESIGN.md §5); microbatched grad accumulation",
))

register(ArchSpec(
    name="moonshot-v1-16b-a3b",
    family="lm",
    make_config=lambda: TransformerConfig(
        "moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16, n_kv=16,
        d_ff=1408, vocab=163840, head_dim=128, dtype="bfloat16",
        moe=MoEConfig(n_experts=64, top_k=6),
    ),
    make_reduced=lambda: _reduced_moe(top_k=2),
    shapes=LM_SHAPES,
    notes="MoE 64e top-6 (EP over 'model'); capacity dispatch = bounded-bin "
          "analogue of the paper's online filter overflow",
))

register(ArchSpec(
    name="granite-moe-1b-a400m",
    family="lm",
    make_config=lambda: TransformerConfig(
        "granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16, n_kv=8,
        d_ff=512, vocab=49155, head_dim=64, dtype="bfloat16",
        moe=MoEConfig(n_experts=32, top_k=8),
    ),
    make_reduced=lambda: _reduced_moe(top_k=2),
    shapes=LM_SHAPES,
))
