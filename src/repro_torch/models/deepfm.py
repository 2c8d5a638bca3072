"""DeepFM (arXiv:1703.04247): FM interaction + deep MLP over shared embeddings.

Port of `repro.models.deepfm`, forward and retrieval scoring. Assigned
config: 39 sparse fields, embed_dim 10, MLP 400-400-400. One table of
(sum of the per-field vocabs) x embed_dim rows; field f's id i reads row
f * vocab_per_field + i.

The sums over a sample's fields (the reference's `emb.sum(axis=1)` and
`linear[gids].sum(axis=1)`) and the pooled user vector (`.mean(axis=1)`)
are bags of the 39 rows, so they run on `kernels.ops.embedding_bag`, the
hand-written kernel on the card. The (B, F, D) gather that the squared FM
term and the MLP read is `kernels.ops.gather_rows`. Both carry the table's
gradient by the deterministic scatter (sorted ids, `segment_reduce`).
`loss_fn` is the reference's clipped-logit binary cross-entropy.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str
    n_fields: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 100_000
    mlp: tuple = (400, 400, 400)

    @property
    def total_vocab(self) -> int:
        return self.n_fields * self.vocab_per_field


def init_params(cfg: DeepFMConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights in the reference's layout and scales, drawn from
    `generator`, which lives on `device`."""
    dev = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    p = {
        "table": normal(cfg.total_vocab, cfg.embed_dim) * 0.01,
        "linear": normal(cfg.total_vocab) * 0.01,
        "bias": torch.zeros((), device=dev),
        "mlp": [],
    }
    din = cfg.n_fields * cfg.embed_dim
    for width in cfg.mlp:
        p["mlp"].append({"w": normal(din, width) * din ** -0.5,
                         "b": torch.zeros((width,), device=dev)})
        din = width
    p["mlp_out"] = normal(din) * din ** -0.5
    return p


def _global_ids(ids: torch.Tensor, cfg: DeepFMConfig) -> torch.Tensor:
    """(B, n_fields) per-field ids -> int32 rows of the shared table."""
    offsets = torch.arange(cfg.n_fields, dtype=torch.int32, device=ids.device)
    return (ids.to(torch.int32) + offsets * cfg.vocab_per_field).contiguous()


def forward(params: dict, ids: torch.Tensor, cfg: DeepFMConfig) -> torch.Tensor:
    """ids (B, n_fields) per-field categorical ids -> logits (B,)."""
    gids = _global_ids(ids, cfg)
    emb = kops.gather_rows(params["table"], gids)        # (B, F, D)

    # FM second order: 0.5 * ((sum_f v)^2 - sum_f v^2), summed over D
    s = kops.embedding_bag(params["table"], gids, "sum")
    fm = 0.5 * (s.square() - emb.square().sum(dim=1)).sum(dim=-1)

    lin = kops.embedding_bag(params["linear"].view(-1, 1), gids, "sum")[:, 0] \
        + params["bias"]

    h = emb.reshape(ids.shape[0], -1)
    for lp in params["mlp"]:
        h = torch.relu(h @ lp["w"] + lp["b"])
    deep = h @ params["mlp_out"]
    return lin + fm + deep


def loss_fn(params: dict, ids: torch.Tensor, labels: torch.Tensor,
            cfg: DeepFMConfig) -> torch.Tensor:
    """Mean binary cross-entropy of the logits clipped to [-30, 30]."""
    z = forward(params, ids, cfg).clamp(-30, 30)
    return (z.clamp_min(0) - z * labels + torch.log1p(torch.exp(-z.abs()))).mean()


# ---------------------------------------------------------------------------
# retrieval scoring: one query against n_candidates item vectors
# ---------------------------------------------------------------------------


def user_vector(params: dict, ids: torch.Tensor, cfg: DeepFMConfig) -> torch.Tensor:
    """Pooled user-side embedding (B, D): the mean of each sample's rows."""
    return kops.embedding_bag(params["table"], _global_ids(ids, cfg), "mean")


def score_candidates(user_vec: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """user_vec (B, D) x cand (N_cand, D) -> (B, N_cand) by one matmul."""
    return user_vec @ cand.T
