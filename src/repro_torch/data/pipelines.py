"""Deterministic, checkpointable synthetic data pipelines.

Port of `repro.data.pipelines`, numpy as in the reference (the same
seeded draws, so every batch is bit-equal to the reference's); the caller
moves a batch to the device.

Every stream is (seed, step)-addressable: `state()` returns a tiny dict that
rides in the checkpoint manifest, and `restore()` resumes the exact stream —
the data-side half of fault tolerance.

  TokenStream  — zipfian LM tokens with local structure (bigram mixing) so a
                 ~100M model actually shows a falling loss in examples/.
  ClickStream  — recsys batches from a hidden logistic model over field
                 embeddings (DeepFM learns it).
  gnn_dataset  — full-batch GNN data: synthetic features/labels over a graph
                 with homophily (labels correlate across edges).
"""

from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.step = 0
        # fixed bigram transition "skeleton": tok -> (tok*a + b) % vocab
        r = np.random.default_rng(seed)
        self.a = int(r.integers(3, 31)) | 1
        self.b = int(r.integers(1, vocab))
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.p = (1.0 / ranks) / np.sum(1.0 / ranks)

    def __iter__(self):
        return self

    def __next__(self):
        r = np.random.default_rng((self.seed, self.step))
        self.step += 1
        first = r.choice(self.vocab, size=(self.batch, 1), p=self.p)
        toks = [first]
        prev = first
        for _ in range(self.seq):
            noise = r.choice(self.vocab, size=(self.batch, 1), p=self.p)
            follow = (prev * self.a + self.b) % self.vocab
            use_follow = r.random((self.batch, 1)) < 0.7
            nxt = np.where(use_follow, follow, noise)
            toks.append(nxt)
            prev = nxt
        seq = np.concatenate(toks, axis=1).astype(np.int32)  # (B, S+1)
        return seq[:, :-1], seq[:, 1:]

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def restore(self, st: dict):
        assert st["seed"] == self.seed
        self.step = int(st["step"])


class ClickStream:
    def __init__(self, n_fields: int, vocab_per_field: int, embed_dim: int,
                 batch: int, seed: int = 0):
        self.nf, self.v, self.batch, self.seed = n_fields, vocab_per_field, batch, seed
        self.step = 0
        r = np.random.default_rng(seed)
        self.true_emb = r.normal(0, 1.0, (n_fields, vocab_per_field)).astype(np.float32)
        ranks = np.arange(1, vocab_per_field + 1, dtype=np.float64)
        self.p = (1.0 / ranks) / np.sum(1.0 / ranks)

    def __next__(self):
        r = np.random.default_rng((self.seed, self.step))
        self.step += 1
        ids = np.stack(
            [r.choice(self.v, size=self.batch, p=self.p) for _ in range(self.nf)],
            axis=1,
        ).astype(np.int32)
        logit = self.true_emb[np.arange(self.nf)[None, :], ids].sum(axis=1) * 0.5
        y = (r.random(self.batch) < 1 / (1 + np.exp(-logit))).astype(np.float32)
        return ids, y

    def __iter__(self):
        return self

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def restore(self, st: dict):
        self.step = int(st["step"])


def gnn_dataset(n_nodes: int, src: np.ndarray, dst: np.ndarray, d_feat: int,
                n_classes: int, seed: int = 0, homophily: float = 0.8):
    """Synthetic node-classification data with label homophily (labels
    propagated over edges so GNNs beat MLPs)."""
    r = np.random.default_rng(seed)
    labels = r.integers(0, n_classes, n_nodes)
    for _ in range(3):  # label smoothing over edges
        flip = r.random(len(src)) < homophily
        labels[dst[flip]] = labels[src[flip]]
    centers = r.normal(0, 1.0, (n_classes, d_feat)).astype(np.float32)
    feats = centers[labels] + r.normal(0, 1.0, (n_nodes, d_feat)).astype(np.float32)
    mask = r.random(n_nodes) < 0.5
    return feats, labels.astype(np.int32), mask.astype(np.float32)
