"""GNN model zoo: GCN, GIN, GatedGCN, forward.

Port of `repro.models.gnn`. Message passing is the ACC Combine over an edge
index: every `jax.ops.segment_sum`/`segment_max` of the reference is the
Combine stage's keyed reduction (`core.acc.Combiner.segment`), which sorts
the edge ids stably and runs `kernels.ops.segment_reduce`, the hand-written
kernel on the card. Edges are (src, dst, w) arrays; sentinel ids (== n) drop
into a scratch row that is cut off. The gathers of node rows onto edges are
`kernels.ops.gather_rows`, whose backward is the deterministic scatter; the
Combine's backward is a gather. `loss_fn` is the reference's masked mean
negative log-likelihood. The reference's sharding hints, its per-layer
remat of GatedGCN (which changes memory, not values) and the edge-sharded
GatedGCN are the distributed slice's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.core.acc import MAX_VOTE, SUM_AGG
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                   # 'gcn' | 'gin' | 'gatedgcn'
    n_layers: int
    d_hidden: int
    d_in: int
    n_classes: int
    readout: str = "node"       # 'node' | 'graph'


# ---------------------------------------------------------------------------
# message passing primitive (ACC combine)
# ---------------------------------------------------------------------------


def aggregate(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              wgt: Optional[torch.Tensor], n: int, reduce: str = "sum") -> torch.Tensor:
    """out[i] = reduce_{(j->i) in E} w_ij * h[j]. Sentinel ids (== n) drop
    into the scratch row. h may be (N, D) or (N+1, D)."""
    hs = kops.gather_rows(h, src.clamp_max(h.shape[0] - 1))
    if wgt is not None:
        hs = hs * wgt[:, None]
    if reduce == "sum":
        out = SUM_AGG.segment(hs, dst, n + 1)
    elif reduce == "max":
        out = MAX_VOTE.segment(hs, dst, n + 1)
        out = torch.where(torch.isfinite(out), out, 0.0)
    elif reduce == "mean":
        s = SUM_AGG.segment(hs, dst, n + 1)
        c = SUM_AGG.segment(torch.ones(dst.shape, device=dst.device), dst, n + 1)
        out = s / c.clamp_min(1.0)[:, None]
    else:
        raise ValueError(reduce)
    return out[:n]


def gcn_norm_weights(src, dst, deg, n):
    """Symmetric normalization 1/sqrt(d_i d_j) (self-loops added upstream)."""
    d = deg.clamp_min(1.0)
    return torch.rsqrt(d[src.clamp_max(n - 1).long()] * d[dst.clamp_max(n - 1).long()])


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(cfg: GNNConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights in the reference's layout and scales (normal times
    fan_in^-0.5), drawn from `generator`, which lives on `device`."""
    dev = resolve_device(device)

    def dense(din, dout):
        return torch.randn((din, dout), generator=generator, device=dev) * din ** -0.5

    p: dict = {"layers": []}
    din = cfg.d_in
    for _ in range(cfg.n_layers):
        dout = cfg.d_hidden
        if cfg.kind == "gcn":
            lp = {"w": dense(din, dout), "b": torch.zeros((dout,), device=dev)}
        elif cfg.kind == "gin":
            lp = {"mlp1": dense(din, dout), "mlp2": dense(dout, dout),
                  "eps": torch.zeros((), device=dev), "norm": torch.ones((dout,), device=dev)}
        elif cfg.kind == "gatedgcn":
            lp = {k: dense(din, dout) for k in ("U", "V", "A", "B")}
            lp.update(C=dense(dout, dout), norm_h=torch.ones((dout,), device=dev),
                      norm_e=torch.ones((dout,), device=dev))
        else:
            raise ValueError(cfg.kind)
        p["layers"].append(lp)
        din = dout
    p["head"] = dense(din, cfg.n_classes)
    if cfg.kind == "gatedgcn":
        p["edge_embed"] = dense(1, cfg.d_hidden)
    return p


def _ln(x, g, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def forward(params, feats, src, dst, wgt, cfg: GNNConfig,
            graph_ids: Optional[torch.Tensor] = None, n_graphs: int = 1):
    """feats (N, d_in) -> logits: (N, C) node readout or (G, C) graph readout."""
    n = feats.shape[0]
    h = feats

    if cfg.kind == "gcn":
        deg = SUM_AGG.segment(torch.ones(dst.shape, device=dst.device), dst, n + 1)[:n]
        norm_w = gcn_norm_weights(src, dst, deg, n)
        if wgt is not None:
            norm_w = norm_w * wgt
        for lp in params["layers"]:
            msg = aggregate(h, src, dst, norm_w, n) + h  # +h = self loop
            h = torch.tanh(msg @ lp["w"] + lp["b"])

    elif cfg.kind == "gin":
        for lp in params["layers"]:
            agg = aggregate(h, src, dst, None, n, reduce="sum")
            z = (1.0 + lp["eps"]) * h + agg
            z = torch.relu(z @ lp["mlp1"]) @ lp["mlp2"]
            h = torch.relu(_ln(z, lp["norm"]))

    elif cfg.kind == "gatedgcn":
        e = wgt if wgt is not None else torch.ones(src.shape, device=src.device)
        e = e[:, None] @ params["edge_embed"]                     # (E, d)
        src_c = src.clamp_max(n - 1).long()
        dst_c = dst.clamp_max(n - 1).long()
        for lp in params["layers"]:
            hi, hj = kops.gather_rows(h, dst_c), kops.gather_rows(h, src_c)
            e_new = hi @ lp["A"] + hj @ lp["B"] + e @ lp["C"]
            eta = torch.sigmoid(e_new)
            num = aggregate(eta * (hj @ lp["V"]), src, dst, None, n)
            den = aggregate(eta, src, dst, None, n) + 1e-6
            h_new = h @ lp["U"] + num / den
            h2 = torch.relu(_ln(h_new, lp["norm_h"]))
            h = h + h2 if h.shape == h_new.shape else h2
            e = e + torch.relu(_ln(e_new, lp["norm_e"]))
    else:
        raise ValueError(cfg.kind)

    if cfg.readout == "graph":
        gi = graph_ids if graph_ids is not None else torch.zeros(
            (n,), dtype=torch.int32, device=feats.device)
        return SUM_AGG.segment(h, gi, n_graphs) @ params["head"]
    return h @ params["head"]


def loss_fn(params, feats, src, dst, wgt, labels, cfg: GNNConfig,
            mask=None, graph_ids=None, n_graphs: int = 1) -> torch.Tensor:
    """Mean negative log-likelihood of `labels` (over the nodes where `mask`
    is 1, when given), a float32 scalar."""
    logits = forward(params, feats, src, dst, wgt, cfg, graph_ids, n_graphs)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
