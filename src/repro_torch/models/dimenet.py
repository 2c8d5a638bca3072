"""DimeNet (directional message passing), forward: the triplet-gather regime.

Port of `repro.models.dimenet` (arXiv:2003.03123 as the reference adapts
it): edge messages m_ji embedded from a radial basis of |r_ji|; interaction
blocks refresh m_ji from triplets (k->j->i) through a directional basis of
(d_kj, angle_kji), sin(n pi d / c)/d x cos(l theta) in place of the
spherical Bessel/Legendre basis, contracted by a bilinear layer; an output
block scatters edge messages to nodes and nodes to graphs. Triplets are
built on the host (`build_triplets`, numpy, as in the reference).

The three reductions, triplets -> edges, edges -> nodes and nodes -> graphs,
are the Combine stage's keyed sum (`core.acc.Combiner.segment`): a stable
sort of the ids, then `kernels.ops.segment_reduce`, the hand-written kernel
on the card. The edge and triplet gathers are `kernels.ops.gather_rows`,
whose backward is the deterministic scatter. `loss_fn` is the reference's
mean squared error.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.core.acc import SUM_AGG
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    d_in: int = 16           # node-type embedding size
    n_targets: int = 1
    t_per_edge: int = 8      # triplet cap for non-molecular graphs
    #: reduce the bilinear contraction one of the n_bilinear slices at a time
    #: instead of materializing (T, n_bilinear, d), for 10^8-scale T
    loop_bilinear: bool = False


def build_triplets(src: np.ndarray, dst: np.ndarray, n: int, cap: int):
    """Host-side triplet lists: for each edge e1=(j->i), incoming edges
    e2=(k->j), k != i, up to `cap` per edge. Returns (t_kj, t_ji) edge ids
    padded with m (sentinel)."""
    m = src.shape[0]
    in_edges: list[list[int]] = [[] for _ in range(n)]
    for e in range(m):
        in_edges[dst[e]].append(e)
    t_kj, t_ji = [], []
    for e1 in range(m):
        j, i = src[e1], dst[e1]
        cnt = 0
        for e2 in in_edges[j]:
            if src[e2] == i:
                continue
            t_kj.append(e2)
            t_ji.append(e1)
            cnt += 1
            if cnt >= cap:
                break
    if not t_kj:
        t_kj, t_ji = [m], [m]
    return np.asarray(t_kj, np.int32), np.asarray(t_ji, np.int32)


def radial_basis(d: torch.Tensor, n_radial: int, cutoff: float) -> torch.Tensor:
    """sin(n pi d/c)/d Bessel-type radial basis with a smooth cutoff envelope."""
    d = d.clamp_min(1e-3)
    nr = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    u = d[:, None] / cutoff
    env = torch.where(u < 1.0, (1 - u) ** 2 * (1 + 2 * u), 0.0)
    return env * torch.sin(nr[None, :] * math.pi * u) / u.clamp_min(1e-3)


def angular_basis(theta: torch.Tensor, n_spherical: int) -> torch.Tensor:
    order = torch.arange(n_spherical, dtype=torch.float32, device=theta.device)
    return torch.cos(order[None, :] * theta[:, None])


def init_params(cfg: DimeNetConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights in the reference's layout and scales, drawn from
    `generator`, which lives on `device`."""
    dev = resolve_device(device)
    d = cfg.d_hidden

    def w(*shape, scale=None):
        return torch.randn(shape, generator=generator, device=dev) * (scale or shape[-2] ** -0.5)

    p = {
        "atom_embed": w(cfg.d_in, d, scale=cfg.d_in ** -0.5),
        "rbf_embed": w(cfg.n_radial, d, scale=0.3),
        "msg_embed": w(3 * d, d),
        "blocks": [],
        "out_rbf": w(cfg.n_radial, d, scale=0.3),
        "out1": w(d, d),
        "out2": w(d, cfg.n_targets),
    }
    for _ in range(cfg.n_blocks):
        p["blocks"].append({
            "w_msg": w(d, d),
            "w_kj": w(d, d),
            "bilinear": w(cfg.n_radial * cfg.n_spherical, cfg.n_bilinear, d, scale=0.05),
            "w_bi_out": w(cfg.n_bilinear * d, d),
            "w_update": w(d, d),
            "rbf_gate": w(cfg.n_radial, d, scale=0.3),
        })
    return p


def forward(params, node_feat, pos, src, dst, t_kj, t_ji, cfg: DimeNetConfig,
            graph_ids=None, n_graphs: int = 1):
    """node_feat (N, d_in) one-hot-ish types; pos (N, 3); edges (j->i);
    t_kj, t_ji (T,) edge ids from `build_triplets`. Returns (n_graphs,
    n_targets)."""
    n = node_feat.shape[0]
    m = src.shape[0]
    d = cfg.d_hidden
    src_c = src.clamp_max(n - 1).long()
    dst_c = dst.clamp_max(n - 1).long()

    gather = kops.gather_rows
    rel = gather(pos, dst_c) - gather(pos, src_c)                 # (E, 3) r_ji
    dist = torch.linalg.vector_norm(rel + 1e-9, dim=-1)
    rbf = radial_basis(dist, cfg.n_radial, cfg.cutoff)            # (E, R)

    h = node_feat @ params["atom_embed"]                          # (N, d)
    e_in = torch.cat([gather(h, src_c), gather(h, dst_c), rbf @ params["rbf_embed"]], dim=-1)
    msg = F.silu(e_in @ params["msg_embed"])                      # (E, d)

    # triplet geometry: the angle between r_kj (edge e2) and r_ji (edge e1)
    tk = t_kj.clamp_max(m - 1).long()
    tj = t_ji.clamp_max(m - 1)
    valid = (t_kj < m)[:, None]
    v1 = gather(rel, tk)
    v2 = gather(rel, tj)
    cosang = (v1 * v2).sum(-1) / (torch.linalg.vector_norm(v1, dim=-1)
                                  * torch.linalg.vector_norm(v2, dim=-1)).clamp_min(1e-9)
    theta = torch.arccos(cosang.clamp(-1 + 1e-6, 1 - 1e-6))
    sbf = (gather(rbf, tk)[:, :, None] * angular_basis(theta, cfg.n_spherical)[:, None, :]
           ).reshape(-1, cfg.n_radial * cfg.n_spherical)          # (T, R*S)

    for blk in params["blocks"]:
        m_kj = F.silu(gather(msg, tk) @ blk["w_kj"])              # (T, d)
        if cfg.loop_bilinear:
            # one bilinear slice at a time: peak memory O(T*d), not O(T*B*d)
            parts = []
            for k in range(cfg.n_bilinear):
                tri_k = torch.where(valid, (sbf @ blk["bilinear"][:, k, :]) * m_kj, 0.0)
                parts.append(SUM_AGG.segment(tri_k, tj, m))
            agg = torch.stack(parts, dim=1).reshape(m, cfg.n_bilinear * d)
        else:
            # bilinear contraction: (T,RS) x (RS,B,d) x (T,d) -> (T, B, d)
            basis = torch.einsum("tb,bkd->tkd", sbf, blk["bilinear"])
            tri = torch.where(valid[:, :, None], basis * m_kj[:, None, :], 0.0)
            agg = SUM_AGG.segment(tri.reshape(-1, cfg.n_bilinear * d), tj, m)
        upd = F.silu(msg @ blk["w_msg"]) + agg @ blk["w_bi_out"]
        msg = msg + F.silu(upd @ blk["w_update"]) * (rbf @ blk["rbf_gate"])

    # output: edge -> node -> graph (raw dst, so sentinel-padded edges drop
    # into the scratch row rather than into node n-1)
    node_out = SUM_AGG.segment(msg * (rbf @ params["out_rbf"]), dst, n + 1)[:n]
    node_out = F.silu(node_out @ params["out1"])
    gi = graph_ids if graph_ids is not None else torch.zeros(
        (n,), dtype=torch.int32, device=node_feat.device)
    return SUM_AGG.segment(node_out, gi, n_graphs) @ params["out2"]


def loss_fn(params, node_feat, pos, src, dst, t_kj, t_ji, targets,
            cfg: DimeNetConfig, graph_ids=None, n_graphs: int = 1) -> torch.Tensor:
    """Mean squared error of the (n_graphs, n_targets) prediction."""
    pred = forward(params, node_feat, pos, src, dst, t_kj, t_ji, cfg, graph_ids, n_graphs)
    return ((pred - targets) ** 2).mean()
