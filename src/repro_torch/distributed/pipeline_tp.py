"""Pipeline parallelism with manual tensor parallelism.

Port of `repro.distributed.pipeline_tp` on the single-controller mesh: the
stage axis ('data') runs `pipeline`'s fill-drain schedule, and inside each
stage the 'model' axis is Megatron TP placed by hand:

  * model rank r owns query heads [r * H / tp, (r + 1) * H / tp) (group-
    major GQA: query head h reads kv head h % Hkv, so each rank's heads see
    every kv head and `wk`/`wv` are replicated), `wo`'s matching rows, and
    a 1/tp slice of the FFN (`w1`/`w3` columns, `w2` rows); the norms are
    replicated;
  * one sum over the ranks after `wo` and one after `w2` (folded in rank
    order on the stage's first device, `mesh.reduce_to`), the residual
    stream replicated;
  * the embedding is vocab-sharded (each rank gathers the ids in its slice,
    the rows summed over ranks) and so is the loss: the log-sum-exp over
    vocab slices with the max of a detached copy (the reference's `pmax` of
    a stop-gradient), the gold logit summed over ranks;
  * each rank stashes its 1/tp sequence slice of a stage's input in bf16,
    and the backward tick gathers the slices back; the gradient is taken
    with respect to those bf16 slices, so the input gradient handed to the
    stage before (and scattered into the embedding's) is rounded to bf16,
    as in the reference.

The parameters are cut by `param_logical_axes_pp` through
`sharding.tree_shard`. In one process the TP sum is a differentiable sum
and broadcast, so autograd places its transpose: each rank's copy of a
replicated parameter (`wk`, `wv`, the norms, the final norm) gets its own
partial gradient, and those are summed over ranks once, in rank order. The
reference carries explicit cotangent conventions for that (its
`compat.HAS_VMA` branches); they have no counterpart here. The reference
calls `attention_ref` below S = 2048; the port's `gqa_attention` calls
`kernels.ops.attention` (the flash kernels on the card), as its transformer
does.
"""

from __future__ import annotations

import torch

from repro_torch import mesh as M
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.pipeline import (  # noqa: F401
    PipeConfig, fill_drain, leaves_of, pad_layer_stack, param_logical_axes_pp, plan,
    run_layers, unbind_layers)
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as tfm
from repro_torch.nn import layers as L

#: the layer weights replicated over the 'model' axis
REPLICATED = ("attn_norm", "mlp_norm", "wk", "wv")


def _embed_fwd(embeds, ids, dt, devs):
    """Vocab-sharded embedding gather: each rank's masked rows, summed."""
    rows = []
    for r, (emb, dev) in enumerate(zip(embeds, devs)):
        vsh = emb.shape[0]
        loc = ids.to(dev).long() - r * vsh
        inb = (loc >= 0) & (loc < vsh)
        rows.append(torch.where(inb[..., None], emb[loc.clamp(0, vsh - 1)], 0))
    return M.reduce_to(rows, "sum", devs[0]).to(dt)


def _layer_fwd(cfg, x, lps: list, positions: list, devs: list):
    """One layer, manual Megatron TP: lps[r] holds rank r's local shards."""
    h_loc = lps[0]["wq"].shape[-1] // cfg.dh
    parts = []
    for lp, pos, dev in zip(lps, positions, devs):
        out, _ = L.gqa_attention(L.rms_norm(x.to(dev), lp["attn_norm"]), lp, n_heads=h_loc,
                                 n_kv=cfg.n_kv, positions=pos, rope_theta=cfg.rope_theta,
                                 use_flash=True)
        parts.append(out)
    x = x + M.reduce_to(parts, "sum", devs[0])
    parts = [L.swiglu(L.rms_norm(x.to(dev), lp["mlp_norm"]), lp["w1"], lp["w3"], lp["w2"])
             for lp, dev in zip(lps, devs)]
    return x + M.reduce_to(parts, "sum", devs[0])


def _stage_fwd(cfg, slabs: list, x, positions, devs):
    per_rank = [unbind_layers(slab) for slab in slabs]
    layers = [list(lps) for lps in zip(*per_rank)]
    return run_layers(lambda h, lps: _layer_fwd(cfg, h, lps, positions, devs), x, layers,
                      cfg.remat)


def _head_loss(cfg, y, heads, fnorms, lbls, devs):
    """Vocab-sharded cross entropy (the log-sum-exp over slices, its max
    shift taken from a detached copy)."""
    vsh = heads[0].shape[-1]
    logits, golds = [], []
    for r, (hd, fn, dev) in enumerate(zip(heads, fnorms, devs)):
        lg = (L.rms_norm(y.to(dev), fn) @ hd).float()
        col = r * vsh + torch.arange(vsh, device=dev)
        lg = torch.where(col < cfg.vocab, lg, -1e30)
        loc = lbls.to(dev).long() - r * vsh
        inb = (loc >= 0) & (loc < vsh)
        gold = torch.gather(lg, -1, loc.clamp(0, vsh - 1)[..., None])[..., 0]
        logits.append(lg)
        golds.append(torch.where(inb, gold, 0.0))
    m = M.reduce_to([lg.detach().amax(dim=-1) for lg in logits], "max", devs[0])
    z = M.reduce_to([torch.exp(lg - m.to(lg.device)[..., None]).sum(dim=-1) for lg in logits],
                    "sum", devs[0])
    lse = m + torch.log(z)
    return (lse - M.reduce_to(golds, "sum", devs[0])).mean()


def pipeline_tp_loss_and_grads(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
                               cfg: tfm.TransformerConfig, pc: PipeConfig, mesh):
    """tokens, labels (M, mb, seq) -> (loss, grads), float32, on the mesh's
    first device; grads shaped like the (padded) params. The stages run on
    the 'data' axis and TP on 'model' (`param_logical_axes_pp`)."""
    assert cfg.moe is None
    s_count, m_count = pc.n_stages, pc.n_micro
    tp = mesh.shape[M.MODEL_AXIS]
    if mesh.shape[M.DATA_AXIS] != s_count:
        raise ValueError(f"{s_count} stages on a 'data' axis of {mesh.shape[M.DATA_AXIS]}")
    h_loc = cfg.n_heads // tp
    if cfg.n_heads % tp or (tp > 1 and h_loc % cfg.n_kv):
        raise ValueError(f"{cfg.n_heads} heads over tp={tp}: each rank needs whole kv groups")
    dt = tfm.DTYPES[cfg.dtype]
    mb, seq = tokens.shape[1:]
    if seq % tp:
        raise ValueError(f"seq {seq} does not split over tp={tp}")
    s_loc = seq // tp
    axes = param_logical_axes_pp(cfg)
    grid = sh.tree_shard(mesh, params, axes)
    devs = [[mesh.device(s, r) for r in range(tp)] for s in range(s_count)]
    keys = list(params["layers"])
    slabs = [[leaves_of({k: grid["layers"][k][s][r] for k in keys}) for r in range(tp)]
             for s in range(s_count)]
    embeds = grid["embed"][0]
    last = s_count - 1
    heads = [t.detach().requires_grad_() for t in grid["lm_head"][last]]
    fnorms = [t.detach().requires_grad_() for t in grid["final_norm"][last]]
    positions = [[torch.arange(seq, device=d).expand(mb, seq) for d in row] for row in devs]
    g_embed = [torch.zeros(e.shape, dtype=torch.float32, device=e.device) for e in embeds]

    def stash_put(s, x):
        """Each rank's seq slice of the stage's input only, in bf16."""
        return [x[:, r * s_loc:(r + 1) * s_loc].to(devs[s][r], torch.bfloat16)
                for r in range(tp)]

    def stash_get(s, slices):
        # the gradient is taken with respect to the bf16 slices, as the
        # reference's vjp is: the input gradient comes back in bf16
        slices = [x.requires_grad_() for x in slices]
        gather = lambda xs: torch.cat([x.to(devs[s][0]) for x in xs], dim=1).to(dt)
        return gather(slices), slices, gather

    def embed_bwd(mi, dx):
        ids = tokens[mi].reshape(-1)
        for r, ge in enumerate(g_embed):
            vsh = ge.shape[0]
            loc = ids.to(ge.device).long() - r * vsh
            inb = (loc >= 0) & (loc < vsh)
            ge += kops.scatter_rows(dx.reshape(-1, dx.shape[-1]).to(ge.device).float(),
                                    torch.where(inb, loc, vsh), vsh)

    loss_sum, g_stage, g_hf = fill_drain(
        s_count, m_count, dt, [row[0] for row in devs],
        [[slab[k] for slab in row for k in keys] for row in slabs],
        lambda s, x: _stage_fwd(cfg, slabs[s], x, positions[s], devs[s]),
        lambda mi: _embed_fwd(embeds, tokens[mi], dt, devs[0]), embed_bwd, heads + fnorms,
        lambda y, mi: _head_loss(cfg, y, heads, fnorms, labels[mi], devs[last]),
        stash_put, stash_get)
    g_head, g_fnorm = g_hf[:tp], g_hf[tp:]
    g_slab = [[dict(zip(keys, row[r * len(keys):(r + 1) * len(keys)])) for r in range(tp)]
              for row in g_stage]

    # replicated weights: each rank's partial gradient, summed once in rank order
    for row in g_slab:
        for k in REPLICATED:
            total = M.reduce_to([g[k] for g in row], "sum")
            for g in row:
                g[k] = total.to(g[k].device)
    total = M.reduce_to(g_fnorm, "sum")
    out = mesh.device(0, 0)
    grads = sh.unshard(mesh, [[total.to(d) for d in row] for row in devs],
                       *axes["final_norm"])
    g_tree = {
        "layers": {k: sh.unshard(mesh, [[g_slab[s][r][k] for r in range(tp)]
                                        for s in range(s_count)], *axes["layers"][k])
                   for k in keys},
        "embed": sh.unshard(mesh, [g_embed] * s_count, *axes["embed"]),
        "lm_head": sh.unshard(mesh, [g_head] * s_count, *axes["lm_head"]),
        "final_norm": grads,
    }
    g_tree = {k: ({kk: vv / m_count for kk, vv in v.items()} if isinstance(v, dict)
                  else v / m_count) for k, v in g_tree.items()}
    return loss_sum.to(out) / m_count, g_tree
