"""GPipe-style pipeline parallelism over one mesh axis (the stage axis).

Port of `repro.distributed.pipeline` on the single-controller mesh
(`repro_torch.mesh.ServingMesh`): stage s runs on the device of position s
of the 'data' axis, the shards one after another in one process.

  * The (L, ...) layer stacks are padded to n_stages x layers_per_stage
    with identity layers (zero `wo`/`w2`, unit norms: residual
    passthrough); stage s holds layers [s * lps, (s + 1) * lps).
  * Forward (`fill_drain`, which `pipeline_tp` runs too): the fill-drain
    schedule, M micro-batches, S stages, M + S - 1 ticks; at tick t stage
    s runs micro t - s, stashes its input in bf16
    (the reference's stash, part of the numerics) and hands its output to
    stage s + 1. The last stage's forward output is handed to nobody (the
    reference sends it round the ring to stage 0, which ignores it), so it
    is not computed.
  * Backward: the reversed schedule. At tick t stage s takes micro
    (M - 1) - t + (S - 1 - s), recomputes its layers from the stash under
    `torch.enable_grad` (activation remat) and takes `torch.autograd.grad`
    with respect to its slab and its input; the last stage starts from the
    head loss's gradient, the others from their successor's input gradient
    of the tick before. Stage 0 scatters its input gradient into the
    embedding's (the deterministic scatter).
  * Layer gradients stay stage-local; the loss and the embed, head and
    final-norm gradients are summed over stages (only one stage holds
    each); micro-batches fold in micro order; everything is divided by M.

The reference leaves tensor parallelism on the 'model' axis to XLA inside
its stage `shard_map`; XLA's partitioning changes layouts, not values, so
here a stage computes unsplit on its 'model' position 0 (`pipeline_tp`
splits it by hand). Stage layers are `transformer._layer`, so attention at
S < 2048 is `kernels.ops.attention`: the flash forward and backward kernels
on the card. Dense LMs only, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import mesh as M
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as tfm
from repro_torch.nn import layers as L


@dataclasses.dataclass(frozen=True)
class PipeConfig:
    n_stages: int
    n_micro: int
    layers_per_stage: int


def plan(cfg: tfm.TransformerConfig, n_stages: int, n_micro: int) -> PipeConfig:
    lps = -(-cfg.n_layers // n_stages)
    return PipeConfig(n_stages=n_stages, n_micro=n_micro, layers_per_stage=lps)


def padded_layers(cfg: tfm.TransformerConfig, pc: PipeConfig) -> int:
    return pc.n_stages * pc.layers_per_stage


def pad_layer_stack(layers: dict, cfg: tfm.TransformerConfig, pc: PipeConfig) -> dict:
    """Pad the (L, ...) stacks with identity layers (zero wo/w2, unit norms)."""
    pad = padded_layers(cfg, pc) - cfg.n_layers
    if pad == 0:
        return dict(layers)

    def pad_one(name, x):
        fill = (torch.ones if name in ("attn_norm", "mlp_norm") else torch.zeros)(
            (pad,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        return torch.cat([x, fill], dim=0)

    return {k: pad_one(k, v) for k, v in layers.items()}


def param_logical_axes_pp(cfg: tfm.TransformerConfig) -> dict:
    """PP layout: the layer stacks over 'data' (the stage axis) on the stack
    dim plus TP on the usual dims; embed and head replicated across stages."""
    return {
        "embed": ("vocab", None),
        "final_norm": (None,),
        "lm_head": (None, "vocab"),
        "layers": {
            "attn_norm": ("fsdp", None),
            "mlp_norm": ("fsdp", None),
            "wq": ("fsdp", None, "heads"),
            "wk": ("fsdp", None, None),
            "wv": ("fsdp", None, None),
            "wo": ("fsdp", "heads", None),
            "w1": ("fsdp", None, "ff"),
            "w3": ("fsdp", None, "ff"),
            "w2": ("fsdp", "ff", None),
        },
    }


def leaves_of(slab: dict) -> dict:
    """Fresh leaves (sharing storage) that require a gradient."""
    return {k: v.detach().requires_grad_() for k, v in slab.items()}


def unbind_layers(slab: dict) -> list:
    per_key = {k: t.unbind(0) for k, t in slab.items()}
    return [dict(zip(per_key, views)) for views in zip(*per_key.values())]


def run_layers(fn, x, layer_params: list, remat: bool):
    """x through fn(x, lp) for each layer, each under `checkpoint` when
    `remat` and a gradient is being taken (the reference's per-layer
    `jax.checkpoint`)."""
    for lp in layer_params:
        if remat and torch.is_grad_enabled():
            x = checkpoint(fn, x, lp, use_reentrant=False)
        else:
            x = fn(x, lp)
    return x


def _stage_fn(cfg, slab: dict, x, positions):
    return run_layers(lambda h, lp: tfm._layer(cfg, h, lp, positions)[0], x,
                      unbind_layers(slab), cfg.remat)


def _head_loss_micro(cfg, y, head, fnorm, lbls):
    x = L.rms_norm(y, fnorm)
    logits = x @ head
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
        logits = torch.where(pad, -1e30, logits)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(lp, -1, lbls[..., None].long())[..., 0].mean()


def fill_drain(n_stages: int, n_micro: int, dt: torch.dtype, stage_devs: list,
               stage_leaves: list, stage_fwd, embed_fwd, embed_bwd, head_leaves: list,
               head_loss, stash_put, stash_get):
    """The fill-drain schedule both pipelines run, forward and backward.

    stage_fwd(s, x) -> y runs stage s; embed_fwd(mi) is micro mi's input to
    stage 0 and embed_bwd(mi, dx) takes its gradient; head_loss(y, mi) is
    micro mi's loss on the last stage's output, differentiated with respect
    to `head_leaves`. Stage s's input is stashed as stash_put(s, x) and, on
    its backward tick, stash_get(s, item) -> (x_in, wrt, join) rebuilds it
    under `torch.enable_grad`: the gradient is taken with respect to the
    tensors `wrt`, and join(their gradients) is the input gradient handed to
    stage s - 1. Returns (the loss summed over micros on the last stage's
    device, each stage's float32 gradients of `stage_leaves[s]`, the
    float32 gradients of `head_leaves`), summed over micros in micro order.
    """
    ticks = n_micro + n_stages - 1
    last = n_stages - 1

    # ---------------- forward fill-drain ---------------------------------
    stash = [[None] * n_micro for _ in range(n_stages)]
    act = [None] * n_stages
    with torch.no_grad():
        for t in range(ticks):
            nxt = [None] * n_stages
            for s in range(n_stages):
                mi = t - s
                if not 0 <= mi < n_micro:
                    continue
                x_in = embed_fwd(mi) if s == 0 else act[s]
                stash[s][mi] = stash_put(s, x_in)
                if s < last:
                    nxt[s + 1] = stage_fwd(s, x_in).to(stage_devs[s + 1])
            act = nxt

    # ---------------- backward, reversed fill-drain ----------------------
    f32 = lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    g_stage = [[f32(v) for v in leaves] for leaves in stage_leaves]
    g_head = [f32(v) for v in head_leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=stage_devs[last])
    dacc = [None] * n_stages
    for t in range(ticks):
        nxt = [None] * n_stages
        for s in range(n_stages):
            mi = (n_micro - 1) - t + (last - s)
            if not 0 <= mi < n_micro:
                continue
            leaves = stage_leaves[s]
            with torch.enable_grad():
                x_in, wrt, join = stash_get(s, stash[s][mi])
                y = stage_fwd(s, x_in)
                if s == last:
                    y_head = y.detach().requires_grad_()
                    loss_mi = head_loss(y_head, mi)
                    dy, *g_h = torch.autograd.grad(loss_mi, [y_head] + head_leaves)
                    dy = dy.to(dt)
                    for acc, g in zip(g_head, g_h):
                        acc += g.float()
                    loss_sum += loss_mi.detach()
                else:
                    dy = dacc[s]
                g_mi = torch.autograd.grad(y, leaves + wrt, dy)
                dx = join(g_mi[len(leaves):])
            for acc, g in zip(g_stage[s], g_mi[:len(leaves)]):
                acc += g.float()
            if s == 0:
                embed_bwd(mi, dx)
            else:
                nxt[s - 1] = dx.to(stage_devs[s - 1])
        dacc = nxt
    return loss_sum, g_stage, g_head


def pipeline_loss_and_grads(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
                            cfg: tfm.TransformerConfig, pc: PipeConfig, mesh):
    """tokens, labels (M, mb, seq) -> (loss, grads), float32, on the mesh's
    first device; grads shaped like the (padded) params. The stages run on
    the 'data' axis."""
    assert cfg.moe is None, "the pipeline path supports dense LMs"
    s_count, m_count = pc.n_stages, pc.n_micro
    if mesh.shape[M.DATA_AXIS] != s_count:
        raise ValueError(f"{s_count} stages on a 'data' axis of {mesh.shape[M.DATA_AXIS]}")
    lps = pc.layers_per_stage
    dt = tfm.DTYPES[cfg.dtype]
    devs = [mesh.device(s, 0) for s in range(s_count)]
    first, last = devs[0], devs[-1]
    mb, seq = tokens.shape[1:]
    keys = list(params["layers"])
    slabs = [leaves_of({k: params["layers"][k][s * lps:(s + 1) * lps].to(devs[s])
                        for k in keys}) for s in range(s_count)]
    positions = [torch.arange(seq, device=d).expand(mb, seq) for d in devs]
    embed = params["embed"].to(first)
    head = params["lm_head"].to(last).detach().requires_grad_()
    fnorm = params["final_norm"].to(last).detach().requires_grad_()
    toks, lbls = tokens.to(first), labels.to(last)
    g_embed = torch.zeros(embed.shape, dtype=torch.float32, device=first)

    def stash_get(s, item):
        x = item.to(dt).requires_grad_()
        return x, [x], lambda g: g[0]

    def embed_bwd(mi, dx):
        g_embed.add_(kops.scatter_rows(dx.reshape(-1, dx.shape[-1]).float(),
                                       toks[mi].reshape(-1), embed.shape[0]))

    loss_sum, g_stage, (g_head, g_fnorm) = fill_drain(
        s_count, m_count, dt, devs, [[slab[k] for k in keys] for slab in slabs],
        lambda s, x: _stage_fn(cfg, slabs[s], x, positions[s]),
        lambda mi: embed[toks[mi].long()].to(dt), embed_bwd, [head, fnorm],
        lambda y, mi: _head_loss_micro(cfg, y, head, fnorm, lbls[mi]),
        lambda s, x: x.to(torch.bfloat16), stash_get)

    out = mesh.device(0, 0)
    loss = loss_sum.to(out) / m_count
    layers = {k: torch.cat([g[i].to(out) for g in g_stage]) / m_count
              for i, k in enumerate(keys)}
    return loss, {"layers": layers, "embed": g_embed.to(out) / m_count,
                  "lm_head": g_head.to(out) / m_count,
                  "final_norm": g_fnorm.to(out) / m_count}
