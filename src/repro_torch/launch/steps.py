"""Step builders: (arch x shape x mesh) -> the step, its inputs and their
placement.

Port of `repro.launch.steps`, the glue of the dry-run. For every cell a
builder gives

  * `fn`, the step as the port runs it on one device: a train step
    (`loss_fn`, `torch.autograd.grad`, `adamw.update` in place) or a serve
    step. Where the reference scans (the LM train step's micro-batches,
    `lax.scan`), the port loops in Python: gradients of each micro-batch
    are added into float32 accumulators, then divided by their count. The
    variants run the port's mesh paths: `pp` the GPipe pipeline with manual
    TP (`distributed.pipeline_tp`), `edgeshard` the edge-sharded GatedGCN
    (`models.gnn.make_edgesharded_gatedgcn`), `splitkv` split-KV decode
    (`nn.decode_attn`), each on the mesh's ('data', 'model') grid;
  * `make_inputs(device, seed)`, every input of `fn` drawn from a seeded
    generator on `device`: on `meta` (the default) these are the abstract
    inputs, shapes and dtypes with no data, params and optimizer state
    included (`init_params(cfg, generator, device="meta")`);
  * `in_shardings` / `out_shardings`: trees of partition entries
    (`distributed.sharding.spec` on the given mesh) beside the inputs and
    outputs; `None` for a whole tree is replicated;
  * `model_flops`, `note`, `skip`/`skip_reason` and `analytic` as the
    reference gives them.

Families: LM train (ZeRO-3, or `zero1`) and `pp`, LM prefill/decode (static
KV cache, seq-sharded over 'model') and `splitkv`, GNN full-graph
(edge-sharded) and `edgeshard`, GNN sampled (the fanout sampler on the
device), DimeNet (triplet inputs), recsys (row-sharded embedding). No step
reads a value back to the host, so every one runs on `meta`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch._device import resolve_device
from repro_torch.configs.registry import ArchSpec
from repro_torch.distributed import sharding as sh
from repro_torch.graph.csr import CSR
from repro_torch.graph.sampler import sample_block
from repro_torch.launch.analytic import lm_cell
from repro_torch.models import deepfm as dfm
from repro_torch.models import dimenet as dmn
from repro_torch.models import gnn as gnn_m
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw


@dataclasses.dataclass
class BuiltStep:
    name: str
    kind: str                        # 'train' | 'prefill' | 'decode' | 'infer' | 'retrieval'
    fn: Callable                     # the step function
    make_inputs: Callable            # (device="meta", seed=0) -> the positional inputs
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()
    model_flops: float = 0.0         # 6·N·D (dense) / 6·N_active·D (MoE) etc.
    note: str = ""
    skip: bool = False
    skip_reason: str = ""
    #: analytic (flops_global, bytes_per_device) of the LM cells
    #: (`launch.analytic`)
    analytic: Optional[dict] = None

    @property
    def abstract_inputs(self) -> tuple:
        """The inputs on `meta`."""
        return self.make_inputs("meta")


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    """A generator for draws on `dev` (a CPU one for meta draws)."""
    return torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(seed)


def _ints(gen, dev, high: int, shape, low: int = 0) -> torch.Tensor:
    return torch.randint(low, high, shape, generator=gen, device=dev, dtype=torch.int32)


def _normal(gen, dev, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=dev)


def _specs(mesh, logical_tree):
    """A tree of logical tuples -> the tree of their partition entries."""
    return _map_axes(lambda ax: sh.spec(mesh, *ax), logical_tree)


def _grid(mesh):
    """The ('data', 'model') grid a mesh path runs on: a production mesh's
    meta grid (`launch.mesh`), or a local mesh itself."""
    return mesh.grid() if hasattr(mesh, "grid") else mesh


def _dp_total(mesh) -> int:
    return mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)


def _requires_grad(params):
    for leaf in T.leaves(params):
        leaf.requires_grad_()
    return params


def _apply(params, opt_state, grads, opt_cfg, loss):
    new_p, new_o, metrics = adamw.update(grads, opt_state, params, opt_cfg)
    metrics["loss"] = loss
    return new_p, new_o, metrics


def _grads(loss, params):
    g = torch.autograd.grad(loss, T.leaves(params), allow_unused=True, materialize_grads=True)
    return T.unflatten(params, list(g))


# ===========================================================================
# LM family
# ===========================================================================


def _lm_opt_cfg(cfg: tfm.TransformerConfig) -> adamw.AdamWConfig:
    big = cfg.param_count() > 2e10
    return adamw.AdamWConfig(
        moment_dtype="bfloat16" if big else "float32",
        total_steps=100_000,
    )


def _lm_flops_train(cfg, batch: int, seq: int) -> float:
    return (6.0 * cfg.active_param_count() * batch * seq
            + 6.0 * batch * cfg.n_layers * cfg.n_heads * cfg.dh * seq ** 2)


def build_lm_train(spec: ArchSpec, shape: dict, mesh, zero_stage: int = 3) -> BuiltStep:
    """zero_stage=3: params+grads+moments fsdp-sharded over 'data'.
    zero_stage=1: params TP-sharded only; optimizer states stay
    data-sharded."""
    cfg = spec.make_config()
    batch, seq = shape["batch"], shape["seq"]
    dp = _dp_total(mesh)
    accum = max(1, min(16, batch // dp))
    micro = batch // accum
    opt_cfg = _lm_opt_cfg(cfg)

    logical = tfm.param_logical_axes(cfg)
    moment_logical = logical
    if zero_stage == 1:
        logical = _map_axes(lambda ax: tuple(None if a == "fsdp" else a for a in ax), logical)
    p_spec = _specs(mesh, logical)
    m_spec = _specs(mesh, moment_logical)
    o_spec = {"step": (), "m": m_spec, "v": m_spec}
    tok_spec = sh.spec(mesh, "batch", None)

    def make_inputs(device="meta", seed=0):
        dev = resolve_device(device)
        gen = _generator(dev, seed)
        params = _requires_grad(tfm.init_params(cfg, gen, dev))
        return (params, adamw.init(params, opt_cfg),
                _ints(gen, dev, cfg.vocab, (batch, seq)), _ints(gen, dev, cfg.vocab, (batch, seq)))

    def train_step(params, opt_state, tokens, labels):
        t = tokens.reshape(accum, micro, seq)
        lab = labels.reshape(accum, micro, seq)
        leaves = T.leaves(params)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        losses = []
        for i in range(accum):
            loss = tfm.loss_fn(params, t[i], lab[i], cfg)
            g = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            for acc, gi in zip(gsum, g):
                acc += gi
            del g
            losses.append(loss.detach())
        for acc in gsum:
            acc /= accum
        grads = T.unflatten(params, gsum)
        return _apply(params, opt_state, grads, opt_cfg, torch.stack(losses).mean())

    tp = mesh.shape.get("model", 1)
    ana = lm_cell(cfg, "train", batch, seq, dp, tp, accum=accum,
                  moment_bytes=2 if opt_cfg.moment_dtype == "bfloat16" else 4)
    return BuiltStep(
        name=f"{spec.name}:train",
        kind="train",
        fn=train_step,
        make_inputs=make_inputs,
        in_shardings=(p_spec, o_spec, tok_spec, tok_spec),
        out_shardings=(p_spec, o_spec, None),
        donate_argnums=(0, 1),
        model_flops=_lm_flops_train(cfg, batch, seq),
        note=f"accum={accum} micro={micro} moments={opt_cfg.moment_dtype}",
        analytic={"flops_global": ana.flops_global,
                  "bytes_per_device": ana.bytes_per_device, **ana.detail},
    )


def _map_axes(fn, logical_tree):
    """`fn` of each logical tuple of a tree (dicts and lists nest)."""
    if isinstance(logical_tree, tuple):
        return fn(logical_tree)
    if isinstance(logical_tree, dict):
        return {k: _map_axes(fn, v) for k, v in logical_tree.items()}
    return [_map_axes(fn, v) for v in logical_tree]


def build_lm_serve(spec: ArchSpec, shape: dict, mesh, kind: str,
                   variant: str = "") -> BuiltStep:
    cfg = spec.make_config()
    batch, seq = shape["batch"], shape["seq"]
    dp = _dp_total(mesh)
    # batch=1 long-context decode can't occupy the data axis; the kv_seq rule
    # then claims ('data','model') so the cache still shards over all chips
    batch_ax = "batch" if batch % dp == 0 else None
    p_spec = _specs(mesh, tfm.param_logical_axes(cfg))
    cache_spec = {
        "k": sh.spec(mesh, None, batch_ax, None, "kv_seq", None),
        "v": sh.spec(mesh, None, batch_ax, None, "kv_seq", None),
        "len": (),
    }

    attn_override = None
    if kind == "decode" and variant == "splitkv":
        from repro_torch.nn.decode_attn import decode_attention_splitkv

        grid = _grid(mesh)

        def attn_override(q, k, v, vl):
            return decode_attention_splitkv(q, k, v, vl, grid)

    new = seq if kind == "prefill" else 1

    def make_inputs(device="meta", seed=0):
        dev = resolve_device(device)
        gen = _generator(dev, seed)
        # the cache length as a host scalar (the reference's int32 ()), read
        # on the host as `decode_step` reads it
        cache = dict(tfm.init_cache(cfg, batch, seq, device=dev),
                     len=torch.tensor(0, dtype=torch.int32))
        return tfm.init_params(cfg, gen, dev), cache, _ints(gen, dev, cfg.vocab, (batch, new))

    if kind == "prefill":
        def serve_step(params, cache, toks):
            return tfm.decode_step(params, dict(cache, len=int(cache["len"])), toks, cfg)

        model_flops = (2.0 * cfg.active_param_count() * batch * seq
                       + 2.0 * batch * cfg.n_layers * cfg.n_heads * cfg.dh * seq ** 2)
    else:  # decode: one token against a seq-long cache
        def serve_step(params, cache, toks):
            # cache considered full: len = seq - 1
            return tfm.decode_step(params, dict(cache, len=seq - 1), toks, cfg,
                                   attn_override=attn_override)

        model_flops = (2.0 * cfg.active_param_count() * batch
                       + 4.0 * batch * cfg.n_layers * cfg.n_heads * cfg.dh * seq)

    tp = mesh.shape.get("model", 1)
    ana = lm_cell(cfg, kind, batch, seq, dp, tp)
    return BuiltStep(
        name=f"{spec.name}:{kind}",
        kind=kind,
        fn=serve_step,
        make_inputs=make_inputs,
        in_shardings=(p_spec, cache_spec, sh.spec(mesh, batch_ax, None)),
        out_shardings=(None, cache_spec),
        donate_argnums=(1,),
        model_flops=model_flops,
        analytic={"flops_global": ana.flops_global,
                  "bytes_per_device": ana.bytes_per_device, **ana.detail},
        skip=bool(shape.get("skip_full_attn", False)),
        skip_reason=(
            "long_500k requires sub-quadratic attention; all assigned LM archs "
            "are pure full-attention (GQA) per their published configs -> SKIP "
            "per brief. Bonus decode-only run available (decode vs 512k "
            "cache is linear-cost)." if shape.get("skip_full_attn") else ""
        ),
    )


def build_lm_train_pp(spec: ArchSpec, shape: dict, mesh) -> BuiltStep:
    """Pipeline-parallel train step: stages over 'data', manual TP over
    'model', GPipe fill-drain, int8 moments, on the mesh's grid (one pod's
    program: 'pod' divides the batch, as in the reference)."""
    from repro_torch.distributed import pipeline as pp
    from repro_torch.distributed import pipeline_tp as pptp

    cfg = spec.make_config()
    assert cfg.moe is None, "PP variant targets the dense archs"
    batch, seq = shape["batch"], shape["seq"]
    n_stages = mesh.shape["data"]
    pod_dp = mesh.shape.get("pod", 1)
    # more micros -> smaller fill-drain bubble: (S-1)/(M+S-1)
    n_micro = 32
    mb = batch // (n_micro * pod_dp)
    assert mb >= 1, (batch, n_micro, pod_dp)
    pc = pp.plan(cfg, n_stages, n_micro)
    grid = _grid(mesh)
    logical = pp.param_logical_axes_pp(cfg)
    p_spec = _specs(mesh, logical)
    opt_cfg = adamw.AdamWConfig(moment_dtype="int8", total_steps=100_000)

    # int8 moments: the flattened (n_blocks, 256) blocks of the layer
    # stacks shard over the whole mesh, the embed/head ones over 'model'
    whole = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)

    def moment_spec(ax):
        first = next((a for a in ax if a is not None), None)
        entry = (whole,) if first == "fsdp" else ("model",) if first == "vocab" else ()
        return {"q": entry, "s": entry}

    m_spec = _map_axes(moment_spec, logical)
    o_spec = {"step": (), "m": m_spec, "v": m_spec}
    b_local = batch // pod_dp

    def make_inputs(device="meta", seed=0):
        dev = resolve_device(device)
        gen = _generator(dev, seed)
        p = tfm.init_params(cfg, gen, dev)
        p = _requires_grad(dict(p, layers=pp.pad_layer_stack(p["layers"], cfg, pc)))
        return (p, adamw.init(p, opt_cfg), _ints(gen, dev, cfg.vocab, (batch, seq)),
                _ints(gen, dev, cfg.vocab, (batch, seq)))

    def train_step(params, opt_state, tokens, labels):
        t = tokens[:b_local].reshape(n_micro, mb, seq)
        lab = labels[:b_local].reshape(n_micro, mb, seq)
        loss, grads = pptp.pipeline_tp_loss_and_grads(params, t, lab, cfg, pc, grid)
        return _apply(params, opt_state, grads, opt_cfg, loss)

    tp = mesh.shape.get("model", 1)
    ana = lm_cell(cfg, "train", batch, seq, accum=n_micro, dp=n_stages * pod_dp,
                  tp=tp, moment_bytes=1)
    return BuiltStep(
        name=f"{spec.name}:train-pp",
        kind="train",
        fn=train_step,
        make_inputs=make_inputs,
        in_shardings=(p_spec, o_spec, sh.spec(mesh, "batch", None),
                      sh.spec(mesh, "batch", None)),
        out_shardings=(p_spec, o_spec, None),
        donate_argnums=(0, 1),
        model_flops=_lm_flops_train(cfg, batch, seq),
        note=f"PP stages={n_stages} micros={n_micro} mb={mb} int8-moments"
             + (f"; one pod's program of {pod_dp}" if pod_dp > 1 else ""),
        analytic={"flops_global": ana.flops_global,
                  "bytes_per_device": ana.bytes_per_device, **ana.detail},
    )


# ===========================================================================
# GNN family (gcn / gin / gatedgcn)
# ===========================================================================


def _gnn_opt() -> adamw.AdamWConfig:
    return adamw.AdamWConfig(lr=1e-2, weight_decay=0.0, total_steps=1000)


def _pad_edges(e: int) -> int:
    """Edge buffers pad to a 1024 multiple (sentinel src=dst=n, w=0) so edge
    arrays shard evenly over the full 512-chip mesh."""
    return ((e + 1023) // 1024) * 1024


def _edges(gen, dev, n: int, e_real: int, e: int):
    """(src, dst, w) of e_real random edges on n nodes, padded to e with
    sentinel edges (src = dst = n, w = 0)."""
    pad = e - e_real
    src = torch.cat([_ints(gen, dev, n, (e_real,)),
                     torch.full((pad,), n, dtype=torch.int32, device=dev)])
    dst = torch.cat([_ints(gen, dev, n, (e_real,)),
                     torch.full((pad,), n, dtype=torch.int32, device=dev)])
    w = torch.cat([torch.rand((e_real,), generator=gen, device=dev),
                   torch.zeros((pad,), device=dev)])
    return src, dst, w


def _graph_ids(dev, n: int, n_graphs: int) -> torch.Tensor:
    """Node i in graph i * n_graphs // n (ascending)."""
    return (torch.arange(n, dtype=torch.int64, device=dev) * n_graphs // n).to(torch.int32)


def _gnn_shape(shape: dict) -> tuple[int, int, int]:
    n, e = shape["n_nodes"], shape["n_edges"]
    if shape.get("kind") == "batched":
        b = shape.get("batch", 1)
        n, e = n * b, e * b
    return n, e, _pad_edges(e)


def build_gnn_full(spec: ArchSpec, shape: dict, mesh) -> BuiltStep:
    dfeat = shape["d_feat"]
    cfg = dataclasses.replace(spec.make_config(), d_in=dfeat)
    n, e_real, e = _gnn_shape(shape)
    opt_cfg = _gnn_opt()
    n_graphs = shape.get("batch", 1) if cfg.readout == "graph" else 1
    lbl_n = n_graphs if cfg.readout == "graph" else n

    def make_inputs(device="meta", seed=0):
        dev = resolve_device(device)
        gen = _generator(dev, seed)
        params = _requires_grad(gnn_m.init_params(cfg, gen, dev))
        src, dst, w = _edges(gen, dev, n, e_real, e)
        return (params, adamw.init(params, opt_cfg), _normal(gen, dev, (n, dfeat)), src, dst, w,
                _ints(gen, dev, cfg.n_classes, (lbl_n,)),
                (torch.rand((lbl_n,), generator=gen, device=dev) < 0.5).float(),
                _graph_ids(dev, n, n_graphs))

    def train_step(params, opt_state, feats, src, dst, wgt, labels, mask, gids):
        loss = gnn_m.loss_fn(params, feats, src, dst, wgt, labels, cfg,
                             mask=mask if cfg.readout == "node" else None,
                             graph_ids=gids, n_graphs=n_graphs)
        return _apply(params, opt_state, _grads(loss, params), opt_cfg, loss.detach())

    edge = sh.spec(mesh, "edges")
    return BuiltStep(
        name=f"{spec.name}:train",
        kind="train",
        fn=train_step,
        make_inputs=make_inputs,
        in_shardings=(None, None, (), edge, edge, edge, (), (), ()),
        out_shardings=(None, None, None),
        donate_argnums=(0, 1),
        model_flops=_gnn_model_flops(cfg, n, e),
        note=f"edge-sharded over {tuple(mesh.shape)}",
    )


def build_gatedgcn_edgeshard(spec: ArchSpec, shape: dict, mesh) -> BuiltStep:
    """The edge-sharded GatedGCN: edge state and intermediates local to
    their shard of the grid; only the (N, d) node sums cross shards."""
    n, e_real, e = _gnn_shape(shape)
    dfeat = shape["d_feat"]
    cfg = dataclasses.replace(spec.make_config(), d_in=dfeat)
    opt_cfg = _gnn_opt()
    loss_sharded = gnn_m.make_edgesharded_gatedgcn(cfg, _grid(mesh), n)

    def make_inputs(device="meta", seed=0):
        dev = resolve_device(device)
        gen = _generator(dev, seed)
        params = _requires_grad(gnn_m.init_params(cfg, gen, dev))
        src, dst, w = _edges(gen, dev, n, e_real, e)
        return (params, adamw.init(params, opt_cfg), _normal(gen, dev, (n, dfeat)), src, dst, w,
                _ints(gen, dev, cfg.n_classes, (n,)),
                (torch.rand((n,), generator=gen, device=dev) < 0.5).float())

    def train_step(params, opt_state, feats, src, dst, wgt, labels, mask):
        loss = loss_sharded(params, feats, src, dst, wgt, labels, mask)
        return _apply(params, opt_state, _grads(loss, params), opt_cfg, loss.detach())

    edge = sh.spec(mesh, "edges")
    return BuiltStep(
        name=f"{spec.name}:train-edgeshard",
        kind="train",
        fn=train_step,
        make_inputs=make_inputs,
        in_shardings=(None, None, (), edge, edge, edge, (), ()),
        out_shardings=(None, None, None),
        donate_argnums=(0, 1),
        model_flops=_gnn_model_flops(cfg, n, e),
        note="edges cut over the ('data', 'model') grid",
    )


def _gnn_model_flops(cfg, n, e) -> float:
    """2*(gather-mults) + dense layer GEMMs, fwd+bwd(x3)."""
    d = cfg.d_hidden
    per_layer = 2.0 * e * d + 2.0 * n * d * d
    if cfg.kind == "gatedgcn":
        per_layer = 2.0 * 3 * e * d + 2.0 * 5 * n * d * d
    first = 2.0 * n * cfg.d_in * d
    return 3.0 * (cfg.n_layers * per_layer + first)


def sample_local_graph(row_ptr, col_idx, seeds, seed: int, fanout: tuple):
    """The sampled step's local graph: two hops of `graph.sampler.
    sample_block` from `seeds` with a generator seeded by `seed` on the
    seeds' device (a CPU one for meta). Returns (nodes (bn + n1 + n2,) the
    global ids [seeds | hop 1 | hop 2], src, dst (n1 + n2,) local edges,
    the two blocks)."""
    f1, f2 = fanout
    dev = seeds.device
    gen = _generator(dev, seed)
    # sample_block reads row_ptr and col_idx only
    csr = CSR(row_ptr, col_idx, col_idx.new_empty((0,), dtype=torch.float32),
              col_idx.new_empty((0,)))
    b1 = sample_block(csr, seeds, f1, gen)             # n1 edges into the seeds
    b2 = sample_block(csr, b1.src_nodes, f2, gen)      # n2 edges into hop 1
    bn, n1, n2 = seeds.shape[0], b1.src_nodes.shape[0], b2.src_nodes.shape[0]
    nodes = torch.cat([seeds.to(torch.int32), b1.src_nodes, b2.src_nodes])
    src = torch.arange(bn, bn + n1 + n2, dtype=torch.int32, device=dev)
    dst = torch.cat([b1.dst_local, bn + b2.dst_local])
    return nodes, src, dst, (b1, b2)


def build_gnn_sampled(spec: ArchSpec, shape: dict, mesh) -> BuiltStep:
    """minibatch_lg: fanout sampling on the device + block training."""
    n, e = shape["n_nodes"], shape["n_edges"]
    dfeat = shape["d_feat"]
    bn = shape["batch_nodes"]
    f1, f2 = shape["fanout"]
    # sampled training is node-level supervision regardless of arch readout
    cfg = dataclasses.replace(spec.make_config(), d_in=dfeat, readout="node")
    opt_cfg = _gnn_opt()
    n1 = bn * f1                # hop-1 sampled nodes
    n2 = n1 * f2                # hop-2 sampled nodes
    n_local = bn + n1 + n2
    e_local = n1 + n2

    def make_inputs(device="meta", seed=0):
        dev = resolve_device(device)
        gen = _generator(dev, seed)
        params = _requires_grad(gnn_m.init_params(cfg, gen, dev))
        # an even spread of the e edges over the n rows
        row_ptr = (torch.arange(n + 1, dtype=torch.int64, device=dev) * e // n).to(torch.int32)
        # the sampler's seed: a host scalar (the reference's uint32 ()), read
        # on the host to seed the device's generator
        return (params, adamw.init(params, opt_cfg), row_ptr, _ints(gen, dev, n, (e,)),
                _normal(gen, dev, (n, dfeat)), _ints(gen, dev, cfg.n_classes, (n,)),
                _ints(gen, dev, n, (bn,)), torch.tensor(seed, dtype=torch.int32))

    def train_step(params, opt_state, row_ptr, col_idx, feats, labels, seeds, seed):
        nodes, src_l, dst_l, _ = sample_local_graph(row_ptr, col_idx, seeds, int(seed),
                                                    (f1, f2))
        dev = seeds.device
        bf = feats[nodes.long()]
        mask = torch.cat([torch.ones((bn,), device=dev), torch.zeros((n1 + n2,), device=dev)])
        lbl = torch.cat([labels[seeds.long()],
                         torch.zeros((n1 + n2,), dtype=labels.dtype, device=dev)])
        loss = gnn_m.loss_fn(params, bf, src_l, dst_l, None, lbl, cfg, mask=mask)
        return _apply(params, opt_state, _grads(loss, params), opt_cfg, loss.detach())

    return BuiltStep(
        name=f"{spec.name}:train-sampled",
        kind="train",
        fn=train_step,
        make_inputs=make_inputs,
        in_shardings=(None, None, (), (), (), (), sh.spec(mesh, "batch"), ()),
        out_shardings=(None, None, None),
        donate_argnums=(0, 1),
        model_flops=_gnn_model_flops(cfg, n_local, e_local),
        note=f"fanout {f1}-{f2}, block nodes={n_local} edges={e_local}",
    )


# ===========================================================================
# DimeNet
# ===========================================================================


def build_dimenet(spec: ArchSpec, shape: dict, mesh) -> BuiltStep:
    n, e = shape["n_nodes"], shape["n_edges"]
    kind = shape.get("kind")
    b = shape.get("batch", 1)
    cfg = spec.make_config()
    if kind == "batched":
        n, e = n * b, e * b
        e_real = e
        t_cap = 8
        n_graphs = b
        e = _pad_edges(e)
    elif kind == "sampled":
        bn = shape["batch_nodes"]
        f1, f2 = shape["fanout"]
        n = bn + bn * f1 + bn * f1 * f2
        e = e_real = bn * f1 + bn * f1 * f2
        t_cap = f2  # structured triplets: hop2 edges feed their hop1 edge
        n_graphs = 1
        cfg = dataclasses.replace(cfg, loop_bilinear=True)
    else:
        t_cap = 4 if e > 1_000_000 else 8
        n_graphs = 1
        if e > 1_000_000:
            cfg = dataclasses.replace(cfg, loop_bilinear=True)
        e_real = e
        e = _pad_edges(e)
    t = e * t_cap
    opt_cfg = adamw.AdamWConfig(lr=1e-3, weight_decay=0.0, total_steps=1000)

    def make_inputs(device="meta", seed=0):
        dev = resolve_device(device)
        gen = _generator(dev, seed)
        params = _requires_grad(dmn.init_params(cfg, gen, dev))
        src, dst, _ = _edges(gen, dev, n, e_real, e)
        return (params, adamw.init(params, opt_cfg), _normal(gen, dev, (n, cfg.d_in)),
                _normal(gen, dev, (n, 3)), src, dst,
                _ints(gen, dev, e + 1, (t,)), _ints(gen, dev, e + 1, (t,)),
                _normal(gen, dev, (n_graphs, cfg.n_targets)), _graph_ids(dev, n, n_graphs))

    def train_step(params, opt_state, nf, pos, src, dst, tkj, tji, targets, gids):
        loss = dmn.loss_fn(params, nf, pos, src, dst, tkj, tji, targets, cfg,
                           graph_ids=gids, n_graphs=n_graphs)
        return _apply(params, opt_state, _grads(loss, params), opt_cfg, loss.detach())

    edge = sh.spec(mesh, "edges")
    return BuiltStep(
        name=f"{spec.name}:train",
        kind="train",
        fn=train_step,
        make_inputs=make_inputs,
        in_shardings=(None, None, (), (), edge, edge, edge, edge, (), ()),
        out_shardings=(None, None, None),
        donate_argnums=(0, 1),
        model_flops=3.0 * (2.0 * t * cfg.n_radial * cfg.n_spherical * cfg.d_hidden
                           + 2.0 * 6 * e * cfg.d_hidden * cfg.d_hidden * cfg.n_blocks),
        note=f"triplets={t} (cap {t_cap}/edge), loop_bilinear={cfg.loop_bilinear}",
    )


# ===========================================================================
# recsys (DeepFM)
# ===========================================================================


def _deepfm_flops(cfg, batch: int) -> float:
    return 2.0 * batch * (cfg.n_fields * cfg.embed_dim * cfg.mlp[0]
                          + sum(a * b for a, b in zip(cfg.mlp[:-1], cfg.mlp[1:])))


def build_recsys(spec: ArchSpec, shape: dict, mesh) -> BuiltStep:
    cfg = spec.make_config()
    kind = shape["kind"]
    batch = shape["batch"]
    p_spec = _specs(mesh, dfm.param_logical_axes(cfg))
    batch_spec = sh.spec(mesh, "batch", None)

    def ids(gen, dev, rows):
        return _ints(gen, dev, cfg.vocab_per_field, (rows, cfg.n_fields))

    if kind == "train":
        opt_cfg = adamw.AdamWConfig(lr=1e-3, weight_decay=1e-5, total_steps=100_000)
        o_spec = {"step": (), "m": p_spec, "v": p_spec}

        def make_inputs(device="meta", seed=0):
            dev = resolve_device(device)
            gen = _generator(dev, seed)
            params = _requires_grad(dfm.init_params(cfg, gen, dev))
            return (params, adamw.init(params, opt_cfg), ids(gen, dev, batch),
                    (torch.rand((batch,), generator=gen, device=dev) < 0.5).float())

        def train_step(params, opt_state, ids_, labels):
            loss = dfm.loss_fn(params, ids_, labels, cfg)
            return _apply(params, opt_state, _grads(loss, params), opt_cfg, loss.detach())

        return BuiltStep(
            name=f"{spec.name}:train", kind="train", fn=train_step, make_inputs=make_inputs,
            in_shardings=(p_spec, o_spec, batch_spec, sh.spec(mesh, "batch")),
            out_shardings=(p_spec, o_spec, None),
            donate_argnums=(0, 1),
            model_flops=3.0 * _deepfm_flops(cfg, batch),
        )

    if kind == "retrieval":
        n_cand = shape["n_candidates"]

        def make_inputs(device="meta", seed=0):
            dev = resolve_device(device)
            gen = _generator(dev, seed)
            return (dfm.init_params(cfg, gen, dev), ids(gen, dev, batch),
                    _normal(gen, dev, (n_cand, cfg.embed_dim)))

        def retrieve(params, ids_, cand):
            scores = dfm.score_candidates(dfm.user_vector(params, ids_, cfg), cand)
            return torch.topk(scores, 128)

        return BuiltStep(
            name=f"{spec.name}:retrieval", kind="retrieval", fn=retrieve,
            make_inputs=make_inputs,
            # batch=1 query is replicated; candidates shard over 'model'
            in_shardings=(p_spec, (), sh.spec(mesh, "candidates", None)),
            out_shardings=None,
            model_flops=2.0 * batch * n_cand * cfg.embed_dim,
        )

    # pure inference scoring
    def make_inputs(device="meta", seed=0):
        dev = resolve_device(device)
        gen = _generator(dev, seed)
        return dfm.init_params(cfg, gen, dev), ids(gen, dev, batch)

    def serve_step(params, ids_):
        return dfm.forward(params, ids_, cfg)

    return BuiltStep(
        name=f"{spec.name}:{kind}", kind="infer", fn=serve_step, make_inputs=make_inputs,
        in_shardings=(p_spec, batch_spec),
        out_shardings=None,
        model_flops=_deepfm_flops(cfg, batch),
    )


# ===========================================================================
# dispatcher
# ===========================================================================


def build(spec: ArchSpec, shape_name: str, mesh, variant: str = "") -> BuiltStep:
    shape = spec.shapes[shape_name]
    if spec.family == "lm":
        kind = shape["kind"]
        if kind == "train":
            if variant == "pp":
                return build_lm_train_pp(spec, shape, mesh)
            if variant == "zero1":
                return build_lm_train(spec, shape, mesh, zero_stage=1)
            return build_lm_train(spec, shape, mesh)
        return build_lm_serve(spec, shape, mesh,
                              "prefill" if kind == "prefill" else "decode",
                              variant=variant)
    if spec.family == "gnn":
        if shape.get("kind") == "sampled":
            return build_gnn_sampled(spec, shape, mesh)
        if variant == "edgeshard" and spec.make_config().kind == "gatedgcn":
            return build_gatedgcn_edgeshard(spec, shape, mesh)
        return build_gnn_full(spec, shape, mesh)
    if spec.family == "dimenet":
        return build_dimenet(spec, shape, mesh)
    if spec.family == "recsys":
        return build_recsys(spec, shape, mesh)
    raise ValueError(spec.family)
