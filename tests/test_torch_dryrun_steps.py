"""The port's step builders (`repro_torch.launch.steps`) against the
reference's (`repro.launch.steps`) on the CPU.

The ten cells of `tests/test_dryrun.py`, shrunk as its `_lower` shrinks
them (reduced configs, a few nodes and edges, small batches), and the
`zero1`, `pp`, `splitkv` and `edgeshard` variants at the smallest shapes
the reference's builders take, are built by both packages on (1, 1)
meshes. Both steps run on the same seeded numpy inputs (the reference's on
`jax.jit`, the port's eagerly on the CPU, where every kernel takes its plain
version), whose shapes are checked leaf by leaf between the packages first.

Tolerances (float32): the loss within 1e-5 relative; after the step, each
parameter leaf within 1e-4 of its largest entry (`test_torch_train_grads`'s
gradient tolerance: one AdamW step moves each entry by at most lr), each
first moment within 1e-4 of its largest entry and each second moment within
2e-4 (the square of a gradient doubles its relative error); int8 moments
compare dequantized, within that plus one quantization step of the block.
Decode logits and caches within 1e-4 of their largest entry; retrieval
scores within rtol 1e-5 and their indices equal.

The sampled GNN cell draws with different generators in the two packages
(`jax.random` cannot be matched), so its block shapes are held to
`graph.sampler.block_shapes` and its loss to the port's `loss_fn` on the
same block.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.launch.mesh import make_local_mesh as jlocal_mesh
from repro_torch import configs as tconfigs
from repro_torch import tree as T
from repro_torch.graph import sampler
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import gnn as tgnn

LOSS_RTOL = 1e-5
LEAF_ERR = 1e-4

CELLS = [
    ("granite-3-8b", "train_4k", ""),
    ("granite-moe-1b-a400m", "train_4k", ""),
    ("granite-3-8b", "decode_32k", ""),
    ("gcn-cora", "full_graph_sm", ""),
    ("gin-tu", "molecule", ""),
    ("gatedgcn", "full_graph_sm", ""),
    ("dimenet", "molecule", ""),
    ("deepfm", "train_batch", ""),
    ("deepfm", "retrieval_cand", ""),
    ("granite-3-8b", "train_4k", "zero1"),
    ("granite-3-8b", "train_4k", "pp"),
    ("granite-3-8b", "decode_32k", "splitkv"),
    ("gatedgcn", "full_graph_sm", "edgeshard"),
]


def _shrink(spec, shape, variant=""):
    """`tests/test_dryrun.py::_lower`'s shrink; the pipeline's 32 micros
    take a batch of 32 at least."""
    sh = dict(spec.shapes[shape])
    if spec.family == "lm":
        sh["batch"] = min(sh["batch"], 2)
        sh["seq"] = min(sh["seq"], 64)
        if variant == "pp":
            sh["batch"], sh["seq"] = 32, 16
    if spec.family in ("gnn", "dimenet"):
        sh["n_nodes"] = min(sh["n_nodes"], 256)
        sh["n_edges"] = min(sh["n_edges"], 1024)
        sh.pop("batch_nodes", None)
        if sh.get("kind") == "sampled":
            sh["batch_nodes"] = 8
            sh["fanout"] = (3, 2)
        if sh.get("kind") == "batched":
            sh["batch"] = 4
    if spec.family == "recsys":
        sh["batch"] = min(sh["batch"], 64)
        if "n_candidates" in sh:
            sh["n_candidates"] = 1024
    return dataclasses.replace(spec, shapes={shape: sh}, make_config=spec.make_reduced), sh


def _both(arch, shape, variant):
    jspec, sh = _shrink(jconfigs.get(arch), shape, variant)
    tspec, _ = _shrink(tconfigs.get(arch), shape, variant)
    jmesh = jlocal_mesh(1, 1)
    with jsh.activate(jmesh):
        jb = jsteps.build(jspec, shape, jmesh, variant=variant)
    tb = tsteps.build(tspec, shape, tmesh.make_local_mesh(1, 1, devices=["cpu"]),
                      variant=variant)
    return jspec, tspec, sh, jmesh, jb, tb


def _params(tree, rng):
    """Seeded values for a tree of ShapeDtypeStructs: gains near 1, weights
    at fan-in scale, scalars small."""
    def one(s):
        if s.ndim == 0:
            return np.float32(0.1 * rng.standard_normal())
        if s.ndim == 1:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape) * s.shape[-2] ** -0.5).astype(np.float32)

    return jax.tree.map(one, tree)


def _zeros(tree):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)


def _ints(rng, high, shape):
    return rng.integers(0, high, shape).astype(np.int32)


def _edges(rng, n, e):
    """e edges on n nodes, the last eighth sentinel (src = dst = n, w = 0)."""
    real = e - e // 8
    src = np.concatenate([_ints(rng, n, real), np.full(e - real, n, np.int32)])
    dst = np.concatenate([_ints(rng, n, real), np.full(e - real, n, np.int32)])
    w = np.concatenate([rng.random(real), np.zeros(e - real)]).astype(np.float32)
    return src, dst, w


def _data(spec, sh, cfg, abstract, rng):
    """Seeded data inputs (everything after params and optimizer state)."""
    fam, kind = spec.family, sh.get("kind")
    shapes = [a.shape for a in abstract]
    if fam == "lm":
        if kind == "train":
            return [_ints(rng, cfg.vocab, s) for s in shapes]
        return [_ints(rng, cfg.vocab, shapes[0])]
    if fam == "recsys":
        ids = _ints(rng, cfg.vocab_per_field, shapes[0])
        if kind == "train":
            return [ids, (rng.random(shapes[1]) < 0.5).astype(np.float32)]
        if kind == "retrieval":
            return [ids, rng.standard_normal(shapes[1]).astype(np.float32)]
        return [ids]
    n, e = shapes[0][0], shapes[2][0] if fam == "gnn" else shapes[2][0]
    if fam == "gnn":
        feats = rng.standard_normal(shapes[0]).astype(np.float32)
        src, dst, w = _edges(rng, n, shapes[1][0])
        rest = [_ints(rng, cfg.n_classes, shapes[4]),
                (rng.random(shapes[5]) < 0.5).astype(np.float32)]
        if len(shapes) > 6:
            g = max(1, shapes[4][0]) if cfg.readout == "graph" else 1
            rest.append((np.arange(n) * g // n).astype(np.int32))
        return [feats, src, dst, w] + rest
    # dimenet: nf, pos, src, dst, tkj, tji, targets, gids
    e = shapes[2][0]
    src, dst, _ = _edges(rng, n, e)
    g = shapes[6][0]
    return [rng.standard_normal(shapes[0]).astype(np.float32),
            rng.standard_normal(shapes[1]).astype(np.float32), src, dst,
            _ints(rng, e + 1, shapes[4]), _ints(rng, e + 1, shapes[5]),
            rng.standard_normal(shapes[6]).astype(np.float32),
            (np.arange(n) * g // n).astype(np.int32)]


def _to_torch(tree, grad=False):
    def one(a):
        t = torch.from_numpy(np.array(a))
        return t.requires_grad_() if grad and t.is_floating_point() else t

    if isinstance(tree, dict):
        return {k: _to_torch(v, grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v, grad) for v in tree)
    return one(tree)


def _leaves(tree):
    """(path, numpy) of each leaf in the reference's leaf order."""
    if isinstance(tree, torch.Tensor):
        return [((), tree.detach().numpy())]
    return [(p, v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in T.walk(tree)]


def _jleaves(tree):
    return [(p, np.asarray(v)) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _close(want, got, err, what):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    assert float(np.abs(got - want).max(initial=0.0)) <= err * scale, (
        what, float(np.abs(got - want).max()), scale)


def _moments_close(jm, tm, err, what):
    """Moment trees: float leaves within `err` of their largest entry; int8
    leaves ({'q', 's'}) dequantized, within that plus one step of a block."""
    if isinstance(jm, dict) and set(jm) == {"q", "s"}:
        wq = np.asarray(jm["q"], np.float64) * np.asarray(jm["s"], np.float64)
        gq = tm["q"].numpy().astype(np.float64) * tm["s"].numpy().astype(np.float64)
        step = np.maximum(np.asarray(jm["s"], np.float64), tm["s"].numpy())
        scale = max(float(np.abs(wq).max()), 1e-30)
        assert np.all(np.abs(gq - wq) <= err * scale + step + 1e-30), what
        return
    if isinstance(jm, dict):
        for k in jm:
            _moments_close(jm[k], tm[k], err, what + (k,))
        return
    if isinstance(jm, (list, tuple)):
        for i, (a, b) in enumerate(zip(jm, tm)):
            _moments_close(a, b, err, what + (i,))
        return
    _close(np.asarray(jm, np.float32), tm.detach().numpy(), err, what)


def _check_shapes(jb, tb):
    """The port's abstract inputs have the reference's shapes and dtypes."""
    jl = jax.tree.leaves(jb.abstract_inputs)
    tl = [t for t in T.leaves(list(tb.abstract_inputs)) if isinstance(t, torch.Tensor)]
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        assert tuple(a.shape) == tuple(t.shape)
        assert np.dtype(a.dtype).itemsize == t.element_size()


@pytest.mark.parametrize("arch,shape,variant", CELLS,
                         ids=lambda v: v if isinstance(v, str) and v else None)
def test_step_matches_the_reference(arch, shape, variant):
    jspec, tspec, sh, jmesh, jb, tb = _both(arch, shape, variant)
    assert (tb.kind, tb.skip, tb.donate_argnums) == (jb.kind, jb.skip, jb.donate_argnums)
    assert tb.model_flops == pytest.approx(jb.model_flops, rel=1e-12)
    assert tb.analytic == jb.analytic
    _check_shapes(jb, tb)
    rng = np.random.default_rng(7)
    cfg = jspec.make_config()
    ab = jb.abstract_inputs
    params = _params(ab[0], rng)
    if jb.kind == "train":
        opt = _zeros(ab[1])
        data = _data(jspec, sh, cfg, ab[2:], rng)
        jin = (params, opt, *data)
        tin = (_to_torch(params, grad=True), _to_torch(opt), *_to_torch(data))
    elif jb.kind in ("prefill", "decode"):
        cache = {"k": (0.5 * rng.standard_normal(ab[1]["k"].shape)).astype(np.float32),
                 "v": (0.5 * rng.standard_normal(ab[1]["v"].shape)).astype(np.float32),
                 "len": np.int32(0)}
        toks = _data(jspec, sh, cfg, ab[2:], rng)
        jin = (params, cache, *toks)
        tin = (_to_torch(params), dict(_to_torch({k: cache[k] for k in "kv"}),
                                       len=torch.tensor(0, dtype=torch.int32)),
               *_to_torch(toks))
    else:
        data = _data(jspec, sh, cfg, ab[1:], rng)
        jin = (params, *data)
        tin = (_to_torch(params), *_to_torch(data))
    with jsh.activate(jmesh):
        jout = jax.jit(jb.fn)(*jin)
    tout = tb.fn(*tin)
    if jb.kind == "train":
        jp, jo, jmet = jout
        tp, to, tmet = tout
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-4)
        for (path, a), (_, b) in zip(_jleaves(jp), _leaves(tp)):
            _close(a, b, LEAF_ERR, ("param", path))
        assert int(to["step"]) == int(jo["step"]) == 1
        _moments_close(jo["m"], to["m"], LEAF_ERR, ("m",))
        _moments_close(jo["v"], to["v"], 2 * LEAF_ERR, ("v",))
    elif jb.kind in ("prefill", "decode"):
        (jl, jc), (tl, tc) = jout, tout
        _close(jl, tl.numpy(), LEAF_ERR, "logits")
        for k in "kv":
            _close(jc[k], tc[k].numpy(), LEAF_ERR, k)
    elif jb.kind == "retrieval":
        (jv, ji), (tv, ti) = jout, tout
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    else:
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)


def test_sampled_step_blocks_and_loss():
    """gcn-cora minibatch_lg shrunk: the two hops' blocks have
    `sampler.block_shapes`, and the step's loss is `loss_fn` on the block
    the same seed samples."""
    jspec, tspec, sh, jmesh, jb, tb = _both("gcn-cora", "minibatch_lg", "")
    _check_shapes(jb, tb)
    inputs = tb.make_inputs("cpu", seed=3)
    params, _, row_ptr, col_idx, feats, labels, seeds, seed = inputs
    before = T.map_leaves(lambda t: t.detach().clone(), params)
    bn, (f1, f2) = sh["batch_nodes"], sh["fanout"]
    nodes, src, dst, (b1, b2) = tsteps.sample_local_graph(row_ptr, col_idx, seeds, int(seed),
                                                          (f1, f2))
    assert [(b.seeds.shape[0], b.src_nodes.shape[0]) for b in (b1, b2)] == \
        sampler.block_shapes(bn, (f1, f2))
    assert nodes.shape[0] == bn + bn * f1 + bn * f1 * f2 == src.shape[0] + bn
    assert bool((dst[:bn * f1] < bn).all()) and bool((dst[bn * f1:] >= bn).all())
    _, _, metrics = tb.fn(*inputs)
    cfg = dataclasses.replace(tspec.make_config(), d_in=sh["d_feat"], readout="node")
    n_local = nodes.shape[0]
    mask = torch.zeros(n_local)
    mask[:bn] = 1.0
    lbl = torch.zeros(n_local, dtype=labels.dtype)
    lbl[:bn] = labels[seeds.long()]
    want = tgnn.loss_fn(before, feats[nodes.long()], src, dst, None, lbl, cfg, mask=mask)
    assert float(metrics["loss"]) == float(want)
    # the step moved the parameters
    assert any(not torch.equal(a, b) for a, b in zip(T.leaves(before), T.leaves(params)))
