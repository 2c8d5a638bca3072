"""Gradients of the port against `jax.grad` of the reference on the CPU: the
backward formulas of the differentiable kernel ops (`kernels.ops`), each
model family's `loss_fn`, and `launch.train.main` against the reference's.

The same numpy-seeded inputs and the reference's own initial weights
(carried by `interop.params_from_numpy`) go through both packages; on the
CPU every op takes its plain version and its plain backward formula.

Tolerances (float32): the op backwards within rtol 1e-5 and atol 1e-6 (sums
in another order); a `loss_fn` gradient leaf within 1e-4 of its largest
entry (every backward product and sum in another order, through up to two
layers); `main`'s per-step losses within 2e-3 (six optimizer steps from
the same checkpoint amplify last-bit differences of the gradients through
Adam's normalisation), its first loss within 1e-5.
"""

import dataclasses
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import manager as jckpt
from repro.graph import generators as jgen
from repro.kernels import ref as jref
from repro.launch import train as jtrain
from repro.models import deepfm as jdfm
from repro.models import dimenet as jdmn
from repro.models import gnn as jgnn
from repro.models import transformer as jtf
from repro.nn import moe as jmoe
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import deepfm as tdfm
from repro_torch.models import dimenet as tdmn
from repro_torch.models import gnn as tgnn
from repro_torch.models import transformer as ttf
from repro_torch.nn import moe as tmoe

OP_RTOL, OP_ATOL = 1e-5, 1e-6
GRAD_ERR = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(tree):
    p = interop.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    for leaf in T.leaves(p):
        leaf.requires_grad_(True)
    return p


def _op_close(want, got):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=OP_RTOL,
                               atol=OP_ATOL)


# ---------------------------------------------------------------------------
# the op backwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [None, 6])
def test_segment_sum_backward_matches_jax(d):
    """Ids sorted, some out of range on both sides (their rows get 0)."""
    rng = np.random.default_rng(0)
    e, num = 300, 40
    shape = (e,) if d is None else (e, d)
    vals = rng.standard_normal(shape).astype(np.float32)
    ids = np.sort(rng.integers(-3, num + 3, e)).astype(np.int32)
    w = rng.standard_normal((num,) + shape[1:]).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jref.segment_reduce_ref(v, jnp.asarray(ids), num)
                                      * w))(jnp.asarray(vals))
    v = _t(vals).requires_grad_()
    (ops.segment_reduce(v, _t(ids), num) * _t(w)).sum().backward()
    _op_close(want, v.grad)
    assert float(v.grad[torch.from_numpy((ids < 0) | (ids >= num))].abs().sum()) == 0.0


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_backward_matches_jax(mode):
    """Ids in [-V - 3, V + 3): negative ids wrap once; an id still outside
    [0, V) is clamped by the forward and dropped by the gradient, as
    `jax.grad` of JAX's `table[idx]` drops it."""
    rng = np.random.default_rng(1)
    v, d, b, k = 50, 10, 64, 39
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(-v - 3, v + 3, (b, k)).astype(np.int32)
    w = rng.standard_normal((b, d)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jref.embedding_bag_ref(t, jnp.asarray(idx), mode) * w))(
        jnp.asarray(table))
    t = _t(table).requires_grad_()
    (ops.embedding_bag(t, _t(idx), mode) * _t(w)).sum().backward()
    _op_close(want, t.grad)


@pytest.mark.parametrize("shape,d", [((7, 9), 5), ((200,), 1), ((3, 4, 5), 16)])
def test_gather_rows_backward_matches_jax(shape, d):
    rng = np.random.default_rng(len(shape))
    v = 23
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(-v, v, shape)
    w = rng.standard_normal(shape + (d,)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(t[jnp.asarray(idx)] * w))(jnp.asarray(table))
    t = _t(table).requires_grad_()
    got = ops.gather_rows(t, _t(idx))
    assert got.shape == shape + (d,)
    (got * _t(w)).sum().backward()
    _op_close(want, t.grad)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (2, 4, 2, 16, 16, 8, True), (1, 6, 3, 9, 21, 12, True), (2, 2, 1, 17, 17, 16, False),
    (1, 4, 4, 1, 13, 32, True)])
def test_attention_backward_matches_jax(b, hq, hkv, sq, skv, d, causal):
    rng = np.random.default_rng(sq + skv)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    w = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    want = jax.grad(lambda q_, k_, v_: jnp.sum(jref.attention_ref(q_, k_, v_, causal) * w),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    (ops.attention(tq, tk, tv, causal) * _t(w)).sum().backward()
    for a, g in zip(want, (tq.grad, tk.grad, tv.grad)):
        _op_close(a, g)


def test_ops_without_gradients_skip_autograd():
    """Serving calls (no input needs a gradient, or no_grad) build no
    autograd graph: their outputs carry no grad_fn."""
    v = torch.randn(6)
    assert ops.segment_reduce(v, torch.tensor([0, 0, 1, 1, 2, 2], dtype=torch.int32),
                              3).grad_fn is None
    assert ops.gather_rows(torch.randn(4, 2), torch.tensor([1, 3])).grad_fn is None
    with torch.no_grad():
        t = torch.randn(4, 2, requires_grad=True)
        assert ops.gather_rows(t, torch.tensor([1, 3])).grad_fn is None
        assert ops.embedding_bag(t, torch.tensor([[0, 1]], dtype=torch.int32)).grad_fn is None


# ---------------------------------------------------------------------------
# loss_fn gradients against jax.grad
# ---------------------------------------------------------------------------


def _grads_close(jg, tp):
    """Each leaf of jax.grad's tree against the port's .grad, in JAX's
    leaf order, within GRAD_ERR of the leaf's largest entry (a leaf the
    loss does not reach, as GatedGCN's last edge norm, has no .grad where
    JAX gives zeros)."""
    jl = jax.tree_util.tree_flatten_with_path(jg)[0]
    tl = list(T.walk(tp))
    assert len(jl) == len(tl)
    for (jpath, a), (tpath, p) in zip(jl, tl):
        a = np.asarray(a, np.float32)
        g = np.zeros_like(a) if p.grad is None else p.grad.numpy()
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(g - a).max()) <= GRAD_ERR * scale, (tpath, np.abs(g - a).max(), scale)


def _lm_case(arch):
    cfg = jconfigs.get(arch).make_reduced()
    p = jtf.init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    return cfg, p, tconfigs.get(arch).make_reduced(), toks, labels


def _lm_grads(cfg, p, tcfg, toks, labels):
    jl, jg = jax.value_and_grad(jtf.loss_fn)(p, jnp.asarray(toks), jnp.asarray(labels), cfg)
    tp = _carry(p)
    tl = ttf.loss_fn(tp, _t(toks), _t(labels), tcfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _grads_close(jg, tp)


def test_dense_lm_loss_grads_match_jax():
    """reduced-dense (granite-3-8b's reduced config): padded vocab lanes
    masked, remat on (torch.utils.checkpoint against jax.checkpoint)."""
    cfg, p, tcfg, toks, labels = _lm_case("granite-3-8b")
    assert tcfg.remat and tcfg.padded_vocab != tcfg.vocab
    _lm_grads(cfg, p, tcfg, toks, labels)


def test_moe_lm_loss_grads_match_jax(monkeypatch):
    """reduced-moe: both packages route every token to the same experts
    (the layers run eagerly in each, their top-k indices recorded), then
    the loss and every gradient, aux loss included, agree."""
    cfg, p, tcfg, toks, labels = _lm_case("granite-moe-1b-a400m")
    jroutes, troutes = [], []
    top_k = jax.lax.top_k

    def jspy(g, k):
        v, i = top_k(g, k)
        jroutes.append(np.asarray(i))
        return v, i

    monkeypatch.setattr(jmoe.jax.lax, "top_k", jspy)
    x = p["embed"][jnp.asarray(toks)]
    pos = jnp.broadcast_to(jnp.arange(16, dtype=jnp.int32), (2, 16))
    for i in range(cfg.n_layers):
        x, _, _ = jtf._layer(cfg, x, jax.tree.map(lambda t: t[i], p["layers"]), pos)
    monkeypatch.setattr(jmoe.jax.lax, "top_k", top_k)
    ttop = tmoe.top_k

    def tspy(g, k):
        v, i = ttop(g, k)
        troutes.append(i.numpy())
        return v, i

    monkeypatch.setattr(tmoe, "top_k", tspy)
    with torch.no_grad():
        ttf.forward(interop.params_from_numpy(jax.tree.map(np.asarray, p), "cpu"), _t(toks), tcfg)
    monkeypatch.setattr(tmoe, "top_k", ttop)
    assert len(jroutes) == len(troutes) == cfg.n_layers
    for a, b in zip(jroutes, troutes):
        np.testing.assert_array_equal(a, b)
    _lm_grads(cfg, p, tcfg, toks, labels)


def test_lm_grads_without_remat_equal_with_remat():
    """The checkpointed layers give the same gradients bit for bit as the
    plain ones (the recomputed MoE forward takes the same routes)."""
    cfg = tconfigs.get("granite-moe-1b-a400m").make_reduced()
    p = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)))
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = [t.detach().clone().requires_grad_() for t in T.leaves(p)]
        tp = T.unflatten(p, leaves)
        out.append(torch.autograd.grad(ttf.loss_fn(tp, toks, toks, c), leaves))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_deepfm_loss_grads_match_jax():
    cfg = jconfigs.get("deepfm").make_reduced()
    tcfg = tconfigs.get("deepfm").make_reduced()
    p = jdfm.init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.vocab_per_field, (64, cfg.n_fields)).astype(np.int32)
    ids[:8] = ids[8:16]                           # repeated rows: the scatter sums them
    y = (rng.random(64) < 0.5).astype(np.float32)
    jl, jg = jax.value_and_grad(jdfm.loss_fn)(p, jnp.asarray(ids), jnp.asarray(y), cfg)
    tp = _carry(p)
    tl = tdfm.loss_fn(tp, _t(ids), _t(y), tcfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _grads_close(jg, tp)


@pytest.fixture(scope="module")
def edges():
    """rmat(7, 6) out-edges (src, dst, w) with two sentinel edges (== n)."""
    g = jgen.rmat(7, 6, seed=2)
    n = g.n_nodes
    src = np.append(np.asarray(g.out.src_idx), [n, n]).astype(np.int32)
    dst = np.append(np.asarray(g.out.col_idx), [n, 3]).astype(np.int32)
    w = np.append(np.asarray(g.out.weights), [1.0, 2.0]).astype(np.float32)
    return n, src, dst, w


@pytest.mark.parametrize("arch,readout", [("gcn-cora", "node"), ("gatedgcn", "node"),
                                          ("gin-tu", "graph")])
def test_gnn_loss_grads_match_jax(edges, arch, readout):
    """Node readout with the reference's mask; graph readout with graph ids
    and n_graphs. GatedGCN keeps the reference's msg[src] gather (ROADMAP,
    faults of the reference)."""
    n, src, dst, w = edges
    cfg = dataclasses.replace(jconfigs.get(arch).make_reduced(), readout=readout)
    tcfg = dataclasses.replace(tconfigs.get(arch).make_reduced(), readout=readout)
    p = jgnn.init_params(jax.random.key(2), cfg)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((n, cfg.d_in)).astype(np.float32)
    gids = (np.arange(n) * 4 // n).astype(np.int32)
    rows = 4 if readout == "graph" else n
    labels = rng.integers(0, cfg.n_classes, rows).astype(np.int32)
    mask = None if readout == "graph" else (rng.random(n) < 0.5).astype(np.float32)
    kw = dict(mask=None if mask is None else jnp.asarray(mask), graph_ids=jnp.asarray(gids),
              n_graphs=4)
    jl, jg = jax.value_and_grad(jgnn.loss_fn)(p, jnp.asarray(feats), jnp.asarray(src),
                                              jnp.asarray(dst), jnp.asarray(w),
                                              jnp.asarray(labels), cfg, **kw)
    tp = _carry(p)
    tl = tgnn.loss_fn(tp, _t(feats), _t(src), _t(dst), _t(w), _t(labels), tcfg,
                      mask=None if mask is None else _t(mask), graph_ids=_t(gids), n_graphs=4)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _grads_close(jg, tp)


def test_dimenet_loss_grads_match_jax():
    cfg = jconfigs.get("dimenet").make_reduced()
    tcfg = tconfigs.get("dimenet").make_reduced()
    n, m = 24, 72
    r = np.random.default_rng(0)
    src, dst = r.integers(0, n, m), r.integers(0, n, m)
    tkj, tji = jdmn.build_triplets(src, dst, n, cap=4)
    p = jdmn.init_params(jax.random.key(0), cfg)
    nf = np.eye(cfg.d_in, dtype=np.float32)[np.arange(n) % cfg.d_in]
    pos = r.standard_normal((n, 3)).astype(np.float32)
    gids = (np.arange(n) // 12).astype(np.int32)
    tgt = r.standard_normal((2, cfg.n_targets)).astype(np.float32)
    args = (nf, pos, src, dst, tkj, tji, tgt)
    jl, jg = jax.value_and_grad(jdmn.loss_fn)(p, *(jnp.asarray(a) for a in args), cfg,
                                              jnp.asarray(gids), 2)
    tp = _carry(p)
    tl = tdmn.loss_fn(tp, *(_t(a) for a in args), tcfg, _t(gids), 2)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _grads_close(jg, tp)


# ---------------------------------------------------------------------------
# the launcher against the reference's
# ---------------------------------------------------------------------------


def _losses(text: str) -> list[float]:
    return [float(x) for x in re.findall(r"^step \d+ loss ([\d.]+)", text, re.M)]


def _seed_checkpoint(path: str):
    """The reference's tiny granite-3-8b weights and fresh AdamW state as
    step 0, so both launchers start from the same parameters."""
    cfg = jtrain.tiny_config(jconfigs.get("granite-3-8b").make_config())
    p = jtf.init_params(jax.random.key(0), cfg)
    o = jadamw.init(p, jadamw.AdamWConfig())
    jckpt.save(os.path.join(path, "step_0"), {"p": p, "o": o}, 0,
               extra={"data": {"seed": 0, "step": 0}})


def test_train_main_tracks_the_reference_and_resumes_bit_equal(tmp_path, capsys):
    """Both launchers resume from one step-0 checkpoint (the reference's
    weights) and train six tiny steps on the same TokenStream: the losses
    agree. Then the port's step-6 checkpoint is set aside and the run
    resumed from step 3: its step-6 parameters and moments are bit-equal
    to the straight run's."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    _seed_checkpoint(jdir)
    shutil.copytree(jdir, tdir)
    argv = ["--preset", "tiny", "--arch", "granite-3-8b", "--steps", "6", "--log-every", "1",
            "--ckpt-every", "3"]
    assert jtrain.main(argv + ["--ckpt-dir", jdir]) == 0
    jout = capsys.readouterr().out
    assert ttrain.main(argv + ["--ckpt-dir", tdir, "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    assert "[resume] from step 0" in jout and "[resume] from step 0" in tout
    jl, tl = _losses(jout), _losses(tout)
    assert len(jl) == len(tl) == 6 and tl[-1] < tl[0]
    assert abs(jl[0] - tl[0]) <= 1e-4                     # printed to 4 decimals
    np.testing.assert_allclose(tl, jl, atol=2e-3)
    os.rename(os.path.join(tdir, "step_6"), str(tmp_path / "straight_6"))
    assert ttrain.main(argv + ["--ckpt-dir", tdir, "--device", "cpu"]) == 0
    assert "[resume] from step 3" in capsys.readouterr().out
    with np.load(str(tmp_path / "straight_6" / "arrays.npz")) as a, \
            np.load(os.path.join(tdir, "step_6", "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files) and any(k.startswith("o/v/") for k in a.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_train_main_preemption_saves_and_returns_1(tmp_path, monkeypatch, capsys):
    """A SIGTERM seen before step 2 saves step 2 (blocking, with the data
    stream's state) and returns 1; the guard's handler is removed."""
    checks = iter([False, False, True])

    class Guard(ttrain.PreemptionGuard):
        preempted = property(lambda self: next(checks), lambda self, v: None)

    monkeypatch.setattr(ttrain, "PreemptionGuard", Guard)
    cfg = ttrain.tiny_config(tconfigs.get("granite-3-8b").make_config(), d_model=64,
                             n_layers=1, vocab=128)
    monkeypatch.setattr(ttrain, "preset_config", lambda arch, preset: cfg)
    rc = ttrain.main(["--steps", "5", "--ckpt-dir", str(tmp_path), "--device", "cpu",
                      "--batch", "2", "--seq", "8"])
    assert rc == 1 and "[preempt]" in capsys.readouterr().out
    from repro_torch.checkpoint import manifest

    man = manifest(str(tmp_path / "step_2"))
    assert man["step"] == 2 and man["extra"]["data"] == {"seed": 0, "step": 2}
