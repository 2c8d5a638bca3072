"""The port's graph and recsys models (`repro_torch.models.gnn`, `dimenet`,
`deepfm`) and its config registry against the JAX reference on the CPU:
reduced configs, the reference's own initial weights carried over by
`interop.params_from_numpy`, the same numpy-seeded inputs through both.

Tolerances (float32): rtol 1e-4, atol 1e-5 (sums over edges, fields and
triplets in another order; matmuls in another order); aggregation over one
edge list, and the host-built triplets, are equal exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.graph import generators as jgen
from repro.models import deepfm as jdfm
from repro.models import dimenet as jdmn
from repro.models import gnn as jgnn
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels import embedding_bag as tbag
from repro_torch.kernels import segment_reduce as tsr
from repro_torch.models import deepfm as tdfm
from repro_torch.models import dimenet as tdmn
from repro_torch.models import gnn as tgnn

RTOL, ATOL = 1e-4, 1e-5
#: config fields of the reference that the port leaves out: XLA's sharding
#: hints, and two GNN fields its forward never reads
DROPPED = {"TransformerConfig": {"tp_constrain"},
           "GNNConfig": {"eps_learnable", "dropout"}}


def _carry(tree):
    return interop.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=RTOL, atol=ATOL)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def edges():
    """rmat(7, 6) out-edges (src, dst, w) with two sentinel edges (== n)."""
    g = jgen.rmat(7, 6, seed=2)
    n = g.n_nodes
    src = np.append(np.asarray(g.out.src_idx), [n, n]).astype(np.int32)
    dst = np.append(np.asarray(g.out.col_idx), [n, 3]).astype(np.int32)
    w = np.append(np.asarray(g.out.weights), [1.0, 2.0]).astype(np.float32)
    return n, src, dst, w


@pytest.mark.parametrize("reduce", ["sum", "max", "mean"])
@pytest.mark.parametrize("weighted", [True, False])
def test_aggregate_matches_reference(edges, reduce, weighted):
    n, src, dst, w = edges
    h = np.random.default_rng(0).standard_normal((n, 12)).astype(np.float32)
    a = jgnn.aggregate(jnp.asarray(h), jnp.asarray(src), jnp.asarray(dst),
                       jnp.asarray(w) if weighted else None, n, reduce)
    b = tgnn.aggregate(_t(h), _t(src), _t(dst), _t(w) if weighted else None, n, reduce)
    _close(a, b)


@pytest.mark.parametrize("arch", ["gcn-cora", "gin-tu", "gatedgcn"])
@pytest.mark.parametrize("readout", ["node", "graph"])
def test_gnn_forward_matches_reference(edges, arch, readout):
    n, src, dst, w = edges
    cfg = dataclasses.replace(jconfigs.get(arch).make_reduced(), readout=readout)
    tcfg = dataclasses.replace(tconfigs.get(arch).make_reduced(), readout=readout)
    p = jgnn.init_params(jax.random.key(2), cfg)
    feats = np.random.default_rng(1).standard_normal((n, cfg.d_in)).astype(np.float32)
    gids = (np.arange(n) * 4 // n).astype(np.int32)
    a = jgnn.forward(p, jnp.asarray(feats), jnp.asarray(src), jnp.asarray(dst),
                     jnp.asarray(w), cfg, jnp.asarray(gids), 4)
    b = tgnn.forward(_carry(p), _t(feats), _t(src), _t(dst), _t(w), tcfg, _t(gids), 4)
    assert b.shape == ((4 if readout == "graph" else n), cfg.n_classes)
    _close(a, b)


@pytest.mark.parametrize("loop_bilinear", [False, True])
def test_dimenet_forward_matches_reference(loop_bilinear):
    cfg = dataclasses.replace(jconfigs.get("dimenet").make_reduced(), loop_bilinear=loop_bilinear)
    tcfg = dataclasses.replace(tconfigs.get("dimenet").make_reduced(),
                               loop_bilinear=loop_bilinear)
    n, m = 24, 72
    r = np.random.default_rng(0)
    src, dst = r.integers(0, n, m), r.integers(0, n, m)
    tkj, tji = jdmn.build_triplets(src, dst, n, cap=4)
    ours = tdmn.build_triplets(src, dst, n, cap=4)
    np.testing.assert_array_equal(tkj, ours[0])
    np.testing.assert_array_equal(tji, ours[1])
    p = jdmn.init_params(jax.random.key(0), cfg)
    nf = np.eye(cfg.d_in, dtype=np.float32)[np.arange(n) % cfg.d_in]
    pos = r.standard_normal((n, 3)).astype(np.float32)
    gids = (np.arange(n) // 12).astype(np.int32)
    a = jdmn.forward(p, jnp.asarray(nf), jnp.asarray(pos), jnp.asarray(src), jnp.asarray(dst),
                     jnp.asarray(tkj), jnp.asarray(tji), cfg, jnp.asarray(gids), 2)
    b = tdmn.forward(_carry(p), _t(nf), _t(pos), _t(src), _t(dst), _t(tkj), _t(tji), tcfg,
                     _t(gids), 2)
    assert b.shape == (2, cfg.n_targets)
    _close(a, b)


def test_deepfm_matches_reference():
    cfg = jconfigs.get("deepfm").make_reduced()
    tcfg = tconfigs.get("deepfm").make_reduced()
    p = jdfm.init_params(jax.random.key(0), cfg)
    tp = _carry(p)
    r = np.random.default_rng(4)
    ids = r.integers(0, cfg.vocab_per_field, (32, cfg.n_fields)).astype(np.int32)
    _close(jdfm.forward(p, jnp.asarray(ids), cfg), tdfm.forward(tp, _t(ids), tcfg))
    uv = jdfm.user_vector(p, jnp.asarray(ids[:4]), cfg)
    tuv = tdfm.user_vector(tp, _t(ids[:4]), tcfg)
    _close(uv, tuv)
    cand = r.standard_normal((1000, cfg.embed_dim)).astype(np.float32)
    _close(jdfm.score_candidates(uv, jnp.asarray(cand)), tdfm.score_candidates(tuv, _t(cand)))


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _same_config(ref, ours):
    assert type(ref).__name__ == type(ours).__name__
    a, b = _fields(ref), _fields(ours)
    assert set(a) - set(b) == DROPPED.get(type(ref).__name__, set())
    assert set(b) <= set(a)
    for k, v in b.items():
        if dataclasses.is_dataclass(v):
            _same_config(a[k], v)
        else:
            assert v == a[k], (ref.name, k)


def test_registry_matches_reference():
    assert tconfigs.names() == jconfigs.names()
    assert tconfigs.cells() == jconfigs.cells() and len(tconfigs.cells()) == 40
    for name in jconfigs.names():
        ref, ours = jconfigs.get(name), tconfigs.get(name)
        assert (ours.family, ours.shapes, ours.notes) == (ref.family, ref.shapes, ref.notes)
        _same_config(ref.make_config(), ours.make_config())
        _same_config(ref.make_reduced(), ours.make_reduced())


@pytest.fixture
def plain_only(monkeypatch):
    """Counts the plain segment_reduce and embedding_bag calls; a CUDA
    wrapper called on CPU tensors fails the test."""
    called = {"segment": 0, "bag": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            called[name] += 1
            return fn(*a, **k)
        return wrapped

    def refuse(*a, **k):
        raise AssertionError("a CUDA wrapper was called on CPU tensors")

    monkeypatch.setattr(tsr, "segment_reduce_plain", count("segment", tsr.segment_reduce_plain))
    monkeypatch.setattr(tbag, "embedding_bag_plain", count("bag", tbag.embedding_bag_plain))
    monkeypatch.setattr(tsr, "segment_reduce_cuda", refuse)
    monkeypatch.setattr(tbag, "embedding_bag_cuda", refuse)
    return called


@pytest.mark.parametrize("arch,segments", [("gcn-cora", 3), ("gin-tu", 3), ("gatedgcn", 6),
                                           ("dimenet", 4), ("deepfm", 0)])
def test_models_take_the_plain_versions_on_the_cpu(plain_only, arch, segments):
    """Each aggregation of a forward is one plain segment reduction on the
    CPU (gcn: degrees + 2 layers; gin: 2 layers + pooling; gatedgcn: 2 a
    layer; dimenet: 2 blocks + nodes + graphs); DeepFM's field sums and user
    vector are plain embedding bags."""
    spec = tconfigs.get(arch)
    cfg = spec.make_reduced()
    gen = torch.Generator().manual_seed(0)
    if arch == "deepfm":
        p = tdfm.init_params(cfg, gen, "cpu")
        ids = torch.zeros((4, cfg.n_fields), dtype=torch.int32)
        tdfm.forward(p, ids, cfg)
        tdfm.user_vector(p, ids, cfg)
        assert plain_only["bag"] == 3
    elif arch == "dimenet":
        src, dst = np.array([0, 1, 2, 3]), np.array([1, 2, 3, 0])
        tkj, tji = tdmn.build_triplets(src, dst, 4, cap=4)
        tdmn.forward(tdmn.init_params(cfg, gen, "cpu"), torch.ones((4, cfg.d_in)),
                     torch.randn((4, 3), generator=gen), _t(src), _t(dst), _t(tkj), _t(tji), cfg)
    else:
        src, dst = _t(np.array([0, 1, 2], np.int32)), _t(np.array([1, 2, 0], np.int32))
        tgnn.forward(tgnn.init_params(cfg, gen, "cpu"), torch.ones((3, cfg.d_in)), src, dst,
                     None, cfg)
    assert plain_only["segment"] == segments
