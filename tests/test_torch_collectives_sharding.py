"""The port's gradient-compression collectives and logical-axis sharding
against the reference on the CPU.

Collectives: `bf16_psum_ef` and `topk_psum_ef` over 4 shards against the
reference's bodies under `jax.vmap(..., axis_name="data")` (its
`make_compressed_allreduce` raises under this JAX: `shard_map` lost its
`check_rep` argument, a fault of the reference), with ties in magnitude:
bit-equal; the compressed send plus the new residual is the float32 sum
bit for bit. Sharding: `spec()` against the reference's `sh.spec` under a
(1, 1) and a (1, 1, 1) jax mesh for every logical tuple of both
`param_logical_axes` tables, the pipeline's, the cache's and each `RULES`
name; `shard`/`unshard` round trips."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.compat import AxisType, make_mesh
from repro.distributed import collectives as jcol
from repro.distributed import pipeline as jpp
from repro.distributed import sharding as jsh
from repro.models import deepfm as jdfm
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch import mesh as M
from repro_torch import tree as T
from repro_torch.distributed import collectives as tcol
from repro_torch.distributed import sharding as tsh
from repro_torch.models import deepfm as tdfm
from repro_torch.models import transformer as ttf

D = 4


def _inputs(seed, shape=(6, 5), residual=True):
    rng = np.random.default_rng(seed)
    g = (rng.integers(-3, 4, (D,) + shape) * 0.37).astype(np.float32)   # ties in |g|
    r = (rng.standard_normal((D,) + shape) * 1e-3).astype(np.float32)
    return g, r if residual else np.zeros_like(r)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.int32)


def test_bf16_psum_ef_matches_the_reference_body():
    g, r = _inputs(0)
    jr, jres = jax.vmap(lambda a, b: jcol.bf16_psum_ef(a, b, "data"), axis_name="data")(
        jnp.asarray(g), jnp.asarray(r))
    tr, tres = tcol.bf16_psum_ef(list(map(torch.from_numpy, g)), list(map(torch.from_numpy, r)))
    for a, b in zip(tr + tres, list(jr) + list(jres)):
        np.testing.assert_array_equal(_bits(a), np.asarray(b).view(np.int32))


@pytest.mark.parametrize("k", [1, 3, 7, 30])
@pytest.mark.parametrize("residual", [False, True])
def test_topk_psum_ef_matches_the_reference_body(k, residual):
    """Ties in magnitude: `jax.lax.top_k` takes the lower index first, and
    so does the port's threshold selection; indices colliding across shards
    sum in shard order."""
    g, r = _inputs(k, residual=residual)
    jr, jres = jax.vmap(lambda a, b: jcol.topk_psum_ef(a, b, "data", k), axis_name="data")(
        jnp.asarray(g), jnp.asarray(r))
    tr, tres = tcol.topk_psum_ef(list(map(torch.from_numpy, g)), list(map(torch.from_numpy, r)),
                                 k)
    for a, b in zip(tr + tres, list(jr) + list(jres)):
        np.testing.assert_array_equal(_bits(a), np.asarray(b).view(np.int32))


@pytest.mark.parametrize("method", ["bf16", "topk"])
def test_sent_plus_residual_is_the_sum_bit_for_bit(method):
    g, r = _inputs(5)
    for gi, ri in zip(g, r):
        want = torch.from_numpy(gi) + torch.from_numpy(ri)
        if method == "bf16":
            sent, res = tcol.compress_bf16(torch.from_numpy(gi), torch.from_numpy(ri))
        else:
            idx, sel, res = tcol.compress_topk(torch.from_numpy(gi), torch.from_numpy(ri), 4)
            sent = torch.zeros(gi.size).index_put_((idx,), sel).reshape(gi.shape)
        assert np.array_equal(_bits(sent + res), _bits(want))


@pytest.mark.parametrize("method", ["bf16", "topk"])
def test_compressed_allreduce_over_a_gradient_tree(method):
    """Each leaf of each shard's tree reduced as the body reduces it; every
    shard gets the same sum; k = max(1, int(size * k_frac)) a leaf."""
    rng = np.random.default_rng(2)
    trees = [{"w": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
              "b": [torch.from_numpy(rng.standard_normal(3).astype(np.float32))]}
             for _ in range(D)]
    zeros = [T.map_leaves(torch.zeros_like, t) for t in trees]
    mesh = M.make_mesh(D, 1, devices=["cpu"] * D)
    red, res = tcol.make_compressed_allreduce(mesh, "data", method, k_frac=0.1)(trees, zeros)
    assert len(red) == len(res) == D
    for name in ("w", "b"):
        get = (lambda t: t["w"]) if name == "w" else (lambda t: t["b"][0])
        gs = [get(t) for t in trees]
        if method == "bf16":
            want, _ = tcol.bf16_psum_ef(gs, [torch.zeros_like(x) for x in gs])
        else:
            k = max(1, int(gs[0].numel() * 0.1))
            want, _ = tcol.topk_psum_ef(gs, [torch.zeros_like(x) for x in gs], k)
        for d in range(D):
            assert torch.equal(get(red[d]), want[d])
            assert torch.equal(get(red[d]), get(red[0]))
    with pytest.raises(ValueError):
        tcol.make_compressed_allreduce(mesh, "data", "int8")


def test_reference_compressed_allreduce_raises_under_this_jax():
    mesh = make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    f = jcol.make_compressed_allreduce(mesh, "data", "bf16")
    with pytest.raises(TypeError, match="check_rep"):
        f({"w": jnp.ones((2, 2))}, {"w": jnp.zeros((2, 2))})


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------


def _logical_tuples():
    out = set()

    def add(tree):
        if isinstance(tree, tuple):
            out.add(tree)
        elif isinstance(tree, dict):
            for v in tree.values():
                add(v)
        else:
            for v in tree:
                add(v)

    for arch in ("granite-3-8b", "granite-moe-1b-a400m"):
        cfg = jconfigs.get(arch).make_reduced()
        add(jtf.param_logical_axes(cfg))
        if cfg.moe is None:
            add(jpp.param_logical_axes_pp(cfg))
    add(jtf.cache_logical_axes())
    add(jdfm.param_logical_axes(jconfigs.get("deepfm").make_reduced()))
    for name in jsh.RULES:
        out.add((name,))
        out.add((None, name))
    out.add(("batch", None, "kv_seq", None))
    out.add(("kv_seq", "batch"))
    out.add(("edges", "nodes", "queries"))
    return sorted(out, key=repr)


LOGICAL = _logical_tuples()


@pytest.mark.parametrize("axes", [("data", "model"), ("pod", "data", "model")],
                         ids=["1x1", "1x1x1"])
def test_spec_matches_the_reference(axes):
    jmesh = make_mesh((1,) * len(axes), axes, axis_types=(AxisType.Auto,) * len(axes))
    stand_in = types.SimpleNamespace(shape={a: 1 for a in axes})
    with jsh.activate(jmesh):
        want = [tuple(jsh.spec(*lg)) for lg in LOGICAL]
    with tsh.activate(stand_in):
        got = [tsh.spec(*lg) for lg in LOGICAL]
    assert got == want
    assert tsh.current_mesh() is None and tsh.spec("batch", "heads") == (None, None)


def test_rules_and_tables_match_the_reference():
    assert tsh.RULES == jsh.RULES
    for arch in ("granite-3-8b", "granite-moe-1b-a400m"):
        assert ttf.param_logical_axes(tconfigs.get(arch).make_reduced()) == \
            jtf.param_logical_axes(jconfigs.get(arch).make_reduced())
    assert tdfm.param_logical_axes(tconfigs.get("deepfm").make_reduced()) == \
        jdfm.param_logical_axes(jconfigs.get("deepfm").make_reduced())


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 3), (4, 1)], ids=str)
def test_shard_unshard_round_trip(shape):
    mesh = M.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    x = torch.arange(12 * 12 * 6, dtype=torch.float32).reshape(12, 12, 6)
    for logical in [("fsdp", None, "heads"), ("kv_seq", None, None), (None, None, None),
                    ("edges", None, None), ("batch", "vocab", None)]:
        grid = tsh.shard(mesh, x, *logical)
        with tsh.activate(mesh):
            entries = tsh.spec(*logical)
        n = [tsh.parts(mesh, e) for e in entries]
        assert all(t.shape == tuple(s // k for s, k in zip(x.shape, n))
                   for row in grid for t in row)
        assert torch.equal(tsh.unshard(mesh, grid, *logical), x)
    # a block held by one grid position only: ('data','model') over dim 0
    grid = tsh.shard(mesh, x, "kv_seq", None, None)
    d_n, s_n = shape
    assert torch.equal(grid[d_n - 1][s_n - 1], x[-12 // (d_n * s_n):])


def test_tree_shard_follows_the_table():
    cfg = tconfigs.get("granite-3-8b").make_reduced()
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = M.make_mesh(2, 2, devices=["cpu"] * 4)
    grid = tsh.tree_shard(mesh, params, ttf.param_logical_axes(cfg))
    wq = grid["layers"]["wq"]          # (None, 'fsdp', 'heads')
    d, f = params["layers"]["wq"].shape[1:]
    assert wq[1][0].shape == (cfg.n_layers, d // 2, f // 2)
    assert torch.equal(wq[1][0], params["layers"]["wq"][:, d // 2:, : f // 2])
    with tsh.activate(mesh):
        assert tsh.spec("vocab", "fsdp") == ("model", "data") and tsh.spec(None) == (None,)
    assert tsh.constrain(params["embed"], "vocab", "fsdp") is params["embed"]
