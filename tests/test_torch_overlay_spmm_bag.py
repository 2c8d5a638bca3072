"""The port's deletion overlay, ELL SpMM and EmbeddingBag
(`repro_torch.kernels`): each plain PyTorch version, through `ops`, against
the JAX Pallas kernel (interpret mode) and its `kernels/ref.py` oracle on the
same numpy inputs. Row counts are multiples of 8, as the Pallas kernels'
`_divisor_tile` needs. The CUDA kernels against their plain versions are in
test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ell_spmv as jell
from repro.kernels import ref
from repro.kernels.embedding_bag import embedding_bag as jbag
from repro_torch.kernels import ops
from repro_torch.kernels import ell_spmv as tell

BIG = np.float32(np.finfo(np.float32).max / 4)

#: the four named Compute ops, as the JAX kernels take them (functions)
JAX_COMPUTE = {
    "hop": lambda v, w: jnp.where(v < BIG, v + 1.0, BIG),
    "add_w": lambda v, w: jnp.where(v < BIG, v + w, BIG),
    "copy": lambda v, w: v,
    "mul_w": lambda v, w: v * w,
}


def _t(a):
    return torch.from_numpy(a)


def _overlay_inputs(r, w, n, seed):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n + 1, size=(r, w)).astype(np.int32)
    wgt = rng.random((r, w)).astype(np.float32)
    vals = rng.random(n + 1).astype(np.float32)
    vals[rng.random(n + 1) < 0.2] = BIG
    vals[-1] = 0.0
    dead = rng.random((r, w)) < 0.3
    return nbr, wgt, vals, dead


@pytest.mark.parametrize("r,w,n", [(8, 4, 50), (64, 16, 200), (24, 256, 300)])
@pytest.mark.parametrize("combine", ["min", "max", "sum"])
@pytest.mark.parametrize("compute", list(JAX_COMPUTE))
def test_overlay_matches_pallas_and_neutralized_copy(r, w, n, combine, compute):
    nbr, wgt, vals, dead = _overlay_inputs(r, w, n, r * w)
    j = np.asarray(jell.ell_combine(
        jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(vals), jnp.asarray(dead),
        compute_fn=JAX_COMPUTE[compute], combine=combine, interpret=True))
    t = ops.ell_combine(_t(nbr), _t(wgt), _t(vals), compute, combine, dead=_t(dead))
    if combine == "sum":
        np.testing.assert_allclose(j, t.numpy(), rtol=1e-6)
    else:
        assert np.array_equal(j, t.numpy())
    # the overlay contract: bit-equal to no mask on the neutralized copy
    neutral = tell.neutralize(_t(nbr), _t(dead), n)
    plain = ops.ell_combine(neutral, _t(wgt), _t(vals), compute, combine)
    assert torch.equal(t.view(torch.int32), plain.view(torch.int32))
    # an int8 mask gives the same as a bool one
    as_int8 = ops.ell_combine(_t(nbr), _t(wgt), _t(vals), compute, combine,
                              dead=_t(dead.astype(np.int8)))
    assert torch.equal(t.view(torch.int32), as_int8.view(torch.int32))


def _spmm_inputs(r, w, n, d, seed):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n + 1, size=(r, w)).astype(np.int32)
    wgt = rng.random((r, w)).astype(np.float32)
    feats = rng.random((n + 1, d)).astype(np.float32)
    feats[-1] = 0.0
    return nbr, wgt, feats


@pytest.mark.parametrize("r,w,n,d", [(16, 8, 100, 8), (64, 32, 500, 10), (8, 4, 20, 128),
                                     (24, 256, 300, 64), (16, 3, 40, 70), (8, 1, 10, 1)])
def test_ell_spmm_plain_matches_pallas_and_ref(r, w, n, d):
    nbr, wgt, feats = _spmm_inputs(r, w, n, d, r + d)
    a = jell.ell_spmm(jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(feats), interpret=True)
    b = ref.ell_spmm_ref(jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(feats))
    t = ops.ell_spmm(_t(nbr), _t(wgt), _t(feats))
    assert t.dtype == torch.float32 and t.shape == (r, d)
    np.testing.assert_allclose(np.asarray(a), t.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(b), t.numpy(), rtol=1e-5, atol=1e-5)


def test_ell_spmm_plain_row_chunks_change_nothing(monkeypatch):
    """At full size the plain version works in row chunks; a chunk of a few
    rows gives the same rows as one chunk."""
    nbr, wgt, feats = _spmm_inputs(40, 16, 90, 12, 7)
    whole = tell.ell_spmm_plain(_t(nbr), _t(wgt), _t(feats))
    monkeypatch.setattr(tell, "_PLAIN_CHUNK", 16 * 12 * 3)      # 3 rows a chunk
    chunked = tell.ell_spmm_plain(_t(nbr), _t(wgt), _t(feats))
    assert torch.equal(whole, chunked)


def test_ell_spmm_plain_bf16_rounds_the_f32_sum():
    """bfloat16 features: float32 accumulation, one rounding at the end."""
    nbr, wgt, feats = _spmm_inputs(16, 8, 60, 70, 11)
    fb = _t(feats).to(torch.bfloat16)
    out = ops.ell_spmm(_t(nbr), _t(wgt), fb)
    want = tell.ell_spmm_plain(_t(nbr), _t(wgt), fb.float()).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want)


def _bag_inputs(v, d, b, k, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, size=(b, k)).astype(np.int32)
    return table, idx


BAG_SHAPES = [(50, 10, 4, 6), (200, 16, 8, 3), (64, 70, 3, 5), (30, 1, 2, 1)]


@pytest.mark.parametrize("v,d,b,k", BAG_SHAPES)
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_pallas(v, d, b, k, mode):
    table, idx = _bag_inputs(v, d, b, k, v + d)
    a = jbag(jnp.asarray(table), jnp.asarray(idx), mode=mode, interpret=True)
    t = ops.embedding_bag(_t(table), _t(idx), mode)
    np.testing.assert_allclose(np.asarray(a), t.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("v,d,b,k", BAG_SHAPES)
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_ref(v, d, b, k, mode):
    table, idx = _bag_inputs(v, d, b, k, v * d)
    r = ref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx), mode)
    t = ops.embedding_bag(_t(table), _t(idx), mode)
    np.testing.assert_allclose(np.asarray(r), t.numpy(), rtol=1e-5, atol=1e-6)
    if mode == "max":
        assert np.array_equal(np.asarray(r), t.numpy())


def test_embedding_bag_max_follows_ref_not_the_pallas_kernel():
    """The Pallas kernel returns the sum for mode 'max' (a fault of the
    reference, ROADMAP section 3); the port computes the max, as the ref."""
    table, idx = _bag_inputs(40, 8, 4, 5, 5)
    pallas = np.asarray(jbag(jnp.asarray(table), jnp.asarray(idx), mode="max", interpret=True))
    pallas_sum = np.asarray(jbag(jnp.asarray(table), jnp.asarray(idx), mode="sum", interpret=True))
    assert np.array_equal(pallas, pallas_sum)
    t = ops.embedding_bag(_t(table), _t(idx), "max").numpy()
    assert np.array_equal(t, table[idx].max(axis=1))
    assert not np.allclose(t, pallas)
