"""The port's kernels (`repro_torch.kernels`): each plain PyTorch version
against the JAX Pallas kernel (interpret mode) and its `kernels/ref.py`
oracle, and the CPU dispatch. The CUDA kernels against their plain versions
are in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as JF
from repro.kernels import ell_spmv as jell
from repro.kernels import frontier_pack as jfp
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels import segment_reduce as jsr
from repro_torch.kernels import _build
from repro_torch.kernels import ell_spmv as tell
from repro_torch.kernels import embedding_bag as tbag
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import frontier_pack as tfp
from repro_torch.kernels import ops
from repro_torch.kernels import segment_reduce as tsr

ELL_SHAPES = [(8, 4, 50), (64, 16, 200), (128, 32, 1000), (24, 256, 300),
              (13, 4, 50), (100, 1, 60)]


def _ell_inputs(r, w, n, seed=42):
    rng = np.random.default_rng(seed + r * w)
    nbr = rng.integers(0, n + 1, size=(r, w)).astype(np.int32)
    wgt = rng.random((r, w)).astype(np.float32)
    vals = rng.random(n + 1).astype(np.float32)
    vals[-1] = 0.0
    return nbr, wgt, vals


@pytest.mark.parametrize("r,w,n", ELL_SHAPES)
@pytest.mark.parametrize("combine", ["min", "max", "sum"])
def test_ell_combine_plain_matches_pallas_and_ref(r, w, n, combine):
    nbr, wgt, vals = _ell_inputs(r, w, n)
    compute = lambda v, ww: v + ww          # == 'add_w' on values below BIG
    b = ref.ell_combine_ref(jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(vals),
                            compute, combine)
    t = tell.ell_combine_plain(torch.from_numpy(nbr), torch.from_numpy(wgt),
                               torch.from_numpy(vals), "add_w", combine).numpy()
    np.testing.assert_allclose(np.asarray(b), t, rtol=1e-6)
    if r % 8 == 0:                          # the Pallas kernel tiles rows by 8
        a = jell.ell_combine(jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(vals),
                             compute_fn=compute, combine=combine, interpret=True)
        np.testing.assert_allclose(np.asarray(a), t, rtol=1e-6)
        if combine != "sum":
            assert np.array_equal(np.asarray(a), t)


@pytest.mark.parametrize("n,block,density", [(1024, 256, 0.1), (4096, 512, 0.5),
                                             (2048, 1024, 0.95), (512, 512, 0.0)])
def test_frontier_pack_blocks_match_pallas_and_ref(n, block, density):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < density
    kids, kcnt = jfp.frontier_pack(jnp.asarray(mask), block=block, interpret=True)
    rids, rcnt = ref.frontier_pack_ref(jnp.asarray(mask), block)
    tids, tcnt = tfp.pack_blocks_plain(torch.from_numpy(mask), block, sentinel=n)
    assert np.array_equal(np.asarray(kids), tids.numpy())
    assert np.array_equal(np.asarray(rids), tids.numpy())
    assert np.array_equal(np.asarray(kcnt), tcnt.numpy())
    for cap in (n, max(n // 4, 1)):
        j = jfp.concat_blocks(kids, kcnt, cap, sentinel=n)
        t = tfp.concat_blocks(tids, tcnt, cap, sentinel=n)
        for a, b in zip(j, t):
            assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("n,density,cap", [(1024, 0.1, 1024), (3001, 0.7, 3001),
                                           (1000, 0.5, 100), (5, 1.0, 0), (0, 0.0, 4)])
def test_frontier_pack_plain_equals_compact_mask(n, density, cap):
    """The ragged last block (n % 1024 != 0) the TPU kernel asserted away."""
    rng = np.random.default_rng(cap)
    mask = rng.random(n) < density
    j = JF.compact_mask(jnp.asarray(mask), cap, n)
    t = tfp.frontier_pack_plain(torch.from_numpy(mask), cap)
    o = ops.frontier_pack(torch.from_numpy(mask), cap)
    for a, b, c in zip(j, t, o):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert torch.equal(b, c)


@pytest.mark.parametrize("e,d,s,combine", [(256, 4, 16, "sum"), (2048, 16, 64, "sum"),
                                           (512, 8, 10, "min"), (512, 8, 10, "max")])
def test_segment_reduce_plain_matches_pallas_and_ref(e, d, s, combine):
    rng = np.random.default_rng(e + d)
    vals = rng.random((e, d)).astype(np.float32)
    sid = np.sort(rng.integers(0, s, size=e)).astype(np.int32)
    a = jsr.segment_reduce(jnp.asarray(vals), jnp.asarray(sid), num_segments=s,
                           combine=combine, tile_edges=min(256, e), interpret=True)
    b = ref.segment_reduce_ref(jnp.asarray(vals), jnp.asarray(sid), s, combine)
    t = tsr.segment_reduce_plain(torch.from_numpy(vals), torch.from_numpy(sid), s,
                                 combine).numpy()
    # the TPU kernel's contract: an empty segment holds 0 or +-f32max/4
    np.testing.assert_allclose(np.asarray(a), t, rtol=1e-5, atol=1e-5)
    hit = np.isin(np.arange(s), sid)
    np.testing.assert_allclose(np.asarray(b)[hit], t[hit], rtol=1e-5, atol=1e-5)


def test_segment_reduce_drops_out_of_range_and_fills_empty():
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    sid = torch.tensor([-1, 0, 0, 3, 9], dtype=torch.int32)
    out = tsr.segment_reduce_plain(vals, sid, 4, "sum", fill=-1.0)
    assert out.tolist() == [5.0, -1.0, -1.0, 4.0]
    out = tsr.segment_reduce_plain(vals, sid, 4, "max")
    assert out.tolist() == [3.0, -tell.BIG, -tell.BIG, 4.0]
    j = jops.segment_reduce(jnp.asarray(vals.numpy()[:, None]), jnp.asarray(sid.numpy()),
                            4, "min")
    t = tsr.segment_reduce_plain(vals[:, None], sid, 4, "min")
    assert np.array_equal(np.asarray(j), t.numpy())      # Pallas: +f32max/4 empties


def test_cpu_tensors_take_the_plain_version_uncounted():
    ops.reset_launches()
    nbr, wgt, vals = _ell_inputs(8, 4, 50)
    ops.ell_combine(torch.from_numpy(nbr), torch.from_numpy(wgt), torch.from_numpy(vals),
                    "hop", "min")
    ops.frontier_pack(torch.ones(10, dtype=torch.bool), 10)
    ops.segment_reduce(torch.ones(3), torch.zeros(3, dtype=torch.int32), 2)
    ops.ell_combine(torch.from_numpy(nbr), torch.from_numpy(wgt), torch.from_numpy(vals),
                    "hop", "min", dead=torch.ones(nbr.shape, dtype=torch.bool))
    ops.ell_spmm(torch.from_numpy(nbr), torch.from_numpy(wgt), torch.zeros(51, 3))
    ops.embedding_bag(torch.ones(5, 3), torch.zeros(2, 2, dtype=torch.int32))
    ops.attention(torch.ones(1, 2, 4, 8), torch.ones(1, 1, 4, 8), torch.ones(1, 1, 4, 8))
    assert ops.launch_counts() == {k: 0 for k in _build.KERNELS}


def test_cuda_wrappers_refuse_cpu_tensors():
    """No hidden fallback: the CUDA wrapper never runs the plain version."""
    nbr, wgt, vals = _ell_inputs(8, 4, 50)
    with pytest.raises(ValueError, match="CUDA"):
        tell.ell_combine_cuda(torch.from_numpy(nbr), torch.from_numpy(wgt),
                              torch.from_numpy(vals), "hop", "min")
    with pytest.raises(ValueError, match="CUDA"):
        tfp.frontier_pack_cuda(torch.ones(4, dtype=torch.bool), 4)
    with pytest.raises(ValueError, match="CUDA"):
        tsr.segment_reduce_cuda(torch.ones(3), torch.zeros(3, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="CUDA"):
        tell.ell_combine_cuda(torch.from_numpy(nbr), torch.from_numpy(wgt),
                              torch.from_numpy(vals), "hop", "min",
                              torch.ones(nbr.shape, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        tell.ell_spmm_cuda(torch.from_numpy(nbr), torch.from_numpy(wgt), torch.zeros(51, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tbag.embedding_bag_cuda(torch.ones(5, 3), torch.zeros(2, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(torch.ones(1, 2, 4, 8), torch.ones(1, 1, 4, 8),
                                 torch.ones(1, 1, 4, 8))


def test_library_name_covers_the_shared_headers(tmp_path, monkeypatch):
    """A header edit rebuilds every kernel: the library's name hashes the
    source and every csrc/*.cuh."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "b.cu").write_text("// no include\n")
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._lib_path(n) for n in ("a", "b")}
    assert before["a"] != before["b"] and before == {n: _build._lib_path(n) for n in ("a", "b")}
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert all(_build._lib_path(n) != p for n, p in before.items())
    assert all(_build._lib_path(n).parent == _build.BUILD_DIR for n in before)
