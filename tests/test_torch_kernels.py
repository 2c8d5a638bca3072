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


# ---------------------------------------------------------------------------
# segment_reduce_ordered (the CUDA kernel's fold order) and the ell_combine
# lane layout, on the CPU
# ---------------------------------------------------------------------------

TIER_EDGES = [1, tsr.THREAD_SEG, tsr.THREAD_SEG + 1, 32, 33, tsr.LONG_SEG, tsr.LONG_SEG + 1]


def _tier_case(d, seed):
    """Sorted ids with segments on each side of every tier limit, gaps
    (empty segments) and out-of-range ids at both ends; values in [0, 1)."""
    rng = np.random.default_rng(seed)
    lens = [tsr.LONG_SEG + 1] + TIER_EDGES + [int(x) for x in rng.integers(1, 40, 12)] \
        + TIER_EDGES[::-1]
    seg = np.cumsum(rng.integers(1, 4, len(lens)))
    num = int(seg[-1]) + 3
    ids = np.concatenate([[-4, -1], np.repeat(seg, lens), [num, num + 2]]).astype(np.int32)
    vals = rng.random((ids.shape[0], d)).astype(np.float32)
    return (vals[:, 0] if d == 1 else vals), ids, num


def _pallas_segment(vals, ids, num, combine):
    """The JAX package's Pallas kernel in interpret mode (E padded to its
    256-row tiles with ids past the end, which drop)."""
    v2 = vals.reshape(vals.shape[0], -1)
    pad = (-v2.shape[0]) % 256
    v2 = np.concatenate([v2, np.zeros((pad, v2.shape[1]), np.float32)])
    ids = np.concatenate([ids, np.full(pad, num, np.int32)])
    out = jsr.segment_reduce(jnp.asarray(v2), jnp.asarray(ids), num_segments=num,
                             combine=combine, tile_edges=256, interpret=True)
    return np.asarray(out).reshape((num,) + vals.shape[1:])


@pytest.mark.parametrize("d", [1, 3, 64])
@pytest.mark.parametrize("combine", ["sum", "min", "max"])
def test_segment_reduce_ordered_matches_plain_pallas_and_ref(d, combine):
    vals, ids, num = _tier_case(d, seed=d)
    o = tsr.segment_reduce_ordered(torch.from_numpy(vals), torch.from_numpy(ids), num,
                                   combine).numpy()
    p = tsr.segment_reduce_plain(torch.from_numpy(vals), torch.from_numpy(ids), num,
                                 combine).numpy()
    a = _pallas_segment(vals, ids, num, combine)
    ok = (ids >= 0) & (ids < num)
    r = np.asarray(ref.segment_reduce_ref(jnp.asarray(vals[ok]), jnp.asarray(ids[ok]), num,
                                          combine))
    hit = np.isin(np.arange(num), ids)
    if combine == "sum":
        np.testing.assert_allclose(o, p, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o, a, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o[hit], r[hit], rtol=1e-5, atol=1e-6)
    else:
        assert np.array_equal(o, p) and np.array_equal(o, a)
        assert np.array_equal(o[hit], r[hit])
    assert np.all(o[~hit] == tell.identity(combine))


@pytest.mark.parametrize("case", ["num_far_above_e", "all_out_of_range", "e_zero", "d_gt_1_empty"])
def test_segment_reduce_ordered_edge_cases(case):
    rng = np.random.default_rng(3)
    if case == "num_far_above_e":
        ids = np.repeat(np.sort(rng.choice(100_000, 60, replace=False)), 3).astype(np.int32)
        num, d = 100_003, 1
    elif case == "all_out_of_range":
        ids, num, d = np.array([-3, -2, 9, 9, 12], np.int32), 9, 3
    else:
        ids, num, d = np.zeros(0, np.int32), 7, (1 if case == "e_zero" else 64)
    v = rng.random((ids.shape[0], d)).astype(np.float32)
    vals = torch.from_numpy(v[:, 0] if d == 1 else v)
    sid = torch.from_numpy(ids)
    for combine in ("sum", "min", "max"):
        o = tsr.segment_reduce_ordered(vals, sid, num, combine, fill=-7.0)
        p = tsr.segment_reduce_plain(vals, sid, num, combine, fill=-7.0)
        assert o.shape == p.shape == (num,) + tuple(vals.shape[1:])
        if combine == "sum":
            torch.testing.assert_close(o, p, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(o, p)


@pytest.mark.parametrize("length,d", [(1, 1), (tsr.THREAD_SEG, 1), (tsr.THREAD_SEG + 1, 1),
                                      (33, 1), (tsr.LONG_SEG + 1, 1), (40, 3),
                                      (tsr.LONG_SEG + 1, 3)])
def test_segment_reduce_ordered_folds_in_the_kernels_order(length, d):
    """One segment, written out by hand in each tier's order: a left fold
    (thread tier; every D > 1 segment up to LONG_SEG), lanes of a warp then
    its shuffle tree, threads of a block then the warp and block trees, or
    warps of a block then a tree over them (D > 1)."""
    rng = np.random.default_rng(length)
    v = torch.from_numpy((rng.random((length, d)) * 10 ** rng.uniform(-3, 3, (length, d)))
                         .astype(np.float32))
    got = tsr.segment_reduce_ordered(v if d > 1 else v[:, 0], torch.zeros(length,
                                     dtype=torch.int32), 1, "sum").reshape(d)

    def lanes(p):          # lane l folds rows l, l + p, ... from 0.0
        acc = torch.zeros(p, d)
        for r in range(length):
            acc[r % p] = acc[r % p] + v[r]
        return acc

    if d == 1 and length <= tsr.THREAD_SEG or d > 1 and length <= tsr.LONG_SEG:
        want = lanes(1)[0]
    elif d == 1 and length <= tsr.LONG_SEG:
        want = tell.halving_tree(lanes(32), 0, "sum")
    elif d == 1:
        warps = tell.halving_tree(lanes(256).reshape(8, 32, d), 1, "sum")
        want = tell.halving_tree(warps, 0, "sum")
    else:
        want = tell.halving_tree(lanes(8), 0, "sum")
    assert torch.equal(got.view(torch.int32), want.reshape(d).view(torch.int32))


@pytest.mark.parametrize("w", [1, 3, 4, 5, 32, 256])
@pytest.mark.parametrize("combine", ["sum", "min", "max"])
def test_ell_combine_lanes_model_equals_halving_tree(w, combine):
    """The 16-byte variant's layout (lane l holds slots 4l .. 4l + 3; two
    vectors a lane at W = 256) folds in the halving tree's order: bit-equal
    for sums, on values of many magnitudes and both signs."""
    rng = np.random.default_rng(w)
    x = (rng.standard_normal((57, w)) * 10 ** rng.uniform(-4, 4, (57, w))).astype(np.float32)
    x[rng.random((57, w)) < 0.3] = tell.identity(combine)
    upd = torch.from_numpy(x)
    a = tell.ell_combine_lanes_model(upd, combine)
    b = tell.halving_tree(upd, 1, combine)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("w,lanes", [(1, (1, 1)), (3, (1, 1)), (4, (1, 1)), (5, (2, 1)),
                                     (32, (8, 1)), (64, (16, 1)), (128, (32, 1)),
                                     (256, (32, 2))])
def test_vector_lanes_of_each_width(w, lanes):
    """(G lanes a row, V vectors a lane): four rows a warp at W = 32."""
    assert tell.vector_lanes(w) == lanes


@pytest.mark.parametrize("w,nbr_off,wgt_off,dead_off,vector", [
    (4, 0, 0, None, True), (32, 0, 0, None, True), (256, 0, 0, 0, True),
    (32, 0, 0, 4, True), (32, 0, 0, 2, False), (32, 4, 0, None, False),
    (256, 0, 8, None, False), (1, 0, 0, None, False), (3, 0, 0, None, False),
    (5, 0, 0, None, False), (12, 0, 0, None, True)])
def test_vector_variant_is_a_function_of_width_and_alignment(w, nbr_off, wgt_off,
                                                             dead_off, vector):
    base = 1 << 20
    dead = None if dead_off is None else base + dead_off
    assert tell.vector_layout(w, base + nbr_off, base + wgt_off, dead) is vector


def test_packed_slices_take_the_vector_variant():
    """pack_ell's slices (W = 4, 32, 256) are fresh allocations: all qualify."""
    from repro_torch.graph import generators as TG
    from repro_torch.graph import pack_ell as t_pack_ell

    g = TG.rmat(10, 16, seed=1, device="cpu")
    pack = t_pack_ell(g.inc)
    assert {s.nbr.shape[1] for s in pack.slices} <= {4, 32, 256}
    for s in pack.slices:
        assert tell.vector_layout(s.nbr.shape[1], s.nbr.data_ptr(), s.wgt.data_ptr())


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("w,d,dtype,offs,layout", [
    # pack_ell's slices at gin-tu's and gatedgcn's widths
    (4, 64, F32, (0, 0, 0, 0), (True, 4)), (256, 64, F32, (0, 0, 0, 0), (True, 4)),
    (32, 70, F32, (0, 0, 0, 0), (True, 2)), (32, 70, BF16, (0, 0, 0, 0), (True, 2)),
    (32, 64, BF16, (0, 0, 0, 0), (True, 8)), (32, 12, BF16, (0, 0, 0, 0), (True, 4)),
    (32, 10, F32, (0, 0, 0, 0), (True, 2)), (8, 1, F32, (0, 0, 0, 0), (True, 1)),
    (8, 3, BF16, (0, 0, 0, 0), (True, 1)), (16, 128, F32, (0, 0, 0, 0), (True, 4)),
    # ids and weights: W % 4 and 16-byte alignment
    (3, 64, F32, (0, 0, 0, 0), (False, 4)), (32, 64, F32, (4, 0, 0, 0), (False, 4)),
    (32, 64, F32, (0, 8, 0, 0), (False, 4)), (1, 64, F32, (0, 0, 0, 0), (False, 4)),
    # features: a view 4 or 8 bytes into its storage, or an output off 16 bytes
    (32, 64, F32, (0, 0, 4, 0), (True, 1)), (32, 64, F32, (0, 0, 8, 0), (True, 2)),
    (32, 64, BF16, (0, 0, 2, 0), (True, 1)), (32, 64, BF16, (0, 0, 4, 0), (True, 2)),
    (32, 64, BF16, (0, 0, 8, 0), (True, 4)), (32, 64, F32, (0, 0, 0, 8), (True, 2))])
def test_spmm_layout_is_a_function_of_width_features_dtype_and_alignment(w, d, dtype, offs,
                                                                          layout):
    """(vec_ids, fvec): 16-byte id and weight loads where W % 4 == 0 and both
    are 16-byte aligned; the widest feature load (16, 8, 4 or 2 bytes) that
    divides D and to which feats and out are aligned."""
    base = 1 << 20
    ptrs = [base + o for o in offs]
    assert tell.spmm_layout(w, d, dtype, *ptrs) == layout


def test_packed_slices_take_16_byte_loads_in_ell_spmm():
    from repro_torch.graph import generators as TG
    from repro_torch.graph import pack_ell as t_pack_ell

    g = TG.rmat(10, 16, seed=1, device="cpu")
    pack = t_pack_ell(g.inc)
    feats = torch.zeros(g.n_nodes + 1, 64)
    out = torch.empty(4, 64)
    for s in pack.slices:
        assert tell.spmm_layout(s.nbr.shape[1], 64, F32, s.nbr.data_ptr(), s.wgt.data_ptr(),
                                feats.data_ptr(), out.data_ptr()) == (True, 4)


@pytest.mark.parametrize("r,w,n,d,sentinels", [(16, 32, 100, 64, 0.3), (8, 256, 300, 70, 0.5),
                                               (24, 4, 50, 8, 1.0)])
def test_ell_spmm_plain_with_sentinels_mid_row_matches_pallas(r, w, n, d, sentinels):
    """Sentinel slots anywhere in a row (a neutralized overlay copy puts
    them mid-row), and a slice with no live slot: the plain version agrees
    with the Pallas kernel and `ref.py`."""
    rng = np.random.default_rng(r + w)
    nbr = rng.integers(0, n, size=(r, w)).astype(np.int32)
    nbr[rng.random((r, w)) < sentinels] = n
    wgt = rng.random((r, w)).astype(np.float32)
    feats = rng.random((n + 1, d)).astype(np.float32)
    feats[-1] = 0.0
    j = np.asarray(jell.ell_spmm(jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(feats),
                                 interpret=True))
    t = tell.ell_spmm_plain(*map(torch.from_numpy, (nbr, wgt, feats)))
    np.testing.assert_allclose(j, t.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref.ell_spmm_ref(jnp.asarray(nbr), jnp.asarray(wgt),
                                                           jnp.asarray(feats))),
                               t.numpy(), rtol=1e-5, atol=1e-5)
    if sentinels == 1.0:
        assert not t.any()
