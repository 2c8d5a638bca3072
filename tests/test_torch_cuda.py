"""The port's CUDA kernels on the card, against their plain PyTorch versions,
and the engine's kernel pull against its torch pull. Every test is marked
`cuda` and skips without a GPU.

This file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch; there, skip the shared conftest (it builds
the reference's fixtures):

    PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as A
from repro_torch.core import engine as E
from repro_torch.graph import generators as G
from repro_torch.graph import pack_ell
from repro_torch.kernels import ell_spmv as tell
from repro_torch.kernels import embedding_bag as tbag
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import frontier_pack as tfp
from repro_torch.kernels import ops
from repro_torch.kernels import segment_reduce as tsr
from repro_torch.nn import layers as TL

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("r,w,n", [(8, 4, 50), (64, 16, 200), (128, 32, 1000),
                                   (24, 256, 300), (13, 4, 50), (100, 1, 60),
                                   (37, 64, 90), (9, 3, 40)])
def test_ell_combine_bit_equal_to_plain(cuda, r, w, n):
    rng = np.random.default_rng(r * w)
    nbr = torch.from_numpy(rng.integers(0, n + 1, (r, w)).astype(np.int32)).to(cuda)
    wgt = torch.from_numpy(rng.random((r, w)).astype(np.float32)).to(cuda)
    v = rng.random(n + 1).astype(np.float32)
    v[::5] = tell.BIG
    vals = torch.from_numpy(v).to(cuda)
    for op in tell.COMPUTE_OPS:
        for comb in tell.COMBINE_OPS:
            a = tell.ell_combine_cuda(nbr, wgt, vals, op, comb)
            b = tell.ell_combine_plain(nbr, wgt, vals, op, comb)
            assert torch.equal(_bits(a), _bits(b)), (op, comb)


@pytest.mark.parametrize("n,density,cap", [
    (3001, 0.5, 3001), (5000, 0.9, 100), (1024, 0.0, 1024), (7, 1.0, 0),
    # look-back edge cases: many tiles with a ragged last one (n % 4096 != 0),
    # all lanes set, none set, cap below the total, cap 0, cap above n
    (1_000_003, 0.5, 1_000_003), (1_000_003, 1.0, 1_000_003), (1_000_003, 0.0, 1_000_003),
    (1_000_003, 0.5, 300_000), (1_000_003, 0.5, 0), (1_000_003, 0.3, 1_500_000),
    (4096 * 40, 1.0, 4096 * 40), (0, 0.5, 5)])
def test_frontier_pack_bit_equal_to_plain(cuda, n, density, cap):
    rng = np.random.default_rng(n)
    mask = torch.from_numpy(rng.random(n) < density).to(cuda)
    for a, b in zip(tfp.frontier_pack_cuda(mask, cap), tfp.frontier_pack_plain(mask, cap)):
        assert torch.equal(a, b)


def test_frontier_pack_twice_on_one_stream_resets_the_tile_states(cuda):
    """Two calls in a row, no synchronisation between them: the second sees
    none of the first's status words or ticket."""
    rng = np.random.default_rng(11)
    masks = [torch.from_numpy(rng.random(2_000_001) < d).to(cuda) for d in (0.9, 0.1)]
    first = tfp.frontier_pack_cuda(masks[0], 2_000_001)
    second = tfp.frontier_pack_cuda(masks[1], 2_000_001)
    for got, mask in ((first, masks[0]), (second, masks[1])):
        for a, b in zip(got, tfp.frontier_pack_plain(mask, 2_000_001)):
            assert torch.equal(a, b)


def test_frontier_pack_takes_an_unaligned_mask(cuda):
    rng = np.random.default_rng(12)
    mask = torch.from_numpy(rng.random(100_000) < 0.5).to(cuda)[3:]   # 16-byte misaligned
    for a, b in zip(tfp.frontier_pack_cuda(mask, 99_997), tfp.frontier_pack_plain(mask, 99_997)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("combine", ["min", "max", "sum"])
@pytest.mark.parametrize("d", [1, 3])
def test_segment_reduce_matches_plain(cuda, combine, d):
    rng = np.random.default_rng(d)
    e, s = 20000, 7                       # segments of ~2,800 rows: block tier
    vals = torch.from_numpy(rng.random((e, d)).astype(np.float32)).to(cuda)
    vals = vals[:, 0].contiguous() if d == 1 else vals
    sid = torch.from_numpy(np.sort(rng.integers(-1, s + 1, e)).astype(np.int32)).to(cuda)
    a = tsr.segment_reduce_cuda(vals, sid, s, combine)
    b = tsr.segment_reduce_plain(vals, sid, s, combine)
    if combine == "sum":
        assert torch.equal(a, tsr.segment_reduce_cuda(vals, sid, s, combine))
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(a, b)


TIER_EDGES = [1, tsr.THREAD_SEG, tsr.THREAD_SEG + 1, 32, 33, tsr.LONG_SEG, tsr.LONG_SEG + 1]


def _tier_case(d, seed):
    """Sorted ids with segments on each side of every tier limit (long ones
    first and last), gaps and out-of-range ids at both ends."""
    rng = np.random.default_rng(seed)
    lens = [tsr.LONG_SEG + 1] + TIER_EDGES + [int(x) for x in rng.integers(1, 70, 40)] \
        + TIER_EDGES[::-1] + [5000, tsr.LONG_SEG + 1]
    seg = np.cumsum(rng.integers(1, 4, len(lens)))
    num = int(seg[-1]) + 3
    ids = np.concatenate([[-4, -1], np.repeat(seg, lens), [num, num + 2]]).astype(np.int32)
    vals = rng.random((ids.shape[0], d)).astype(np.float32)
    return (vals[:, 0] if d == 1 else vals), ids, num


def _check_against_ordered(vals, sid, num):
    for combine in ("sum", "min", "max"):
        a = tsr.segment_reduce_cuda(vals, sid, num, combine)
        o = tsr.segment_reduce_ordered(vals, sid, num, combine)
        assert torch.equal(_bits(a), _bits(o)), combine
        assert torch.equal(_bits(a), _bits(tsr.segment_reduce_cuda(vals, sid, num, combine)))
        if combine == "sum":     # float64: index_add_'s float32 order varies
            b = tsr.segment_reduce_plain(vals.double(), sid, num, combine)
            torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-6)
        else:
            b = tsr.segment_reduce_plain(vals, sid, num, combine)
            assert torch.equal(_bits(a), _bits(b)), combine


@pytest.mark.parametrize("d", [1, 3, 64])
def test_segment_reduce_bit_equal_to_ordered_at_tier_edges(cuda, d):
    vals, ids, num = _tier_case(d, seed=10 + d)
    _check_against_ordered(torch.from_numpy(vals).to(cuda), torch.from_numpy(ids).to(cuda), num)


@pytest.mark.parametrize("case", ["num_far_above_e", "all_out_of_range", "all_past_num",
                                  "e_zero", "d_gt_1_empty", "one_long_segment"])
def test_segment_reduce_bit_equal_to_ordered_edge_cases(cuda, case):
    rng = np.random.default_rng(5)
    d = 1
    if case == "num_far_above_e":
        ids = np.repeat(np.sort(rng.choice(1_000_000, 1000, replace=False)),
                        rng.integers(1, 12, 1000))
        num = 1_000_003
    elif case == "all_out_of_range":
        ids, num, d = np.array([-3, -2, 9, 9, 12]), 9, 3
    elif case == "all_past_num":
        ids, num = np.full(4000, 20), 10
    elif case == "one_long_segment":
        ids, num = np.full(100_000, 2), 5
    else:
        ids, num, d = np.zeros(0), 7, (1 if case == "e_zero" else 64)
    v = rng.random((len(ids), d)).astype(np.float32)
    vals = torch.from_numpy(v[:, 0] if d == 1 else v).to(cuda)
    _check_against_ordered(vals, torch.from_numpy(ids.astype(np.int32)).to(cuda), num)


@pytest.mark.parametrize("w,shift", [(4, 1), (32, 1), (256, 1), (3, 1), (5, 0), (12, 0),
                                     (32, 2), (256, 3)])
def test_ell_combine_vector_and_scalar_variants_bit_equal_to_plain(cuda, w, shift):
    """W % 4 == 0 on an aligned slice takes the 16-byte variant, a view
    `shift` elements into its storage the scalar one; both are bit-equal."""
    r, n = 45, 300
    rng = np.random.default_rng(w + shift)
    nbr = torch.from_numpy(rng.integers(0, n + 1, r * w + shift).astype(np.int32)).to(cuda)
    wgt = torch.from_numpy(rng.random(r * w + shift).astype(np.float32)).to(cuda)
    nbr, wgt = nbr[shift:].view(r, w), wgt[shift:].view(r, w)
    assert tell.vector_layout(w, nbr.data_ptr(), wgt.data_ptr()) is (w % 4 == 0 and shift == 0)
    v = rng.random(n + 1).astype(np.float32)
    v[::7] = tell.BIG
    vals = torch.from_numpy(v).to(cuda)
    for op in tell.COMPUTE_OPS:
        for comb in tell.COMBINE_OPS:
            a = tell.ell_combine_cuda(nbr, wgt, vals, op, comb)
            b = tell.ell_combine_plain(nbr, wgt, vals, op, comb)
            assert torch.equal(_bits(a), _bits(b)), (op, comb)


@pytest.mark.parametrize("name", ["bfs", "sssp", "wcc", "pagerank", "kcore", "bp"])
def test_kernel_pull_bit_equal_to_torch_pull(cuda, name):
    g = G.rmat(12, 16, seed=1, device=cuda)
    pack = pack_ell(g.inc)
    prog = A.ALL[name](0) if name in ("bfs", "sssp") else A.ALL[name]()
    cfg = E.EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges)
    ops.reset_launches()
    mk, sk = E.run(prog, g, pack, cfg)
    assert ops.launch_counts()["segment_reduce"] > 0
    mt, st = E.run(prog, g, pack, E.EngineConfig(frontier_cap=g.n_nodes,
                                                 edge_cap=g.n_edges, pull_impl="torch"))
    for k in mk:
        assert torch.equal(_bits(mk[k]), _bits(mt[k])), k
    for k in sk:
        assert torch.equal(sk[k], st[k]), k


@pytest.mark.parametrize("r,w,n", [(8, 4, 50), (37, 32, 100), (29, 256, 700), (9, 3, 40)])
def test_overlay_bit_equal_to_plain_and_neutralized(cuda, r, w, n):
    rng = np.random.default_rng(r + w)
    nbr = torch.from_numpy(rng.integers(0, n + 1, (r, w)).astype(np.int32)).to(cuda)
    wgt = torch.from_numpy(rng.random((r, w)).astype(np.float32)).to(cuda)
    vals = torch.from_numpy(rng.random(n + 1).astype(np.float32)).to(cuda)
    dead = torch.from_numpy(rng.random((r, w)) < 0.3).to(cuda)
    neutral = tell.neutralize(nbr, dead, n)
    for op in tell.COMPUTE_OPS:
        for comb in tell.COMBINE_OPS:
            a = tell.ell_combine_cuda(nbr, wgt, vals, op, comb, dead)
            b = tell.ell_combine_plain(nbr, wgt, vals, op, comb, dead)
            c = tell.ell_combine_cuda(neutral, wgt, vals, op, comb)
            assert torch.equal(_bits(a), _bits(b)), (op, comb)
            assert torch.equal(_bits(a), _bits(c)), (op, comb)


@pytest.mark.parametrize("r,w,n,d", [(13, 1, 50, 8), (40, 3, 90, 10), (64, 32, 300, 64),
                                     (29, 256, 700, 70), (8, 16, 40, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_spmm_matches_plain(cuda, r, w, n, d, dtype):
    rng = np.random.default_rng(r * d)
    nbr = torch.from_numpy(rng.integers(0, n + 1, (r, w)).astype(np.int32)).to(cuda)
    wgt = torch.from_numpy(rng.random((r, w)).astype(np.float32)).to(cuda)
    f = rng.random((n + 1, d)).astype(np.float32)
    f[-1] = 0.0
    feats = torch.from_numpy(f).to(cuda).to(dtype)
    a = tell.ell_spmm_cuda(nbr, wgt, feats)
    b = tell.ell_spmm_plain(nbr, wgt, feats)
    assert a.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    else:       # both round a float32 sum; the sums differ in order only
        torch.testing.assert_close(a.float(), b.float(), rtol=1.6e-2, atol=1e-2)


#: D in {1, 3, 10, 64, 70, 128, 256} x K in {1, 39, 200} at B = 37 (not a
#: multiple of a block's bags), then B = 0, a B of whole blocks plus one,
#: several bags a warp with a ragged last warp, and the shapes of before
BAG_CARD_SHAPES = ([(300, d, 37, k) for d in (1, 3, 10, 64, 70, 128, 256) for k in (1, 39, 200)]
                   + [(500, 10, 0, 39), (500, 64, 0, 1), (2000, 10, 4001, 39),
                      (80, 10, 13, 1), (30, 1, 50, 2), (1000, 10, 100, 39),
                      (50, 64, 33, 4), (70, 70, 5, 1), (300, 3, 17, 200)])


def _same_bits(a, b):
    """Bit-equal, a NaN anywhere matching a NaN (its payload aside)."""
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(_bits(a)[~nan], _bits(b)[~nan]))


def _check_bag(table, idx, mode):
    """Sum and mean bit-equal to `embedding_bag_ordered` and to a second call;
    max bit-equal to the plain version; all within rtol 1e-5 of plain."""
    a = tbag.embedding_bag_cuda(table, idx, mode)
    p = tbag.embedding_bag_plain(table, idx, mode)
    if mode == "max":
        assert _same_bits(a, p)
    else:
        assert _same_bits(a, tbag.embedding_bag_ordered(table, idx, mode))
        assert _same_bits(a, tbag.embedding_bag_cuda(table, idx, mode))
        fin = torch.isfinite(p)
        torch.testing.assert_close(a[fin], p[fin], rtol=1e-5, atol=1e-5)
    return a


@pytest.mark.parametrize("v,d,b,k", BAG_CARD_SHAPES)
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_plain(cuda, v, d, b, k, mode):
    """Ids from [-V - 3, V + 3): wrapped and clamped as the plain version."""
    rng = np.random.default_rng(v + k + d + b)
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(-v - 3, v + 3, (b, k)).astype(np.int32)).to(cuda)
    assert _check_bag(table, idx, mode).shape == (b, d)


@pytest.mark.parametrize("idx,want", [
    ([[-1, 0], [5, -5]], {"sum": [[9, 11, 13], [9, 11, 13]]}),
    ([[-9, 0], [4, -4]], {"max": [[0, 1, 2], [9, 10, 11]]})])
def test_embedding_bag_wraps_negative_ids_on_the_card(cuda, idx, want):
    table = torch.arange(12, dtype=torch.float32, device=cuda).reshape(4, 3)
    ids = torch.tensor(idx, dtype=torch.int32, device=cuda)
    for mode in ("sum", "mean", "max"):
        out = _check_bag(table, ids, mode)
        assert torch.equal(out.cpu(), tbag.embedding_bag_plain(table.cpu(), ids.cpu(), mode))
        if mode in want:
            assert out.tolist() == want[mode]


@pytest.mark.parametrize("d", [10, 64, 3])
def test_embedding_bag_nan_propagates(cuda, d):
    rng = np.random.default_rng(d)
    t = rng.standard_normal((50, d)).astype(np.float32)
    t[7, d // 2] = np.nan
    table = torch.from_numpy(t).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 50, (20, 39)).astype(np.int32)).to(cuda)
    idx[3, 11] = 7
    for mode in ("sum", "mean", "max"):
        out = _check_bag(table, idx, mode)
        assert bool(torch.isnan(out[3, d // 2])), mode


@pytest.mark.parametrize("d,shift", [(64, 1), (10, 1), (64, 2), (128, 3)])
def test_embedding_bag_unaligned_table_view(cuda, d, shift):
    """A table view `shift` floats into its storage takes narrower loads;
    `bag_layout` names them, and the fold order follows."""
    rng = np.random.default_rng(d + shift)
    flat = torch.from_numpy(rng.standard_normal(200 * d + shift).astype(np.float32)).to(cuda)
    table = flat[shift:].view(200, d)
    idx = torch.from_numpy(rng.integers(-203, 203, (45, 39)).astype(np.int32)).to(cuda)
    assert tbag.bag_layout(d, 39, table.data_ptr())[0] < tbag.bag_layout(d, 39, 4096)[0]
    for mode in ("sum", "mean", "max"):
        _check_bag(table, idx, mode)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [(1, 2, 2, 32, 32, 16), (2, 4, 2, 64, 64, 32),
                                               (1, 8, 1, 100, 100, 64), (2, 4, 2, 16, 80, 32),
                                               (1, 4, 4, 70, 130, 128), (1, 2, 1, 1, 37, 24),
                                               (1, 32, 8, 1024, 1024, 128),
                                               # across the tensor-core kernel's 128-row tiles
                                               (2, 4, 2, 200, 333, 64), (1, 6, 3, 300, 300, 128),
                                               (1, 4, 2, 130, 400, 128), (1, 4, 1, 257, 513, 96),
                                               (2, 2, 1, 150, 150, 8), (1, 4, 2, 150, 170, 12)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, b, hq, hkv, sq, skv, d, causal, dtype):
    rng = np.random.default_rng(sq * d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda).to(dtype)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    ops.reset_launches()
    a = tfa.flash_attention_cuda(q, k, v, causal)
    assert ops.launch_counts()[tfa.route(dtype, d)] == 1
    p = tfa.attention_plain(q, k, v, causal)
    assert a.dtype == dtype and a.shape == q.shape
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(a.float(), p.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:     # long rows average many values: hold the norm too
        af, pf = a.float(), p.float()
        assert float((af - pf).norm() / pf.norm()) <= tfa.BF16_REL_ERR
        # and sharply, against the plain version that rounds where the kernels do
        rf = tfa.attention_rounded(q, k, v, causal).float()
        assert float((af - rf).norm() / rf.norm()) <= tfa.ROUNDED_REL_ERR


@pytest.mark.parametrize("dtype,kernel,other,tol", [
    (torch.bfloat16, "flash_attention", "flash_attention_f32", 5e-2),
    (torch.float32, "flash_attention_f32", "flash_attention", 2e-4)])
def test_gqa_attention_flash_launches_the_kernel(cuda, dtype, kernel, other, tol):
    """bfloat16 (head dim 32) takes the wgmma kernel, float32 the TF32
    mma.sync one; each call launches one kernel and not the other."""
    torch.manual_seed(0)
    d, h, hkv, dh = 256, 8, 2, 32
    p = {"wq": torch.randn(d, h * dh, device=cuda) / 16,
         "wk": torch.randn(d, hkv * dh, device=cuda) / 16,
         "wv": torch.randn(d, hkv * dh, device=cuda) / 16,
         "wo": torch.randn(h * dh, d, device=cuda) / 16}
    p = {key: w.to(dtype) for key, w in p.items()}
    x = torch.randn(2, 96, d, device=cuda).to(dtype)
    pos = torch.arange(96, device=cuda).expand(2, 96)
    ops.reset_launches()
    a, _ = TL.gqa_attention(x, p, n_heads=h, n_kv=hkv, positions=pos, use_flash=True)
    counts = ops.launch_counts()
    assert counts[kernel] == 1 and counts[other] == 0
    b, _ = TL.gqa_attention(x, p, n_heads=h, n_kv=hkv, positions=pos, use_flash=False)
    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


F32_FLASH_SHAPES = [(1, 2, 2, 32, 32, 16), (2, 4, 2, 64, 64, 32), (1, 8, 1, 100, 100, 64),
                    (2, 4, 2, 16, 80, 32), (1, 4, 4, 70, 130, 128), (1, 2, 1, 1, 37, 24),
                    (2, 4, 2, 200, 333, 64), (1, 4, 1, 257, 513, 96), (2, 2, 1, 150, 150, 8),
                    (1, 4, 2, 150, 170, 12), (1, 32, 8, 1024, 1024, 128),
                    (1, 32, 8, 1, 2048, 128)]       # one decode row


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", F32_FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_matches_plain_and_3xtf32(cuda, b, hq, hkv, sq, skv, d, causal):
    """The TF32 kernel in float32 within 2e-4 of the plain attention and of
    `attention_3xtf32`, the plain version that splits as it does."""
    rng = np.random.default_rng(skv * d + sq)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    ops.reset_launches()
    a = tfa.flash_attention_cuda(q, k, v, causal)
    assert ops.launch_counts()[tfa.TF32] == 1
    torch.testing.assert_close(a, tfa.attention_plain(q, k, v, causal), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(a, tfa.attention_3xtf32(q, k, v, causal), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_d12_takes_the_tf32_kernel(cuda, causal):
    """bfloat16 with D % 8 != 0 goes through the TF32 kernel (big halves only):
    held at 5e-2, BF16_REL_ERR and ROUNDED_REL_ERR."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
               .to(torch.bfloat16) for s in ((2, 6, 140, 12), (2, 3, 260, 12),
                                              (2, 3, 260, 12)))
    ops.reset_launches()
    a = tfa.flash_attention_cuda(q, k, v, causal)
    assert ops.launch_counts()[tfa.TF32] == 1 and a.dtype == torch.bfloat16
    p = tfa.attention_plain(q, k, v, causal)
    torch.testing.assert_close(a.float(), p.float(), rtol=5e-2, atol=5e-2)
    af, pf = a.float(), p.float()
    assert float((af - pf).norm() / pf.norm()) <= tfa.BF16_REL_ERR
    rf = tfa.attention_rounded(q, k, v, causal).float()
    assert float((af - rf).norm() / rf.norm()) <= tfa.ROUNDED_REL_ERR


def _spmm_case(r, w, n, d, sentinels, seed, shift=0, fshift=0, dtype=torch.float32):
    """nbr with a share of sentinel slots anywhere in a row; nbr and wgt (and
    the features) optionally views `shift` (`fshift`) elements into their
    storage."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, n, r * w + shift).astype(np.int32)
    nb[rng.random(r * w + shift) < sentinels] = n
    nbr = torch.from_numpy(nb).cuda()[shift:].view(r, w)
    wgt = torch.from_numpy(rng.random(r * w + shift).astype(np.float32)).cuda()[shift:]
    f = rng.random((n + 2) * d).astype(np.float32)
    f[n * d:(n + 1) * d] = 0.0
    feats = torch.from_numpy(f).cuda().to(dtype)[fshift:fshift + (n + 1) * d]
    return nbr, wgt.view(r, w), feats.view(n + 1, d)


@pytest.mark.parametrize("r,w,n,d", [(300, 32, 1000, 64), (41, 256, 900, 70),
                                     (97, 4, 60, 10), (29, 256, 700, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_spmm_twice_bit_identical_with_sentinels_mid_row(cuda, r, w, n, d, dtype):
    """A third of the slots sentinels at random places in their rows: within
    the limits of the plain version, and the same bits on a second call."""
    nbr, wgt, feats = _spmm_case(r, w, n, d, 0.3, r + d, dtype=dtype)
    a = tell.ell_spmm_cuda(nbr, wgt, feats)
    assert torch.equal(a, tell.ell_spmm_cuda(nbr, wgt, feats))
    b = tell.ell_spmm_plain(nbr, wgt, feats)
    if dtype == torch.float32:
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(a.float(), b.float(), rtol=1.6e-2, atol=1e-2)


@pytest.mark.parametrize("w", [4, 32, 256, 3])
def test_ell_spmm_slice_with_no_live_slot_is_zero(cuda, w):
    nbr, wgt, feats = _spmm_case(50, w, 80, 64, 1.0, w)
    ops.reset_launches()
    a = tell.ell_spmm_cuda(nbr, wgt, feats)
    assert ops.launch_counts()["ell_spmm"] == 1
    assert torch.equal(a, torch.zeros_like(a))


@pytest.mark.parametrize("w,shift,fshift,d", [(32, 1, 0, 64), (256, 1, 0, 70), (32, 0, 1, 64),
                                             (4, 3, 2, 64), (32, 0, 2, 70)])
def test_ell_spmm_unaligned_views_take_the_scalar_variants(cuda, w, shift, fshift, d):
    """Ids and weights 4 bytes into their storage take 4-byte id loads;
    features 4 or 8 bytes in take narrower feature loads; all agree."""
    r, n = 60, 500
    nbr, wgt, feats = _spmm_case(r, w, n, d, 0.3, w + shift + fshift, shift, fshift)
    out = torch.empty(r, d, device=cuda)
    vec, fvec = tell.spmm_layout(w, d, torch.float32, nbr.data_ptr(), wgt.data_ptr(),
                                 feats.data_ptr(), out.data_ptr())
    assert vec is (shift == 0)
    assert fvec == {0: 4 if d % 4 == 0 else 2, 1: 1, 2: 2}[fshift]
    a = tell.ell_spmm_cuda(nbr, wgt, feats)
    torch.testing.assert_close(a, tell.ell_spmm_plain(nbr, wgt, feats), rtol=1e-5, atol=1e-5)
