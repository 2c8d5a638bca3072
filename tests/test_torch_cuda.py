"""The port's CUDA kernels on the card, against their plain PyTorch versions,
the engine's kernel pull against its torch pull, and the batched engine on
the card against its plain path on the CPU. Every test is marked `cuda` and
skips without a GPU.

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
from repro_torch.serving import batch_engine as TBE
from repro_torch.serving import default_config

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


# ---------------------------------------------------------------------------
# the batched engine's Q-wide pull, segment_reduce at D = Q, run_batch
# ---------------------------------------------------------------------------


def _other_route(q: int, w: int, vec: bool):
    """The route `batched_layout` does not pick at this Q, laid out as
    `route_layout` lays it out."""
    other = "slots" if tell.batched_layout(q, w, 0, 0).route == "columns" else "columns"
    return tell.route_layout(other, q, w, vec)


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 8, 32, 33, 256])
@pytest.mark.parametrize("q", [1, 2, 3, 4, 8, 16, 17, 32, 64, 65, 128, 130])
def test_ell_combine_batched_bit_equal_to_plain(cuda, w, q):
    """Every op pair, sentinels anywhere in a row, on both routes at every
    Q (the one `batched_layout` picks, through the public wrapper, and the
    other), each with 16-byte columns where Q % 4 == 0 and vals is aligned
    and the scalar variant for other Q and for a vals view 4 bytes into its
    storage; at Q = 1 also bit-equal to the 1-D kernel. Values span six
    decades with BIG among them; sums also fold values of both signs over
    two decades without BIG, so that another association shows."""
    rng = np.random.default_rng(w * 1000 + q)
    r, n = 37, 300
    nb = rng.integers(0, n, (r, w)).astype(np.int32)
    nb[rng.random((r, w)) < 0.3] = n
    nbr = torch.from_numpy(nb).to(cuda)
    wgt = torch.from_numpy(rng.random((r, w)).astype(np.float32)).to(cuda)
    size = (n + 1) * q + 1
    v = (rng.standard_normal(size) * 10 ** rng.uniform(-3, 3, size)).astype(np.float32)
    v[rng.random(size) < 0.2] = tell.BIG
    wide = torch.from_numpy(v).to(cuda)
    # BIG swamps a sum's order: sums also fold values without it
    v = (rng.standard_normal(size) * 10 ** rng.uniform(-1, 1, size)).astype(np.float32)
    cases = [(comb, wide) for comb in tell.COMBINE_OPS] + [("sum", torch.from_numpy(v).to(cuda))]
    for shift in (0, 1):
        vec = q % 4 == 0 and shift == 0
        other = _other_route(q, w, vec)
        for op in tell.COMPUTE_OPS:
            for comb, flat in cases:
                vals = flat[shift:shift + (n + 1) * q].view(n + 1, q)
                assert tell.batched_layout(q, w, vals.data_ptr(), 0).vector is vec
                b = tell.ell_combine_batched_plain(nbr, wgt, vals, op, comb)
                a = tell.ell_combine_batched_cuda(nbr, wgt, vals, op, comb)
                assert torch.equal(_bits(a), _bits(b)), (op, comb, shift)
                c = tell._launch_batched(nbr, wgt, vals, op, comb, other)
                assert torch.equal(_bits(c), _bits(b)), (op, comb, shift, other)
                if q == 1:
                    one = tell.ell_combine_cuda(nbr, wgt, vals[:, 0].contiguous(), op, comb)
                    assert torch.equal(_bits(a[:, 0].contiguous()), _bits(one)), (op, comb)


@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("combine", ["sum", "min", "max"])
def test_segment_reduce_columns_bit_equal_to_the_1d_call(cuda, d, combine):
    """Column q of an (E, D) call is bit-equal to the (E,) call on column q,
    at segment lengths on every side of the tier limits: the batched
    engine's lanes against the solo engine."""
    rng = np.random.default_rng(d)
    edges = [1, tsr.THREAD_SEG, tsr.THREAD_SEG + 1, 32, 33, tsr.LONG_SEG, tsr.LONG_SEG + 1]
    lens = [tsr.LONG_SEG + 1] + edges + [int(x) for x in rng.integers(1, 60, 30)] + [5000]
    seg = np.cumsum(rng.integers(1, 3, len(lens)))
    num = int(seg[-1]) + 2
    ids = torch.from_numpy(np.repeat(seg, lens).astype(np.int32)).to(cuda)
    v = rng.standard_normal((ids.shape[0], d)) * 10 ** rng.uniform(-3, 3, (ids.shape[0], d))
    vals = torch.from_numpy(v.astype(np.float32)).to(cuda)
    wide = tsr.segment_reduce_cuda(vals, ids, num, combine)
    assert torch.equal(_bits(wide), _bits(tsr.segment_reduce_ordered(vals, ids, num, combine)))
    for q in range(d):
        one = tsr.segment_reduce_cuda(vals[:, q].contiguous(), ids, num, combine)
        assert torch.equal(_bits(wide[:, q].contiguous()), _bits(one)), q


@pytest.mark.parametrize("name,field", [("bfs", "dist"), ("sssp", "dist"), ("ppr", "rank")])
def test_run_batch_on_the_card_equals_the_cpu_plain_path(cuda, name, field):
    """rmat(12): the card (`ell_combine_batched`, `segment_reduce` at
    D = Q, `frontier_pack`) against the plain versions on the CPU, bit for
    bit, lanes and stats; every lane also equals the solo engine on the
    card. Its largest in-degree (913) keeps every pull-merge segment within
    THREAD_SEG rows, where the kernel's sum is the plain version's left
    fold; the push's sums are min here."""
    sources = [0, 5, 77, 4095, 5, 1000, 2, 3]
    out = {}
    for dev in ("cpu", cuda):
        g = G.rmat(12, 16, seed=1, device=dev)
        pack = pack_ell(g.inc)
        assert max(int(torch.unique_consecutive(s.row_id, return_counts=True)[1].max())
                   for s in pack.slices if s.rows) <= tsr.THREAD_SEG
        cfg = default_config(g, max_iters=64)
        ops.reset_launches()
        out[str(dev)] = TBE.run_batch(A.ALL[name](0), g, pack, cfg, sources)
        if dev != "cpu":
            counts = ops.launch_counts()
            assert counts["ell_combine_batched"] > 0 and counts["segment_reduce"] > 0
            seq = TBE.run_sequential(lambda: A.ALL[name](0), g, pack, cfg, sources)
            for lane in range(len(sources)):
                assert torch.equal(_bits(out[str(dev)][0][field][:, lane].contiguous()),
                                   _bits(seq[lane][field])), lane
    (mc, sc), (mg, sg) = out["cpu"], out[str(cuda)]
    for k in mc:
        assert torch.equal(_bits(mc[k]), _bits(mg[k].cpu())), k
    for k in ("per_query_iters", "push_iters", "pull_iters", "switches", "mode_trace"):
        assert torch.equal(sc[k], sg[k].cpu()), k


def _serve(dev, telemetry=False):
    """A mixed bfs/sssp/ppr stream over rmat(12) through `GraphServer`:
    completions in order and the pool reads it took."""
    from repro_torch.serving import GraphServer

    g = G.rmat(12, 16, seed=1, device=dev)
    srv = GraphServer(g, pack_ell(g.inc), {"bfs": A.bfs(0), "sssp": A.sssp(0),
                                           "ppr": A.ppr(0)},
                      slots=4, cfg=default_config(g, max_iters=64), queue_cap=12,
                      cache_capacity=8, telemetry=telemetry)
    rng = np.random.default_rng(0)
    reads = TBE.HOST_READS["pool"]
    for i in range(30):
        src = int(rng.integers(0, 4096)) if rng.random() > 0.3 else 5
        while srv.submit(("bfs", "sssp", "ppr")[i % 3], src) is None:
            srv.pump()
        if i == 14:                   # the second wave repeats (algo, 5)
            srv.drain()
    comps = srv.drain()
    return comps, TBE.HOST_READS["pool"] - reads, srv


def test_graph_server_on_the_card_equals_the_cpu_port(cuda):
    """The same stream served on the card and on the CPU: the same rids,
    sources, iterations and cache hits, bfs and sssp results bit-equal,
    ppr within rtol 1e-5, and the same number of pool reads; no lane is
    owned after `drain`."""
    ops.reset_launches()
    got, reads_g, srv = _serve(cuda)
    counts = ops.launch_counts()
    want, reads_c, _ = _serve("cpu")
    assert counts["ell_combine_batched"] > 0 and counts["segment_reduce"] > 0
    assert reads_g == reads_c
    assert all(r is None for p in srv.pools.values() for r in p.lane_rid)
    assert len(got) == len(want) == 30 and any(c.from_cache for c in got)
    for a, b in zip(want, got):
        assert (a.rid, a.algo, a.source, a.iterations, a.from_cache) == (
            b.rid, b.algo, b.source, b.iterations, b.from_cache)
        if a.algo == "ppr":
            np.testing.assert_allclose(b.result, a.result, rtol=1e-5, atol=1e-8)
        else:
            assert np.array_equal(b.result.view(np.int32), a.result.view(np.int32)), a.rid


def test_graph_server_telemetry_is_bit_neutral_on_the_card(cuda):
    plain, _, _ = _serve(cuda)
    tele, _, srv = _serve(cuda, telemetry=True)
    for a, b in zip(plain, tele):
        assert a.rid == b.rid and a.iterations == b.iterations
        assert np.array_equal(a.result.view(np.int32), b.result.view(np.int32)), a.rid
    assert srv.stats()["pools"]["bfs"]["tele"]["pull_edges_scanned"] >= 0


def test_preempt_resume_on_the_card_bit_identical(cuda):
    """ppr_delta on rmat(12) on the card, four lanes of a pool of five: one
    lane preempted after three steps and resumed at once in the spare lane
    (never written with its state, so the saved columns must be written
    back), bit-equal to the same four run through. (The batch-mates stay the
    same: a push's segment sums fold in an order set by the union frontier's
    in-edges, so a lane run beside other lanes need not equal it run
    alone.)"""
    from repro_torch.serving import AlgoPool

    g = G.rmat(12, 16, seed=1, device=cuda)
    pack = pack_ell(g.inc)
    cfg = default_config(g)
    sources = (77, 5, 1000, 2)
    moved = []

    def run(preempt_after):
        pool = AlgoPool("ppr_delta", A.ppr_delta(0), g, pack, cfg, len(sources) + 1)
        for lane, src in enumerate(sources):
            pool.admit(lane, lane, src)
        out = {}
        while pool.live():
            if pool.steps == preempt_after:
                lane = next(i for i, r in enumerate(pool.lane_rid) if r is not None)
                rid = pool.lane_rid[lane]
                saved = pool.preempt(lane)
                to = next(i for i in pool.free_lanes() if i != lane)
                pool.admit_resume(to, rid, saved)
                moved.append((lane, to))
            pool.step()
            out.update({r: (res, it) for _l, r, res, it, _x in pool.harvest()})
        return out

    whole, cut = run(-1), run(3)
    assert len(moved) == 1 and moved[0][0] != moved[0][1], moved
    for rid in range(4):
        assert whole[rid][1] == cut[rid][1]
        assert np.array_equal(whole[rid][0].view(np.int32), cut[rid][0].view(np.int32)), rid


# ---------------------------------------------------------------------------
# streaming on the card
# ---------------------------------------------------------------------------


def test_delta_slice_merge_on_the_card_bit_equal_to_plain(cuda):
    """The delta slice lists receivers in insertion order: 900 and 40
    descending, 900 twice and not side by side. Its merge on the card (a
    stable sort, then `segment_reduce`) is bit-equal, for sum, min and max
    at D = 1 and D = 32, to the kernel's fold order on the sorted ids
    (`segment_reduce_ordered`, on the CPU), and at the inserted receivers
    (segments of two rows) to the plain route on the CPU; the solo
    engine's bfs/sssp over the overlay on the card equal the CPU port's."""
    from repro_torch.core.acc import Combiner
    from repro_torch.streaming import StreamingGraph

    out = {}
    for dev in ("cpu", cuda):
        sg = StreamingGraph(G.rmat(10, 8, seed=7, directed=True, device=dev), delta_cap=64)
        ins = [(3, 900), (17, 40), (600, 900), (5, 40), (1000, 2)]
        assert sg.apply(ins).n_inserted == 5
        s = sg.pack.slices[-1]
        assert not s.rows_ascending and s.row_id[:5].tolist() == [900, 40, 900, 40, 2]
        n = sg.n
        gen = torch.Generator().manual_seed(3)
        res = {}
        for d in (1, 32):
            part = (torch.rand((s.rows, d), generator=gen).squeeze(-1) * 64).to(dev)
            ids, order = torch.sort(s.row_id.cpu(), stable=True)
            for comb in ("sum", "min", "max"):
                res[(d, comb)] = Combiner(comb, "aggregation").segment(
                    part, s.row_id, n + 1, sorted_ids=s.rows_ascending).cpu()
                res[(d, comb, "ordered")] = tsr.segment_reduce_ordered(
                    part.cpu()[order], ids, n + 1, comb, float(
                        {"sum": 0.0, "min": np.inf, "max": -np.inf}[comb]))
        cfg = E.EngineConfig(frontier_cap=n, edge_cap=sg.graph.n_edges, alpha=0.0)
        ops.reset_launches()
        for name in ("bfs", "sssp"):
            m, st = E.run(A.ALL[name](3), sg.graph, sg.pack, cfg, delta=sg.delta)
            assert int(st["pull_iters"]) > 0
            res[name] = m["dist"].cpu()
        if dev != "cpu":
            assert ops.launch_counts()["segment_reduce"] > 0
        out[str(dev)] = res
    card, cpu = out[str(cuda)], out["cpu"]
    for d in (1, 32):
        for comb in ("sum", "min", "max"):
            assert torch.equal(_bits(card[(d, comb)]), _bits(cpu[(d, comb, "ordered")])), (d, comb)
            for v in (900, 40, 2):
                assert torch.equal(_bits(card[(d, comb)][v]), _bits(cpu[(d, comb)][v])), (d, comb, v)
    for name in ("bfs", "sssp"):
        assert torch.equal(_bits(card[name]), _bits(cpu[name])), name


def test_incremental_batch_on_the_card_equals_full_recompute(cuda):
    """rmat(12) on the card, an insert+delete batch: bfs, sssp and wcc
    (monotone) bit-equal to `run_batch` on the same views, ppr_delta
    (residual) within tests/test_ppr_delta.py's ATOL 2e-3; then a
    deletion-only batch: kcore(8) (cascade) and mis (reelect) bit-equal."""
    from repro_torch.streaming import StreamingGraph, incremental_batch

    g = G.rmat(12, 16, seed=1, device=cuda)
    sg = StreamingGraph(g, delta_cap=256)
    cfg = default_config(g, max_iters=256)
    sources = [0, 5, 77, 1000]
    progs = {"bfs": A.bfs(0), "sssp": A.sssp(0), "wcc": A.wcc(),
             "ppr_delta": A.ppr_delta(0), "kcore": A.kcore(8), "mis": A.mis()}
    prev = {k: TBE.run_batch(p, sg.graph, sg.pack, cfg, sources, delta=sg.delta)[0]
            for k, p in progs.items()}
    rng = np.random.default_rng(0)
    ins = [(int(rng.integers(0, 4096)), int(rng.integers(0, 4096)),
            float(rng.integers(1, 65))) for _ in range(32)]
    e = rng.choice(g.n_edges, 16, replace=False)
    src, dst = g.out.src_idx[e].tolist(), g.out.col_idx[e].tolist()
    rep = sg.apply(ins, list(zip(src[:8], dst[:8])))
    assert rep.n_inserted > 0 and rep.n_deleted > 0
    for name in ("bfs", "sssp", "wcc", "ppr_delta"):
        m, info = incremental_batch(progs[name], sg, cfg, sources, prev[name], rep)
        full, _ = TBE.run_batch(progs[name], sg.graph, sg.pack, cfg, sources, delta=sg.delta)
        if name == "ppr_delta":
            assert info["mode"] == "residual-resume"
            assert float((m["rank"] - full["rank"]).abs().max()) < 2e-3
        else:
            assert info["mode"] == "monotone-incremental"
            for k in full:
                assert torch.equal(_bits(m[k]), _bits(full[k])), (name, k)
    for name in ("kcore", "mis"):
        prev[name] = TBE.run_batch(progs[name], sg.graph, sg.pack, cfg, sources,
                                   delta=sg.delta)[0]
    rep = sg.apply(deletes=list(zip(src[8:], dst[8:])))
    for name, mode in (("kcore", "cascade-resume"), ("mis", "reelect-resume")):
        m, info = incremental_batch(progs[name], sg, cfg, sources, prev[name], rep)
        full, _ = TBE.run_batch(progs[name], sg.graph, sg.pack, cfg, sources, delta=sg.delta)
        assert info["mode"] == mode, info
        field = progs[name].param("result", progs[name].primary)
        assert torch.equal(_bits(m[field]), _bits(full[field])), name


def test_streaming_server_on_the_card_verifies_every_completion(capsys, cuda):
    """`stream_graph` on the card: bfs, sssp and ppr_delta at RMAT scale 10,
    two update batches while requests are in flight (one overflowing the
    delta buffer), every completion checked against `run_batch` on the
    views of the version it completed under."""
    from repro_torch.launch import stream_graph

    rc = stream_graph.main(["--scale", "10", "--slots", "4", "--requests", "16",
                            "--update-every", "8", "--inserts", "8", "--deletes", "4",
                            "--delta-cap", "24", "--algos", "bfs,sssp,ppr_delta",
                            "--verify"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "verify: 16/16 OK" in out and out.count("update v") == 2
    assert "rebuild=True" in out


# -- SLO replay and sharded serving ------------------------------------------


@pytest.mark.parametrize("q", [1, 8])
def test_edge_shard_scan_combine_on_the_card(cuda, q):
    """An edge shard's scan Combine: destinations unsorted (the shard's COO
    order), `Combiner.segment` sorts them stably and runs the kernel; sums
    bit-equal to `segment_reduce_ordered` on the sorted order, min and max
    bit-equal to the plain route on the CPU."""
    from repro_torch.core.acc import MAX_VOTE, MIN_VOTE, SUM_AGG

    rng = np.random.default_rng(q)
    e, num = 50_000, 3001
    dst = torch.from_numpy(rng.integers(0, num + 3, e).astype(np.int32))
    dst[::7] = num - 1                                   # hot receivers
    vals = torch.from_numpy(rng.random((e, q)).astype(np.float32))
    order = torch.sort(dst, stable=True)[1]
    want = tsr.segment_reduce_ordered(vals[order], dst[order], num, "sum", 0.0)
    got = SUM_AGG.segment(vals.to(cuda), dst.to(cuda), num)
    assert torch.equal(_bits(got.cpu()), _bits(want))
    for comb in (MIN_VOTE, MAX_VOTE):
        assert torch.equal(_bits(comb.segment(vals.to(cuda), dst.to(cuda), num).cpu()),
                           _bits(comb.segment(vals, dst, num)))


def test_select_edges_on_the_card_equals_the_plain_version(cuda):
    from repro_torch.core import frontier as F

    rng = np.random.default_rng(3)
    for e, density, cap in ((100_000, 0.2, 25_000), (100_000, 0.3, 25_000), (4097, 0.5, 128)):
        mask = torch.from_numpy(rng.random(e) < density)
        got = F.select_edges(mask.to(cuda), cap)
        want = F.select_edges(mask, cap)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), (e, density)


def test_two_by_two_mesh_on_one_card_serves_a_stream_with_an_update(cuda):
    """A (2, 2) mesh of cuda:0: bfs replicated over the query shards, sssp
    and ppr_delta edge-sharded, a stream with one update batch in flight;
    every completion held against `run_batch` on its version's views."""
    from repro_torch import serving as TSV

    g = G.rmat(10, 8, seed=2, device=cuda)
    cfg = default_config(g, max_iters=256)
    mesh = TSV.make_serving_mesh(2, 2, devices=[cuda] * 4)
    progs = {"bfs": A.bfs(0), "sssp": A.sssp(0), "ppr_delta": A.ppr_delta(0)}
    srv = TSV.GraphServer(g, None, progs, slots=4, cfg=cfg, cache_capacity=16, delta_cap=32,
                          result_fields={"ppr_delta": "rank"}, mesh=mesh,
                          placements={"bfs": ("replicated", 2), "sssp": ("edge_sharded", 2),
                                      "ppr_delta": ("edge_sharded", 2)})
    views = {0: (srv.sg.graph, srv.sg.pack, srv.sg.delta)}
    rng = np.random.default_rng(0)
    for i in range(18):
        srv.submit(list(progs)[i % 3], int(rng.integers(0, g.n_nodes)))
        srv.pump()
        if i == 8:
            st = srv.apply_updates(inserts=[(1, 5), (9, 41), (300, 2)],
                                   deletes=[(int(g.out.src_idx[0]), int(g.out.col_idx[0]))])
            views[st["version"]] = (srv.sg.graph, srv.sg.pack, srv.sg.delta)
            assert set(st["shipped"]) == set(progs)
    comps = srv.drain()
    assert len(comps) == 18
    for c in comps:
        gv, pv, dv = views[c.graph_version]
        ref, _ = TBE.run_batch(progs[c.algo], gv, pv, cfg, [c.source], delta=dv)
        want = ref[srv.pools[c.algo].result_field][:-1, 0].cpu().numpy()
        if c.algo == "ppr_delta":
            assert np.abs(c.result - want).max() < 1e-3
        else:
            assert np.array_equal(c.result.view(np.int32), want.view(np.int32)), c.rid


def test_out_of_range_source_served_on_the_card(cuda):
    """Fault 4 on the card: sources n + 1, n + 100, -1 and -(n + 2) are
    served as the reference serves them (the write dropped or landing on
    the scratch row), with no device assert; the context stays usable."""
    g = G.rmat(8, 8, seed=1, device=cuda)
    pack = pack_ell(g.inc)
    n = g.n_nodes
    cfg = E.EngineConfig(frontier_cap=n, edge_cap=g.n_edges)
    cpu_g = G.rmat(8, 8, seed=1, device="cpu")
    cpu_pack = pack_ell(cpu_g.inc)
    for src in (n + 1, n + 100, -1, -(n + 2)):
        for name in ("bfs", "sssp", "ppr", "ppr_delta"):
            m, st = E.run(getattr(A, name)(0), g, pack, cfg, source=src)
            mc, stc = E.run(getattr(A, name)(0), cpu_g, cpu_pack, cfg, source=src)
            field = getattr(A, name)(0).param("result", getattr(A, name)(0).primary)
            assert torch.equal(_bits(m[field].cpu()), _bits(mc[field])), (src, name)
            assert int(st["iterations"]) == int(stc["iterations"])
        mb, _ = TBE.run_batch(A.bfs(0), g, pack, default_config(g), [src, 3])
        assert bool((mb["dist"][:-1, 0] == tell.BIG).all())
    torch.cuda.synchronize()
    assert int(torch.ones(1, device=cuda).sum()) == 1
