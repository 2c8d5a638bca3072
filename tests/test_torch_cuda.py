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


@pytest.mark.parametrize("v,d,b,k", [(1000, 10, 100, 39), (50, 64, 33, 4), (70, 70, 5, 1),
                                     (300, 3, 17, 200)])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_plain(cuda, v, d, b, k, mode):
    rng = np.random.default_rng(v + k)
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, v, (b, k)).astype(np.int32)).to(cuda)
    a = tbag.embedding_bag_cuda(table, idx, mode)
    p = tbag.embedding_bag_plain(table, idx, mode)
    if mode == "max":
        assert torch.equal(a, p)
    else:
        torch.testing.assert_close(a, p, rtol=1e-5, atol=1e-5)


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
    """bfloat16 (head dim 32) takes the tensor-core kernel, float32 the
    CUDA-core one; each call launches one kernel and not the other."""
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
