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
from repro_torch.kernels import frontier_pack as tfp
from repro_torch.kernels import ops
from repro_torch.kernels import segment_reduce as tsr

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


@pytest.mark.parametrize("n,density,cap", [(3001, 0.5, 3001), (5000, 0.9, 100),
                                           (1024, 0.0, 1024), (7, 1.0, 0)])
def test_frontier_pack_bit_equal_to_plain(cuda, n, density, cap):
    rng = np.random.default_rng(n)
    mask = torch.from_numpy(rng.random(n) < density).to(cuda)
    for a, b in zip(tfp.frontier_pack_cuda(mask, cap), tfp.frontier_pack_plain(mask, cap)):
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
