"""The torch generators: the same edges for the same seed, the Graph500
relabelling a permutation, the shapes and ranges the configurations state."""

from __future__ import annotations

import pytest
import torch
from conftest import REPO

from graphbench import gen, harness

BENCH = harness.load_benchmark(REPO)
CONFIGS = {c["name"]: dict(harness.config_of(REPO, BENCH, c["name"]), scale=9)
           for c in BENCH["configs"]}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_same_seed_same_edges_other_seed_other_edges(name):
    a = gen.draw(CONFIGS[name], 2**31 + 11, "cpu")
    b = gen.draw(CONFIGS[name], 2**31 + 11, "cpu")
    c = gen.draw(CONFIGS[name], 2**31 + 12, "cpu")
    for x, y in ((a.src, b.src), (a.dst, b.dst), (a.w, b.w)):
        assert torch.equal(x, y)
    assert not torch.equal(a.src, c.src)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_shapes_and_ranges(name):
    cfg = CONFIGS[name]
    e = gen.draw(cfg, 3, "cpu")
    m = cfg["edge_factor"] << cfg["scale"]
    assert e.n == 1 << cfg["scale"] and e.src.shape == e.dst.shape == e.w.shape == (m,)
    assert int(e.src.min()) >= 0 and int(e.src.max()) < e.n
    assert e.w.dtype == torch.float32 and torch.equal(e.w, e.w.round())
    lo, hi = cfg["weights"]
    assert float(e.w.min()) == lo and float(e.w.max()) == hi


def test_relabelling_is_a_permutation_of_the_kronecker_ids():
    g1, g2 = gen.generator(5, "cpu"), gen.generator(5, "cpu")
    src, dst = gen.kronecker_ids(10, 16, 0.57, 0.19, 0.19, g1, "cpu")
    perm = gen.permutation(1 << 10, g1, "cpu")
    assert torch.equal(torch.sort(perm).values, torch.arange(1 << 10))
    rs, rd = gen.kronecker(10, 16, 0.57, 0.19, 0.19, g2, "cpu")
    assert torch.equal(rs, perm[src]) and torch.equal(rd, perm[dst])
    # before relabelling the hub is vertex 0 (all bits 0 is the likeliest id)
    deg = torch.bincount(torch.cat([src, dst]), minlength=1 << 10)
    assert int(deg.argmax()) == 0
    rdeg = torch.bincount(torch.cat([rs, rd]), minlength=1 << 10)
    assert torch.equal(torch.sort(deg).values, torch.sort(rdeg).values)
    assert int(rdeg.argmax()) == int(perm[0])


def test_quadrant_shares_follow_the_initiator():
    g = gen.generator(1, "cpu")
    src, dst = gen.kronecker_ids(1, 1 << 16, 0.57, 0.19, 0.19, g, "cpu")
    share = torch.bincount(src * 2 + dst, minlength=4).double() / src.numel()
    assert torch.allclose(share, torch.tensor([0.57, 0.19, 0.19, 0.05], dtype=torch.float64),
                          atol=0.01)


def test_sources_have_nonzero_degree_and_follow_the_seed():
    e = gen.draw(CONFIGS["gap-kron23"], 9, "cpu")
    deg = gen.degrees(e)
    s = gen.sources(e, 50, 9, salt=1)
    assert len(set(s)) == 50 and all(int(deg[v]) > 0 for v in s)
    assert s == gen.sources(e, 50, 9, salt=1) and s != gen.sources(e, 50, 9, salt=2)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_seeds_relabel_one_graph_and_reorder_one_pool(name):
    a, b = gen.draw(CONFIGS[name], 1, "cpu"), gen.draw(CONFIGS[name], 2, "cpu")
    ia, ib = torch.argsort(a.perm), torch.argsort(b.perm)
    assert torch.equal(ia[a.src], ib[b.src]) and torch.equal(ia[a.dst], ib[b.dst])
    assert torch.equal(a.w, b.w) and not torch.equal(a.src, b.src)
    sa, sb = gen.sources(a, 40, 1, salt=1), gen.sources(b, 40, 2, salt=1)
    base_a, base_b = ia[torch.tensor(sa)].tolist(), ib[torch.tensor(sb)].tolist()
    assert sorted(base_a) == sorted(base_b) and base_a != base_b
