"""The plain reference agrees with the port at scale 10 on the CPU, and with
scipy's graph routines, on both configurations' graphs."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csg
import torch
from conftest import REPO

from graphbench import compare, gen, harness, reference
from graphbench.checks import ppr as ppr_check

BENCH = harness.load_benchmark(REPO)
PARAMS = harness.traffic_of(REPO, "ppr64")["params"]["ppr"]


@pytest.fixture(scope="module", params=[c["name"] for c in BENCH["configs"]])
def graph(request):
    from repro_torch.graph import from_edges, pack_ell

    cfg = dict(harness.config_of(REPO, BENCH, request.param), scale=10)
    e = gen.draw(cfg, 2**31 + 5, "cpu")
    g = from_edges(e.src, e.dst, e.n, e.w, directed=False, device="cpu")
    return e, g, pack_ell(g.inc), reference.RefGraph(e), gen.sources(e, 6, 5, salt=1)


def scipy_dist(e, root, weighted):
    keep = (e.src != e.dst).numpy()
    s, d, w = e.src.numpy()[keep], e.dst.numpy()[keep], e.w.numpy()[keep]
    w = w if weighted else np.ones_like(w)
    # scipy sums repeated entries; the least weight of a repeated pair wins
    coo = sp.coo_matrix((w, (s, d)), shape=(e.n, e.n))
    order = np.lexsort((coo.data, coo.row * e.n + coo.col))
    key = (coo.row * e.n + coo.col)[order]
    first = np.r_[True, key[1:] != key[:-1]]
    a = sp.csr_matrix((coo.data[order][first], (coo.row[order][first],
                                                coo.col[order][first])), shape=(e.n, e.n))
    return csg.dijkstra(a, directed=False, indices=root, unweighted=not weighted)


def test_reference_bfs_and_sssp_equal_scipy(graph):
    e, _, _, ref, roots = graph
    for r in roots:
        assert np.array_equal(reference.bfs(ref.adj, r).numpy(), scipy_dist(e, r, False))
        assert np.array_equal(reference.sssp(ref.adj, r).numpy(), scipy_dist(e, r, True))


def test_port_bfs_and_sssp_equal_the_reference(graph):
    from repro_torch.core import algorithms as alg
    from repro_torch.core import engine as E

    _, g, pack, ref, roots = graph
    cfg = E.EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges, pull_impl="kernel")
    for r in roots:
        for name, fn in (("bfs", reference.bfs), ("sssp", reference.sssp)):
            m, _ = E.run(alg.ALL[name](0), g, pack, cfg, source=r)
            assert compare.mismatches(m["dist"][:-1], fn(ref.adj, r)) == 0


def test_port_batched_ppr_is_within_float32_rounding_of_the_reference(graph):
    from repro_torch.core import algorithms as alg
    from repro_torch.serving import batch_engine as B
    from repro_torch.serving import default_config

    _, g, pack, ref, roots = graph
    m, _ = B.run_batch(alg.ppr(0, **PARAMS), g, pack, default_config(g), roots)
    want = ppr_check.ranks(ref, roots, PARAMS)
    gaps = [compare.max_gap(m["rank"][:-1, j], want[:, j]) for j in range(len(roots))]
    assert max(gaps) < 1e-6


def test_reference_ppr_columns_sum_to_at_most_one_and_start_at_the_root(graph):
    _, _, _, ref, roots = graph
    got = ppr_check.ranks(ref, roots, PARAMS)
    assert torch.all(got.sum(0) <= 1 + 1e-9)
    for j, r in enumerate(roots):
        assert int(got[:, j].argmax()) == r
