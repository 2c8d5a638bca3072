"""The port's baseline engines (`repro_torch.core.baselines`) against the
reference's (`repro.core.baselines`) and the port's own solo engine, on the
shared rmat and road fixtures: the cases of tests/test_system.py:114-151.

Min programs agree bit for bit; sums (the atomic baseline's unordered adds,
pagerank) within rtol 1e-5 of the reference's baseline.
"""

import numpy as np
import pytest

from repro.core import algorithms as JA
from repro.core import baselines as JB
from repro.core import engine as JE
from repro_torch import interop
from repro_torch.core import algorithms as TA
from repro_torch.core import baselines as TB
from repro_torch.core import engine as TE
from repro_torch.graph import packing as tpacking


@pytest.fixture(scope="module")
def port(rmat_graph, road_graph):
    out = {}
    for key, g in (("rmat", rmat_graph), ("road", road_graph)):
        tg = interop.graph_from_numpy(interop.csr_arrays(g.out), device="cpu")
        out[key] = (tg, tpacking.pack_ell(tg.inc))
    return out


def _full_cfgs(g):
    n, m = g.n_nodes, g.n_edges
    return JE.EngineConfig(frontier_cap=n, edge_cap=m), TE.EngineConfig(frontier_cap=n, edge_cap=m)


def _solo(tg, tp, name):
    n, m = tg.n_nodes, tg.n_edges
    prog = TA.pagerank() if name == "pagerank" else TA.ALL[name](0)
    return TE.run(prog, tg, tp, TE.EngineConfig(frontier_cap=n, edge_cap=m))[0]


@pytest.mark.parametrize("graph", ["rmat", "road"])
@pytest.mark.parametrize("name", ["bfs", "sssp", "pagerank"])
def test_atomic_engine_agrees(rmat_graph, road_graph, port, graph, name):
    g = rmat_graph if graph == "rmat" else road_graph
    tg, tp = port[graph]
    cj, ct = _full_cfgs(g)
    jprog, tprog = ((JA.pagerank(), TA.pagerank()) if name == "pagerank"
                    else (JA.ALL[name](0), TA.ALL[name](0)))
    field = "rank" if name == "pagerank" else "dist"
    mj, sj = JB.run_atomic(jprog, g, cj)
    mt, st = TB.run_atomic(tprog, tg, ct)
    assert int(sj["iterations"]) == int(st["iterations"])
    if name == "pagerank":
        np.testing.assert_allclose(np.asarray(mj[field]), mt[field].numpy(), rtol=1e-5, atol=1e-9)
    else:
        assert np.array_equal(np.asarray(mj[field]), mt[field].numpy())
        assert np.array_equal(mt[field].numpy(), _solo(tg, tp, name)[field].numpy())


@pytest.mark.parametrize("graph", ["rmat", "road"])
def test_batch_filter_engine_agrees(rmat_graph, road_graph, port, graph):
    g = rmat_graph if graph == "rmat" else road_graph
    tg, tp = port[graph]
    cj, ct = _full_cfgs(g)
    mj, sj = JB.run_batch_filter(JA.bfs(0), g, cj)
    mt, st = TB.run_batch_filter(TA.bfs(0), tg, ct)
    assert int(sj["iterations"]) == int(st["iterations"])
    assert np.array_equal(np.asarray(mj["dist"]), mt["dist"].numpy())
    assert np.array_equal(mt["dist"].numpy(), _solo(tg, tp, "bfs")["dist"].numpy())


@pytest.mark.parametrize("name", ["bfs", "sssp"])
def test_ballot_only_agrees(rmat_graph, rmat_pack, port, name):
    tg, tp = port["rmat"]
    cj, ct = _full_cfgs(rmat_graph)
    mj, sj = JB.run_filter_ablation(JA.ALL[name](0), rmat_graph, rmat_pack, cj, "ballot")
    mt, st = TB.run_filter_ablation(TA.ALL[name](0), tg, tp, ct, "ballot")
    assert int(sj["iterations"]) == int(st["iterations"]) and not bool(st["failed_overflow"])
    assert np.array_equal(np.asarray(mj["dist"]), mt["dist"].numpy())
    assert np.array_equal(mt["dist"].numpy(), _solo(tg, tp, name)["dist"].numpy())


def test_online_only_works_on_road_overflows_on_social(rmat_graph, rmat_pack, road_graph,
                                                       road_pack, port):
    """Paper Fig. 12: the online filter alone overflows on the power-law
    graph and carries the high-diameter road graph to the end."""
    tg, tp = port["road"]
    small_j = JE.EngineConfig(frontier_cap=256, edge_cap=2048)
    small_t = TE.EngineConfig(frontier_cap=256, edge_cap=2048)
    mj, sj = JB.run_filter_ablation(JA.bfs(0), road_graph, road_pack, small_j, "online")
    mt, st = TB.run_filter_ablation(TA.bfs(0), tg, tp, small_t, "online")
    assert not bool(st["failed_overflow"])
    assert int(sj["iterations"]) == int(st["iterations"])
    assert np.array_equal(np.asarray(mj["dist"]), mt["dist"].numpy())
    assert np.array_equal(mt["dist"].numpy(), _solo(tg, tp, "bfs")["dist"].numpy())

    tg, tp = port["rmat"]
    m = rmat_graph.n_edges
    _, sj = JB.run_filter_ablation(JA.bfs(0), rmat_graph, rmat_pack,
                                   JE.EngineConfig(frontier_cap=64, edge_cap=m), "online")
    _, st = TB.run_filter_ablation(TA.bfs(0), tg, tp,
                                   TE.EngineConfig(frontier_cap=64, edge_cap=m), "online")
    assert bool(st["failed_overflow"]) and bool(sj["failed_overflow"])
    assert int(sj["iterations"]) == int(st["iterations"])


def test_unknown_filter_is_refused(port):
    tg, tp = port["road"]
    with pytest.raises(ValueError):
        TB.run_filter_ablation(TA.bfs(0), tg, tp, TE.EngineConfig(frontier_cap=8, edge_cap=8),
                               "batch")
