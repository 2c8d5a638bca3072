"""The port's solo engine (`repro_torch.core.engine`) against the JAX
reference on the same graphs and initial states.

The reference runs each program once per module under fusion='all'; the
port runs under all three fusion modes. Min/max and integer programs (bfs,
sssp, wcc, kcore, mis) must be bit-equal in metadata, iterations, mode_trace
and fe_trace; the sum programs match to rtol 1e-5, and the two residual
programs (whose Active thresholds on `tol`) to atol = tol. bp and mis start
from identical injected metadata: torch.sin and XLA's sin differ in the last
bit at large arguments.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as JA
from repro.core import engine as JE
from repro.graph import csr as jcsr
from repro_torch import interop
from repro_torch.core import algorithms as TA
from repro_torch.core import engine as TE
from repro_torch.graph import csr as tcsr
from repro_torch.graph import packing as tpacking

EXACT = {"bfs", "sssp", "wcc", "kcore", "mis"}
RESIDUAL = {"ppr_delta", "pagerank_delta"}
FUSIONS = ["all", "pushpull", "none"]


def _np_f32(x):
    return np.asarray(x, np.float32)


def _bp_priors(n):
    x = np.arange(n, dtype=np.float32)
    return _np_f32(0.5 + 0.4 * np.sin(x * np.float32(12.9898)))


def _mis_init(n, backend):
    x = np.arange(n, dtype=np.float32)
    pri = _np_f32(0.5 + 0.49 * np.sin(x * np.float32(12.9898)) + x / np.float32(1e3 * n))
    pri = np.concatenate([pri, _np_f32([-JA.BIG])])
    state = np.zeros(n + 1, np.float32)
    if backend == "jax":
        return ({"sig": jnp.asarray(pri), "pri": jnp.asarray(pri),
                 "state": jnp.asarray(state)}, jnp.arange(n))
    return ({"sig": torch.from_numpy(pri.copy()), "pri": torch.from_numpy(pri.copy()),
             "state": torch.from_numpy(state)}, torch.arange(n, dtype=torch.int32))


def make_programs(name, n):
    j = JA.ALL[name](0) if name in ("bfs", "sssp") else JA.ALL[name]()
    t = TA.ALL[name](0) if name in ("bfs", "sssp") else TA.ALL[name]()
    jkw, tkw = {}, {}
    if name == "bp":
        jkw = {"priors": jnp.asarray(_bp_priors(n))}
        tkw = {"priors": _bp_priors(n)}
    if name == "mis":
        j = dataclasses.replace(j, init=lambda n_, deg: _mis_init(n_, "jax"))
        t = dataclasses.replace(t, init=lambda n_, deg: _mis_init(n_, "torch"))
    return j, t, jkw, tkw


@pytest.fixture(scope="module")
def graphs(rmat_graph, road_graph, rmat_pack, road_pack):
    out = {}
    for key, g, p in (("rmat", rmat_graph, rmat_pack), ("road", road_graph, road_pack)):
        tg = interop.graph_from_numpy(interop.csr_arrays(g.out), device="cpu")
        out[key] = (g, p, tg, tpacking.pack_ell(tg.inc))
    return out


@pytest.fixture(scope="module")
def reference():
    """JAX fusion='all' results, computed once per (graph, program)."""
    cache = {}

    def get(graphs, key, name):
        if (key, name) not in cache:
            g, p, _, _ = graphs[key]
            j, _, jkw, _ = make_programs(name, g.n_nodes)
            cfg = JE.EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges)
            m, st = JE.run(j, g, p, cfg, **jkw)
            cache[(key, name)] = ({k: np.asarray(v) for k, v in m.items()},
                                  {k: np.asarray(v) for k, v in st.items()})
        return cache[(key, name)]

    return get


def assert_matches(name, jm, js, tm, ts):
    assert set(jm) == set(tm)
    for k in jm:
        a, b = jm[k], tm[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if name in EXACT:
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), k
        elif name in RESIDUAL:
            tol = dict(TA.ALL[name]().params)["tol"]
            np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-12, err_msg=k)
    if name in EXACT:
        for k in ("iterations", "push_iters", "pull_iters", "switches",
                  "mode_trace", "fe_trace", "final_count"):
            assert np.array_equal(js[k], ts[k].numpy()), k


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("name", sorted(JA.ALL))
@pytest.mark.parametrize("key", ["rmat", "road"])
def test_program_matches_reference(graphs, reference, key, name, fusion):
    g, _, tg, tp = graphs[key]
    jm, js = reference(graphs, key, name)
    _, t, _, tkw = make_programs(name, g.n_nodes)
    cfg = TE.EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges, fusion=fusion)
    tm, ts = TE.run(t, tg, tp, cfg, **tkw)
    assert_matches(name, jm, js, tm, ts)


@pytest.mark.parametrize("name", sorted(JA.ALL))
def test_kernel_pull_equals_torch_pull(graphs, name):
    """On the CPU the kernel route runs `ell_combine`'s plain version; it is
    bit-equal to the torch pull (gather, Compute, halving tree)."""
    g, _, tg, tp = graphs["rmat"]
    _, t, _, tkw = make_programs(name, g.n_nodes)
    cfg = TE.EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges)
    mk, sk = TE.run(t, tg, tp, cfg, **tkw)
    mt, st = TE.run(t, tg, tp, dataclasses.replace(cfg, pull_impl="torch"), **tkw)
    for k in mk:
        assert torch.equal(mk[k].view(torch.int32), mt[k].view(torch.int32)), k
    for k in sk:
        assert torch.equal(sk[k], st[k]), k


def test_small_caps_overflow_and_sparse_combine(graphs):
    """Small frontier/edge budgets force overflow switches; the sorted push
    combine gives the same result as the segment combine."""
    g, p, tg, tp = graphs["rmat"]
    for sparse in (False, True):
        jcfg = JE.EngineConfig(frontier_cap=64, edge_cap=512, sparse_combine=sparse)
        tcfg = TE.EngineConfig(frontier_cap=64, edge_cap=512, sparse_combine=sparse)
        jm, js = JE.run(JA.sssp(3), g, p, jcfg)
        tm, ts = TE.run(TA.sssp(3), tg, tp, tcfg)
        assert_matches("sssp", {k: np.asarray(v) for k, v in jm.items()},
                       {k: np.asarray(v) for k, v in js.items()}, tm, ts)


def test_delta_overlay_matches_reference(graphs):
    g, p, tg, tp = graphs["road"]
    n = g.n_nodes
    rng = np.random.default_rng(11)
    src, dst = rng.integers(0, n, 6), rng.integers(0, n, 6)
    w = rng.integers(1, 5, 6).astype(np.float32)
    jd = jcsr.delta_from_edges(src, dst, w, n, 8)
    td = tcsr.delta_from_edges(src, dst, w, n, 8, device="cpu")
    for name in ("bfs", "sssp"):
        jcfg = JE.EngineConfig(frontier_cap=n, edge_cap=g.n_edges)
        tcfg = TE.EngineConfig(frontier_cap=n, edge_cap=g.n_edges)
        jm, js = JE.run(JA.ALL[name](0), g, p, jcfg, delta=jd)
        tm, ts = TE.run(TA.ALL[name](0), tg, tp, tcfg, delta=td)
        assert_matches(name, {k: np.asarray(v) for k, v in jm.items()},
                       {k: np.asarray(v) for k, v in js.items()}, tm, ts)


@pytest.mark.parametrize("edge_cap", [1, 37, 5000])
def test_expand_frontier_and_init_state_match(graphs, edge_cap):
    g, _, tg, _ = graphs["rmat"]
    ids = np.asarray([5, 0, 17, 511, 512, 512], np.int32)
    j = JE.expand_frontier(g.out, jnp.asarray(ids), jnp.int32(4), edge_cap)
    t = TE.expand_frontier(tg.out, torch.from_numpy(ids), torch.tensor(4, dtype=torch.int32),
                           edge_cap)
    for a, b in zip(j, t):
        assert np.array_equal(np.asarray(a), b.numpy())
    cfg_j = JE.EngineConfig(frontier_cap=100, edge_cap=edge_cap)
    cfg_t = TE.EngineConfig(frontier_cap=100, edge_cap=edge_cap)
    js = JE.init_state(JA.kcore(4), g, cfg_j)
    ts = TE.init_state(TA.kcore(4), tg, cfg_t)
    for k in ("frontier", "count", "fe_next", "mode", "overflow", "done", "switches"):
        assert np.array_equal(np.asarray(getattr(js, k)), getattr(ts, k).numpy()), k


def test_kernel_pull_needs_a_declared_op(graphs):
    g, _, tg, tp = graphs["rmat"]
    prog = dataclasses.replace(TA.bfs(0), kernel_compute=None)
    cfg = TE.EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges)
    with pytest.raises(ValueError, match="kernel_compute"):
        TE.run(prog, tg, tp, cfg)
    TE.run(prog, tg, tp, dataclasses.replace(cfg, pull_impl="torch"))
    with pytest.raises(ValueError):
        TE.run(TA.bfs(0), tg, tp, dataclasses.replace(cfg, pull_impl="pallas"))
