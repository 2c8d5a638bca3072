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
from repro_torch import interop, obs
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


# ---------------------------------------------------------------------------
# the push's edge buffer sized to the frontier's edge volume
# ---------------------------------------------------------------------------

STATS = ("iterations", "push_iters", "pull_iters", "switches", "mode_trace",
         "fe_trace", "final_count")


@pytest.mark.parametrize("fe,edge_cap,want", [
    (0, 1 << 20, TE._MIN_LANES), (1, 1 << 20, TE._MIN_LANES),
    (TE._MIN_LANES, 1 << 20, TE._MIN_LANES),
    (TE._MIN_LANES + 1, 1 << 20, 2 * TE._MIN_LANES),
    ((1 << 17) - 1, 1 << 20, 1 << 17), (1 << 17, 1 << 20, 1 << 17),
    ((1 << 17) + 1, 1 << 20, 1 << 18),
    (5000, 6000, 6000), (6000, 6000, 6000), (100, 512, 512),
    (7000, 5000, 5000),      # past edge_cap: the full buffer, as before
])
def test_bucket_lanes(fe, edge_cap, want):
    lanes = TE._bucket_lanes(fe, edge_cap)
    assert lanes == want
    assert lanes == edge_cap or (lanes >= max(fe, TE._MIN_LANES)
                                 and lanes & (lanes - 1) == 0)


def _full_buffer(mp):
    """Every push of `run` reaches `_push_step` with lanes=None: all
    `edge_cap` lanes, the buffer before bucketing."""
    step = TE._push_step
    mp.setattr(TE, "_push_step", lambda program, csr, cfg, st, delta=None, lanes=None:
               step(program, csr, cfg, st, delta))


def _assert_bucketed_equals_full(monkeypatch, prog, tg, tp, cfg, **kw):
    """`run` with bucketed pushes is bit-equal to `run` with full buffers in
    its metadata and in every control stat; returns the bucketed stats."""
    bm, bs = TE.run(prog, tg, tp, cfg, **kw)
    with monkeypatch.context() as mp:
        _full_buffer(mp)
        fm, fs = TE.run(prog, tg, tp, cfg, **kw)
    assert set(bm) == set(fm)
    for k in fm:
        assert torch.equal(bm[k].view(torch.int32), fm[k].view(torch.int32)), k
    for k in STATS:
        assert torch.equal(bs[k], fs[k]), k
    return bs


@pytest.mark.parametrize("min_lanes", [TE._MIN_LANES, 1])
@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("name", sorted(JA.ALL))
def test_bucketed_push_equals_full_buffer(graphs, monkeypatch, name, fusion, min_lanes):
    """A floor of 1 gives the 512-vertex graph buckets of every size."""
    monkeypatch.setattr(TE, "_MIN_LANES", min_lanes)
    g, _, tg, tp = graphs["rmat"]
    _, t, _, tkw = make_programs(name, g.n_nodes)
    cfg = TE.EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges, fusion=fusion)
    _assert_bucketed_equals_full(monkeypatch, t, tg, tp, cfg, **tkw)


@pytest.mark.parametrize("min_lanes", [TE._MIN_LANES, 1])
@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("case", ["small_caps", "small_caps_sparse", "delta"])
@pytest.mark.parametrize("name", ["bfs", "sssp"])
def test_bucketed_push_equals_full_buffer_small_caps_and_delta(
        graphs, monkeypatch, name, case, fusion, min_lanes):
    monkeypatch.setattr(TE, "_MIN_LANES", min_lanes)
    if case == "delta":
        g, _, tg, tp = graphs["road"]
        n = g.n_nodes
        rng = np.random.default_rng(11)
        src, dst = rng.integers(0, n, 6), rng.integers(0, n, 6)
        w = rng.integers(1, 5, 6).astype(np.float32)
        kw = {"delta": tcsr.delta_from_edges(src, dst, w, n, 8, device="cpu")}
        cfg = TE.EngineConfig(frontier_cap=n, edge_cap=g.n_edges, fusion=fusion)
    else:
        g, _, tg, tp = graphs["rmat"]
        kw = {}
        cfg = TE.EngineConfig(frontier_cap=64, edge_cap=512, fusion=fusion,
                              sparse_combine=case == "small_caps_sparse")
    _assert_bucketed_equals_full(monkeypatch, TA.ALL[name](3), tg, tp, cfg, **kw)


@pytest.mark.parametrize("fusion", FUSIONS)
def test_one_host_read_an_iteration(graphs, monkeypatch, fusion):
    """The edge volume rides in the packed control-flow read: `run` reads
    the device once before the first iteration and once after each."""
    calls = []
    read = obs.host_flags
    monkeypatch.setattr(obs, "host_flags", lambda x: calls.append(1) or read(x))
    g, _, tg, tp = graphs["rmat"]
    cfg = TE.EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges, fusion=fusion)
    for prog in (TA.bfs(0), TA.sssp(0), TA.pagerank()):
        calls.clear()
        _, st = TE.run(prog, tg, tp, cfg)
        assert len(calls) == int(st["iterations"]) + 1, prog.name


@pytest.mark.parametrize("min_lanes", [TE._MIN_LANES, 1])
@pytest.mark.parametrize("name", ["bfs", "sssp", "wcc", "kcore"])
def test_each_push_expands_its_frontiers_bucket(graphs, monkeypatch, name, min_lanes):
    """Each push's `expand_frontier` gets the bucket of the edge volume it
    finds, and that volume is the `fe_trace` entry read with the flags."""
    monkeypatch.setattr(TE, "_MIN_LANES", min_lanes)
    seen = []
    expand = TE.expand_frontier

    def record(csr, ids, count, edge_cap):
        out = expand(csr, ids, count, edge_cap)
        seen.append((edge_cap, int(out[-1])))
        return out

    monkeypatch.setattr(TE, "expand_frontier", record)
    g, _, tg, tp = graphs["rmat"]
    cfg = TE.EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges)
    prog = TA.ALL[name](3) if name in ("bfs", "sssp") else TA.ALL[name]()
    _, st = TE.run(prog, tg, tp, cfg)
    it = int(st["iterations"])
    assert it <= cfg.trace_len
    push = st["mode_trace"][:it] == TE.PUSH
    assert len(seen) == int(st["push_iters"]) > 0
    assert [total for _, total in seen] == st["fe_trace"][:it][push].tolist()
    for lanes, total in seen:
        assert lanes == TE._bucket_lanes(total, cfg.edge_cap) >= total
    expanded = sum(lanes for lanes, _ in seen)
    assert expanded <= int(st["push_iters"]) * cfg.edge_cap
    if min_lanes == 1:
        assert expanded < int(st["push_iters"]) * cfg.edge_cap
