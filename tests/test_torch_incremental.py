"""The port's incremental recomputation (`repro_torch.streaming.incremental`)
against the reference's and against full recompute on the updated graph.

The same graph and update batches go through both packages' StreamingGraph.
`residual_correct` must give planes bit-equal to the reference's from the
same previous planes and the same report (parallel edges included).
`incremental_batch` must pick the reference's regime for every catalog
program and agree with it and with the port's own full recompute: bit-equal
for min/max and integer programs, within rtol 1e-5 for sums against the
reference, and within the reference's own tolerances against full
recompute (tests/test_catalog.py's 1e-4, tests/test_ppr_delta.py's ATOL
2e-3). The single-device cases of tests/test_streaming.py,
tests/test_catalog.py (:278-377) and tests/test_ppr_delta.py (:272-469) are
mirrored on rmat(7-10) graphs.
"""

import numpy as np
import pytest
import torch

from repro.core import algorithms as JA
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro.serving import default_config as jdefault_config
from repro.serving import run_batch as jrun_batch
from repro.streaming import StreamingGraph as JSG
from repro.streaming import incremental_batch as jincremental_batch
from repro.streaming import residual_correct as jresidual_correct
from repro_torch import interop
from repro_torch.core import algorithms as TA
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen
from repro_torch.graph import packing as tpacking
from repro_torch.launch.catalog import make_catalog
from repro_torch.obs import recorder
from repro_torch.serving import default_config, query_result, run_batch
from repro_torch.streaming import StreamingGraph, incremental_batch, residual_correct
from repro_torch.streaming.incremental import is_monotone, is_residual

TOL = 1e-5
DAMP = 0.85
ATOL = 2e-3            # tests/test_ppr_delta.py's bound against full recompute


def tgraph(jg):
    inc = None if jg.inc is jg.out else interop.csr_arrays(jg.inc)
    return interop.graph_from_numpy(interop.csr_arrays(jg.out), inc, device="cpu")


def both(jg, cap):
    return JSG(jg, delta_cap=cap), StreamingGraph(tgraph(jg), delta_cap=cap)


def _np(m):
    return {k: np.asarray(v) for k, v in m.items()}


def _star_path(lib):
    """A hub fanning out 200 leaves plus a 200-vertex path (the reference's
    consensus-divergence graph)."""
    e = np.asarray([(0, i) for i in range(1, 201)]
                   + [(200 + i, 201 + i) for i in range(200)], dtype=np.int64)
    return lib.from_edges(e[:, 0], e[:, 1], 402, directed=True)


def _graph(name):
    if name == "rmat":
        return jgen.rmat(8, 4, seed=11, directed=True)
    if name == "rmat-und":
        return jgen.rmat(8, 4, seed=3)
    return _star_path(jcsr)


def _np_ppr_coo(src, dst, n, source, d=DAMP, iters=300):
    """Dense power-iteration reference over a COO edge list."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    deg = np.bincount(src, minlength=n)[:n].astype(np.float64)
    pref = np.zeros(n)
    pref[source] = 1.0
    r = pref.copy()
    safe = np.maximum(deg, 1.0)
    for _ in range(iters):
        contrib = r / safe
        nxt = np.zeros(n)
        np.add.at(nxt, dst, contrib[src])
        r = (1 - d) * pref + d * nxt
    return r.astype(np.float32)


def _check_invariant(m):
    """|resid| <= tol·deg everywhere."""
    resid, degf = m["resid"].numpy(), m["deg"].numpy()
    assert (np.abs(resid[:-1]) <= TOL * degf[:-1] + 1e-9).all()


def _sg_edges(sg):
    src, dst = sg.live_edges_coo()
    return src.numpy(), dst.numpy()


# ---------------------------------------------------------------------------
# residual_correct: bit-equal planes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["rmat", "rmat-und", "parallel"])
def test_residual_correct_planes_bit_equal_to_the_reference(name):
    """From the reference's own previous planes and an equal report, every
    corrected plane (rank, resid, deg, send) is bit-equal, over three
    chained insert / delete / insert+delete batches; the port's planes given
    as tensors or as numpy arrays give the same result."""
    if name == "parallel":
        e = np.asarray([(0, 1), (1, 2), (1, 2), (1, 3), (2, 4), (3, 4), (4, 0)],
                       dtype=np.int64)
        jg = jcsr.from_edges(e[:, 0], e[:, 1], 5, None, directed=True, dedupe=False)
        batches = [([], [(1, 2)]), ([(1, 2), (4, 1)], []), ([(3, 0)], [(1, 2), (2, 4)])]
    else:
        jg = _graph(name)
        rng = np.random.default_rng(23)
        n = jg.n_nodes
        batches = []
        for n_ins, n_del in [(6, 0), (0, 5), (4, 4)]:
            ins = [(int(rng.integers(0, n)), int(rng.integers(0, n)))
                   for _ in range(n_ins)]
            eidx = rng.integers(0, jg.n_edges, size=n_del)
            batches.append((ins, [(int(jg.out.src_idx[i]), int(jg.out.col_idx[i]))
                                  for i in eidx]))
    js, ts = both(jg, 128)
    jp, tp = JA.ppr_delta(0), TA.ppr_delta(0)
    sources = [0, 1, 3]
    cfg = jdefault_config(jg, max_iters=256)
    prev, _ = jrun_batch(jp, js.graph, js.pack, cfg, sources, delta=js.delta)
    prev = _np(prev)
    for ins, dels in batches:
        rj, rt = js.apply(ins, dels), ts.apply(ins, dels)
        assert np.array_equal(rj.del_edges, rt.del_edges)
        mj = jresidual_correct(jp, js, prev, rj)
        mt = residual_correct(tp, ts, prev, rt)
        mt2 = residual_correct(tp, ts, {k: torch.tensor(v) for k, v in prev.items()}, rt)
        assert list(mj) == list(mt)
        for k in mj:
            assert mt[k].dtype == torch.float32
            assert np.array_equal(mj[k], mt[k].numpy()), (name, k)
            assert torch.equal(mt[k], mt2[k]), k
        prev = {k: np.asarray(v) for k, v in mj.items()}


def test_residual_correct_keeps_parallel_edge_multiplicity():
    """Deleting ONE of two parallel edges retracts one copy's push: the
    resumed run agrees with full recompute (multiplicity lost would show at
    about 5e-2) and keeps the invariant."""
    e = np.asarray([(0, 1), (1, 2), (1, 2), (1, 3), (2, 4), (3, 4)], dtype=np.int64)
    tg = tcsr.from_edges(e[:, 0], e[:, 1], 5, None, directed=True, dedupe=False,
                         device="cpu")
    assert tg.n_edges == 6
    sg = StreamingGraph(tg, delta_cap=16)
    cfg = default_config(tg, max_iters=256)
    prog = TA.ppr_delta(0, tol=1e-7)
    prev, _ = run_batch(prog, sg.graph, sg.pack, cfg, [0], delta=sg.delta)
    sg.apply(deletes=[(1, 2)])
    inc, info = incremental_batch(prog, sg, cfg, [0], prev)
    assert info["mode"] == "residual-resume"
    full, _ = run_batch(prog, sg.graph, sg.pack, cfg, [0], delta=sg.delta)
    assert float((full["rank"] - inc["rank"])[:-1].abs().max()) < 1e-3


# ---------------------------------------------------------------------------
# incremental_batch: every regime, against the reference and full recompute
# ---------------------------------------------------------------------------

ALGOS = ["bfs", "sssp", "wcc", "ppr", "ppr_delta", "pagerank_delta", "pagerank",
         "kcore", "mis"]
EXPECTED_MODES = {
    "bfs": ("monotone-incremental",) * 2,
    "sssp": ("monotone-incremental",) * 2,
    "wcc": ("monotone-incremental",) * 2,
    "ppr": ("selective-rerun",) * 2,
    "ppr_delta": ("residual-resume",) * 2,
    "pagerank_delta": ("residual-resume",) * 2,
    "pagerank": ("full-recompute",) * 2,
    "kcore": ("full-recompute", "cascade-resume"),   # inserts resurrect
    "mis": ("reelect-resume",) * 2,
}


def _tolerance(program):
    return 1e-4 if program.combiner.name == "sum" else 0.0


@pytest.mark.parametrize("name", ALGOS)
def test_incremental_batch_matches_reference_and_full(name):
    """An insert batch, then a delete batch (tests/test_catalog.py's
    streaming case on rmat(7) undirected, plus the traversal trio and the
    two PageRanks): each refresh takes the reference's regime, its served
    plane equals the reference's (bit-equal, or rtol 1e-5 for sums), and
    every plane equals the port's full recompute on the updated views
    (bit-equal for min/max and integer programs)."""
    jg = jgen.rmat(7, 8, seed=3)
    js, ts = both(jg, 64)
    jp, tp = make_catalog_ref()[name], make_catalog()[name]
    field = tp.param("result", tp.primary)
    exact = _tolerance(tp) == 0.0
    jcfg = jdefault_config(jg, max_iters=256)
    tcfg = default_config(ts.graph, max_iters=256)
    sources = [0, jg.n_nodes // 2]
    pj, _ = jrun_batch(jp, js.graph, js.pack, jcfg, sources, delta=js.delta)
    pt, _ = run_batch(tp, ts.graph, ts.pack, tcfg, sources, delta=ts.delta)
    dels = [(int(jg.out.src_idx[i]), int(jg.out.col_idx[i])) for i in (0, 5)]
    for step, (ins, de) in enumerate([([(1, 100), (9, 40), (77, 3)], []), ([], dels)]):
        rj, rt = js.apply(ins, de), ts.apply(ins, de)
        mj, ij = jincremental_batch(jp, js, jcfg, sources, pj, rj)
        mt, it = incremental_batch(tp, ts, tcfg, sources, pt, rt)
        assert it["mode"] == ij["mode"] == EXPECTED_MODES[name][step], (it, ij)
        a, b = np.asarray(mj[field]), mt[field].numpy()
        if exact:
            assert np.array_equal(a, b), (name, step)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)
        full, _ = run_batch(tp, ts.graph, ts.pack, tcfg, sources, delta=ts.delta)
        # ppr_delta's resumed ranks are tol-converged approximations:
        # tests/test_ppr_delta.py's ATOL
        atol = ATOL if name == "ppr_delta" else _tolerance(tp)
        for k in full:
            if exact:
                assert torch.equal(mt[k], full[k]), (name, step, k)
            else:
                assert np.allclose(mt[k].numpy(), full[k].numpy(), rtol=1e-5,
                                   atol=atol), (name, step, k)
        pj, pt = mj, mt


def make_catalog_ref():
    from repro.launch.catalog import make_catalog as ref_catalog

    return ref_catalog()


@pytest.mark.parametrize("name", ["bfs", "sssp", "ppr"])
def test_incremental_bitmatches_full_property(name):
    """tests/test_streaming.py's property case: chained random insert+delete
    batches, incremental equal to full recompute bit for bit."""
    tg = tgen.rmat(8, 4, seed=11, device="cpu")
    sg = StreamingGraph(tg, delta_cap=128)
    cfg = default_config(tg, max_iters=64)
    rng = np.random.default_rng(23)
    sources = rng.integers(0, tg.n_nodes, size=6).tolist()
    prog = {"bfs": TA.bfs, "sssp": TA.sssp, "ppr": TA.ppr}[name](0)
    prev, _ = run_batch(prog, sg.graph, sg.pack, cfg, sources, delta=sg.delta)
    assert is_monotone(prog) == (name in ("bfs", "sssp"))
    n = tg.n_nodes
    for batch in range(3):
        ins = [(int(rng.integers(0, n)), int(rng.integers(0, n)),
                float(rng.integers(1, 65))) for _ in range(5)]
        eidx = rng.integers(0, tg.n_edges, size=4)
        dels = [(int(tg.out.src_idx[i]), int(tg.out.col_idx[i])) for i in eidx]
        sg.apply(inserts=ins, deletes=dels)
        full, _ = run_batch(prog, sg.graph, sg.pack, cfg, sources, delta=sg.delta)
        inc, info = incremental_batch(prog, sg, cfg, sources, prev)
        for k in full:
            assert torch.equal(full[k], inc[k]), (name, batch, k, info)
        prev = inc


@pytest.mark.parametrize("name", ["rmat", "rmat-und", "star-path"])
def test_ppr_delta_streaming_property(name):
    """tests/test_ppr_delta.py's property sweep: residual resumes over
    chained batches keep the invariant and agree with full recompute and
    with a dense reference on the live topology within ATOL."""
    tg = tgraph(_graph(name))
    n = tg.n_nodes
    sg = StreamingGraph(tg, delta_cap=128)
    cfg = default_config(tg, max_iters=256)
    rng = np.random.default_rng(23)
    sources = np.unique(rng.integers(0, n, size=5)).tolist()
    prog = TA.ppr_delta(0)
    assert is_residual(prog) and not is_residual(TA.ppr(0))
    prev, _ = run_batch(prog, sg.graph, sg.pack, cfg, sources, delta=sg.delta)
    for batch, (n_ins, n_del) in enumerate([(6, 0), (0, 5), (4, 4)]):
        ins = [(int(rng.integers(0, n)), int(rng.integers(0, n))) for _ in range(n_ins)]
        eidx = rng.integers(0, tg.n_edges, size=n_del)
        dels = [(int(tg.out.src_idx[i]), int(tg.out.col_idx[i])) for i in eidx]
        sg.apply(inserts=ins, deletes=dels)
        inc, info = incremental_batch(prog, sg, cfg, sources, prev)
        assert info["mode"] == "residual-resume", info
        _check_invariant(inc)
        full, _ = run_batch(prog, sg.graph, sg.pack, cfg, sources, delta=sg.delta)
        assert float((full["rank"] - inc["rank"]).abs().max()) < ATOL, (name, batch)
        esrc, edst = _sg_edges(sg)
        for lane, s in enumerate(sources):
            want = _np_ppr_coo(esrc, edst, n, s)
            got = query_result(inc, "rank", lane).numpy()
            assert np.abs(got - want).max() < ATOL, (name, batch, s)
        prev = inc


def test_targeted_deletion_threshold_reactivation():
    """Source s is not an endpoint of the update, yet deleting most of u's
    out-edges lowers u's threshold tol·deg(u) below u's surviving residual
    while every correction term at u is zero: the frontier must come from
    the full corrected residual field (tests/test_ppr_delta.py's case)."""
    tol, d = 1e-3, DAMP
    fan, u_deg = 85, 20
    s, u = 0, 1
    edges = [(s, u)] + [(s, 100 + i) for i in range(fan - 1)]
    edges += [(u, 200 + i) for i in range(u_deg)]
    e = np.asarray(edges, dtype=np.int64)
    n = 300
    tg = tcsr.from_edges(e[:, 0], e[:, 1], n, directed=True, device="cpu")
    sg = StreamingGraph(tg, delta_cap=32)
    cfg = default_config(tg, max_iters=256)
    prog = TA.ppr_delta(0, damping=d, tol=tol)
    prev, _ = run_batch(prog, sg.graph, sg.pack, cfg, [s], delta=sg.delta)
    r_u = float(prev["resid"][u, 0])
    assert abs(r_u - d / fan) < 1e-6
    assert float(prev["rank"][u, 0]) == 0.0
    rep = sg.apply(deletes=[(u, 200 + i) for i in range(1, u_deg)])
    assert s not in set(np.concatenate([rep.del_edges.ravel(), rep.ins_edges.ravel()]))
    inc, info = incremental_batch(prog, sg, cfg, [s], prev)
    assert info["mode"] == "residual-resume"
    resid = inc["resid"][:, 0].numpy()
    degf = inc["deg"][:, 0].numpy()
    assert (np.abs(resid) <= tol * degf + 1e-9).all(), (
        f"|resid(u)|={abs(resid[u]):.4f} vs tol*deg(u)={tol * degf[u]:.4f}")
    full, _ = run_batch(prog, sg.graph, sg.pack, cfg, [s], delta=sg.delta)
    assert float((full["rank"] - inc["rank"]).abs().max()) < 10 * tol
    assert float(inc["rank"][u, 0]) > (1 - d) * r_u * 0.99
    esrc, edst = _sg_edges(sg)
    want = _np_ppr_coo(esrc, edst, n, s, d=d)
    assert np.abs(query_result(inc, "rank", 0).numpy() - want).max() < 10 * tol


def test_overlay_run_matches_rebuilt_graph_degrees():
    """A cold ppr_delta run over overlay views counts live degrees: equal
    `deg` planes to a run on the rebuilt graph, ranks within 1e-6."""
    tg = tgen.rmat(8, 4, seed=2, directed=True, device="cpu")
    n = tg.n_nodes
    sg = StreamingGraph(tg, delta_cap=64)
    sg.apply(inserts=[(0, 9), (9, 41), (3, 7)],
             deletes=[(int(tg.out.src_idx[i]), int(tg.out.col_idx[i])) for i in (0, 5, 9)])
    cfg = default_config(tg, max_iters=256)
    m_ov, _ = run_batch(TA.ppr_delta(0), sg.graph, sg.pack, cfg, [0, 9], delta=sg.delta)
    esrc, edst = _sg_edges(sg)
    g_rb = tcsr.from_edges(esrc, edst, n, None, directed=True, dedupe=False, device="cpu")
    m_rb, _ = run_batch(TA.ppr_delta(0), g_rb, tpacking.pack_ell(g_rb.inc), cfg, [0, 9])
    assert torch.equal(m_ov["deg"], m_rb["deg"])
    assert float((m_ov["rank"] - m_rb["rank"]).abs().max()) < 1e-6


# ---------------------------------------------------------------------------
# the contract regimes
# ---------------------------------------------------------------------------


def test_kcore_deletion_cascade_unravels_cycle():
    """One delete drops a 12-cycle below k = 2 and the cascade unravels it
    while a disjoint triangle survives, bit-equal to a cold run."""
    cyc = [(i, (i + 1) % 12) for i in range(12)]
    tri = [(12, 13), (13, 14), (14, 12)]
    e = np.asarray(cyc + tri, dtype=np.int64)
    tg = tcsr.from_edges(e[:, 0], e[:, 1], 15, directed=False, device="cpu")
    program = TA.kcore(k=2)
    cfg = default_config(tg, max_iters=64)
    sg = StreamingGraph(tg, delta_cap=16)
    prev, _ = run_batch(program, sg.graph, sg.pack, cfg, [0], delta=sg.delta)
    assert bool((prev["alive"][:-1, 0] > 0).all())
    rep = sg.apply(deletes=[(0, 1)])
    m_inc, info = incremental_batch(program, sg, cfg, [0], prev, rep)
    assert info["mode"] == "cascade-resume", info
    m_ref, _ = run_batch(program, sg.graph, sg.pack, cfg, [0], delta=sg.delta)
    assert torch.equal(m_inc["alive"], m_ref["alive"])
    alive = m_inc["alive"][:-1, 0].numpy() > 0
    assert not alive[:12].any() and alive[12:].all()


def test_kcore_cascade_from_cached_alive_plane_only():
    """The cascade rebuilds its state from the `alive` plane alone (all the
    cache stores), on an rmat(9) deletion batch that kills vertices."""
    tg = tgen.rmat(9, 8, seed=3, device="cpu")
    program = TA.kcore(k=8)
    cfg = default_config(tg, max_iters=256)
    sg = StreamingGraph(tg, delta_cap=16)
    prev, _ = run_batch(program, sg.graph, sg.pack, cfg, [0], delta=sg.delta)
    alive = prev["alive"][:-1, 0] > 0
    core = torch.nonzero(alive).flatten().tolist()
    rp, ci = tg.out.row_ptr, tg.out.col_idx
    dels = [(v, int(ci[rp[v]])) for v in core[:6]]
    rep = sg.apply(deletes=dels)
    m_inc, info = incremental_batch(program, sg, cfg, [0], {"alive": prev["alive"]}, rep)
    assert info["mode"] == "cascade-resume"
    m_ref, _ = run_batch(program, sg.graph, sg.pack, cfg, [0], delta=sg.delta)
    for k in m_ref:
        assert torch.equal(m_inc[k], m_ref[k]), k


def test_mis_reelection_after_insert_between_members():
    """Wiring two set members together re-elects the dirtied region: equal
    to a cold run on the updated graph, and a valid MIS."""
    tg = tgraph(jgen.rmat(7, 8, seed=3))
    program = TA.mis()
    cfg = default_config(tg, max_iters=256)
    sg = StreamingGraph(tg, delta_cap=16)
    prev, _ = run_batch(program, sg.graph, sg.pack, cfg, [0], delta=sg.delta)
    inset = torch.nonzero(prev["state"][:-1, 0] == 1.0).flatten().tolist()
    assert len(inset) >= 2
    u, v = inset[0], inset[-1]
    rep = sg.apply(inserts=[(u, v)])
    m_inc, info = incremental_batch(program, sg, cfg, [0], prev, rep)
    assert info["mode"] == "reelect-resume", info
    m_ref, _ = run_batch(program, sg.graph, sg.pack, cfg, [0], delta=sg.delta)
    assert torch.equal(m_inc["state"], m_ref["state"])
    state = m_inc["state"][:-1, 0].numpy()
    assert not (state[u] == 1.0 and state[v] == 1.0)
    src, dst = (x.numpy() for x in sg.live_edges_coo())
    assert set(np.unique(state)) <= {1.0, 2.0}
    inset = state == 1.0
    assert not (inset[src] & inset[dst]).any(), "independence"
    covered = np.zeros(state.shape[0], bool)
    covered[dst[inset[src]]] = True
    assert (inset | covered).all(), "maximality"


def test_incremental_records_flight_events(monkeypatch):
    ring = recorder.FlightRecorder(capacity=16)
    monkeypatch.setattr(recorder, "GLOBAL", ring)
    tg = tgen.rmat(7, 8, seed=3, device="cpu")
    sg = StreamingGraph(tg, delta_cap=16)
    cfg = default_config(tg, max_iters=64)
    prev, _ = run_batch(TA.bfs(0), sg.graph, sg.pack, cfg, [0, 5], delta=sg.delta)
    sg.apply(inserts=[(1, 100)])
    incremental_batch(TA.bfs(0), sg, cfg, [0, 5], prev)
    ev = [e for e in ring.events() if e["kind"] == "incremental"]
    assert len(ev) == 1 and ev[0]["mode"] == "monotone-incremental" and ev[0]["reran"] == 2


def test_incremental_needs_an_applied_batch():
    tg = tgen.rmat(6, 4, seed=1, device="cpu")
    sg = StreamingGraph(tg, delta_cap=4)
    cfg = default_config(tg, max_iters=64)
    prev, _ = run_batch(TA.bfs(0), sg.graph, sg.pack, cfg, [0], delta=sg.delta)
    with pytest.raises(AssertionError, match="apply"):
        incremental_batch(TA.bfs(0), sg, cfg, [0], prev)

