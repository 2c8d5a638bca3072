"""The port's streaming overlay (`repro_torch.streaming.StreamingGraph`)
against the reference's (`repro.streaming.StreamingGraph`).

The same graph and the same update batches go through both. Every
`UpdateReport` field and every view (the CSR views, the ELL pack with its
delta slice, the push COO buffer) must be array-equal, over chained batches
that include an overflow rebuild, a mid-flight compaction and an
overflowing batch during a rebuild, with the host and the device sweep.
The cases of tests/test_streaming.py that run on one device are mirrored
on the port (overlay no-op, deletion repair, overflow, mid-flight merges,
identity stability, static delta shapes, sweep routing, the solo engine
with a delta against a rebuilt graph).

It also holds the pull merge of the delta slice (fault 3, ROADMAP §3): the
slice lists its receivers in insertion order, so both engines must sort
them before `segment_reduce`, whose CUDA kernel needs ascending ids.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import algorithms as JA
from repro.core import engine as JE
from repro.graph import generators as jgen
from repro.serving import run_batch as jrun_batch
from repro.streaming import StreamingGraph as JSG
from repro_torch import interop
from repro_torch.core import algorithms as TA
from repro_torch.core import engine as TE
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen
from repro_torch.graph import packing as tpacking
from repro_torch.kernels import ops as kops
from repro_torch.kernels import segment_reduce as sr
from repro_torch.obs import recorder
from repro_torch.serving import default_config, query_result, run_batch
from repro_torch.streaming import StreamingGraph, UpdateReport
from repro_torch.streaming import delta as delta_mod


def tgraph(jg):
    """The reference graph's arrays as a port graph on the CPU (shared
    storage kept for undirected graphs)."""
    inc = None if jg.inc is jg.out else interop.csr_arrays(jg.inc)
    return interop.graph_from_numpy(interop.csr_arrays(jg.out), inc, device="cpu")


def same_views(j, t):
    for d in ("out", "inc"):
        for f in interop.CSR_FIELDS:
            a = np.asarray(getattr(getattr(j.graph, d), f))
            assert np.array_equal(a, getattr(getattr(t.graph, d), f).numpy()), (d, f)
    assert (t.graph.inc is t.graph.out) == (j.graph.inc is j.graph.out)
    assert len(j.pack.slices) == len(t.pack.slices)
    for sj, st in zip(j.pack.slices, t.pack.slices):
        for f in interop.SLICE_FIELDS:
            assert np.array_equal(np.asarray(getattr(sj, f)), getattr(st, f).numpy()), f
    assert [s.rows_ascending for s in t.pack.slices] == (
        [True] * (len(t.pack.slices) - 1) + [False])
    for f in ("src", "dst", "w"):
        assert np.array_equal(np.asarray(getattr(j.delta, f)), getattr(t.delta, f).numpy()), f


def same_report(a, b):
    assert isinstance(b, UpdateReport)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, (f.name, x, y)


def same_state(j, t):
    same_views(j, t)
    assert j.stats() == t.stats()
    assert j.n_live_edges() == t.n_live_edges()
    assert np.array_equal(j.live_out_degrees(), t.live_out_degrees())
    js, jd = j.live_edges_coo()
    ts, td = t.live_edges_coo()
    assert np.array_equal(js, ts.numpy()) and np.array_equal(jd, td.numpy())
    for u in range(0, j.n, 13):
        assert np.array_equal(j.live_out_neighbors(u), t.live_out_neighbors(u)), u


def draw(rng, js, n_ins, n_del):
    """The reference driver's update draw: uniform inserts with weights
    1-64, deletes of live base edges."""
    n = js.n
    ins = [(int(rng.integers(0, n)), int(rng.integers(0, n)),
            float(rng.integers(1, 65))) for _ in range(n_ins)]
    live = np.nonzero(~js._dead_out)[0]
    e = rng.choice(live, size=n_del, replace=False) if n_del else []
    src = js._base_src_host()
    return ins, [(int(src[x]), int(js._out_ci[x])) for x in e]


# ---------------------------------------------------------------------------
# fault 3: the delta slice's pull merge
# ---------------------------------------------------------------------------


def _kernel_order_spy(monkeypatch):
    """Route `kops.segment_reduce` through `segment_reduce_ordered`, the
    plain model of the CUDA kernel (which reads its ids as ascending), and
    record every id array that is not ascending."""
    unsorted = []

    def spy(vals, ids, num, combine="sum", fill=None):
        if ids.numel() > 1 and bool((ids[1:] < ids[:-1]).any()):
            unsorted.append(ids.tolist()[:12])
        return sr.segment_reduce_ordered(vals, ids, num, combine, fill)

    monkeypatch.setattr(kops, "segment_reduce", spy)
    return unsorted


def test_delta_slice_merge_sorts_its_receivers(monkeypatch):
    """Inserts whose receivers descend (90, then 40) and repeat (90 twice,
    not side by side) make the delta slice's `row_id` [90, 40, 90, n, ...].
    A pull always (alpha 0) runs the merge on every step. Every id array
    that reaches `segment_reduce` must be ascending, and bfs/sssp from the
    insert's source through the kernel's fold order must equal the
    reference, solo and batched."""
    jg = jgen.rmat(7, 8, seed=3, directed=True)
    tg = tgraph(jg)
    n = jg.n_nodes
    src = 0
    rp = np.asarray(jg.out.row_ptr)
    ci = np.asarray(jg.out.col_idx)
    far = [v for v in range(1, n) if v not in set(ci[rp[src]:rp[src + 1]].tolist())
           and rp[v + 1] > rp[v]]
    c = far[0]
    recv_a, recv_b = 90, 40
    ins = [(src, recv_a), (far[1], recv_b), (c, recv_a)]
    js, ts = JSG(jg, delta_cap=8), StreamingGraph(tg, delta_cap=8)
    assert js.apply(ins).n_inserted == ts.apply(ins).n_inserted == 3
    rows = ts.pack.slices[-1].row_id[:4].tolist()
    assert rows == [recv_a, recv_b, recv_a, n]
    unsorted = _kernel_order_spy(monkeypatch)

    jcfg = JE.EngineConfig(frontier_cap=n, edge_cap=jg.n_edges, alpha=0.0)
    tcfg = TE.EngineConfig(frontier_cap=n, edge_cap=tg.n_edges, alpha=0.0)
    for jp, tp in ((JA.bfs(src), TA.bfs(src)), (JA.sssp(src), TA.sssp(src))):
        mj, sj = JE.run(jp, js.graph, js.pack, jcfg, delta=js.delta)
        mt, st = TE.run(tp, ts.graph, ts.pack, tcfg, delta=ts.delta)
        assert int(st["pull_iters"]) > 0
        want, got = np.asarray(mj["dist"]), mt["dist"].numpy()
        bad = np.flatnonzero(want != got)
        assert bad.size == 0, (
            f"solo {tp.name}: vertex {bad[0]} reads {got[bad[0]]}, the reference "
            f"{want[bad[0]]}")
        bj, _ = jrun_batch(jp, js.graph, js.pack, jcfg, [src, c], delta=js.delta)
        bt, _ = run_batch(tp, ts.graph, ts.pack, tcfg, [src, c], delta=ts.delta)
        assert np.array_equal(np.asarray(bj["dist"]), bt["dist"].numpy()), tp.name
    assert not unsorted, f"ids handed to segment_reduce as sorted: {unsorted[0]}"


# ---------------------------------------------------------------------------
# the overlay against the reference's, chained batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sweep", ["host", "device"])
@pytest.mark.parametrize("directed", [False, True])
def test_reports_and_views_equal_the_reference(directed, sweep):
    """Eight chained batches of 5 inserts and 3 deletes at delta_cap 16:
    overflow rebuilds, a compaction begun before batch 4 and finished after
    batch 5 (or finished by an overflowing batch in flight)."""
    jg = jgen.rmat(8, 6, seed=2, directed=directed)
    js = JSG(jg, delta_cap=16, sweep=sweep)
    ts = StreamingGraph(tgraph(jg), delta_cap=16, sweep=sweep)
    same_state(js, ts)
    rng = np.random.default_rng(5)
    rebuilt, finished_in_flight = 0, False
    for b in range(8):
        ins, dels = draw(rng, js, 5, 3)
        if b == 4:
            js.begin_compact()
            ts.begin_compact()
        rj, rt = js.apply(ins, dels), ts.apply(ins, dels)
        same_report(rj, rt)
        rebuilt += rt.rebuild
        if b in (4, 5) and rt.rebuild:
            finished_in_flight = True
        if b == 5 and js._rebuild_inflight is not None:
            same_report(js.finish_compact(), ts.finish_compact())
        assert ts._rebuild_inflight is None or b == 4
        same_state(js, ts)
    assert rebuilt >= 2 and ts.rebuilds == js.rebuilds
    assert finished_in_flight or ts.rebuilds >= 3


def test_overflowing_batch_during_a_rebuild_merges_into_it():
    """tests/test_streaming.py::test_mid_rebuild_overflowing_batch_finishes_the_rebuild
    on the port, against the reference's report and views."""
    jg = jgen.grid2d(6, seed=1)
    js, ts = JSG(jg, delta_cap=4), StreamingGraph(tgraph(jg), delta_cap=4)
    same_report(js.apply(inserts=[(0, 7)]), ts.apply(inserts=[(0, 7)]))
    js.begin_compact()
    ts.begin_compact()
    rj, rt = js.apply(inserts=[(1, 8), (2, 9)]), ts.apply(inserts=[(1, 8), (2, 9)])
    same_report(rj, rt)
    assert rt.rebuild and ts._rebuild_inflight is None and ts.rebuilds == 1
    assert ts.n_live_edges() == jg.n_edges + 6
    same_state(js, ts)


def test_mid_rebuild_batches_merge_exactly_once():
    """Batches landing mid-rebuild stay live in the overlay, replay into the
    rebuilt base exactly once and surface as one merged report."""
    jg = jgen.rmat(9, 8, seed=11, directed=True)
    tg = tgraph(jg)
    n = jg.n_nodes
    js, ts = JSG(jg, delta_cap=16), StreamingGraph(tg, delta_cap=16)
    cfg = default_config(tg, max_iters=256)
    for sg in (js, ts):
        sg.apply(inserts=[(1, 2), (3, 4)])
        sg.begin_compact()
    base_del = (int(jg.out.src_idx[0]), int(jg.out.col_idx[0]))
    r1 = ts.apply(inserts=[(5, 6), (7, 8)], deletes=[(1, 2)])
    r2 = ts.apply(deletes=[base_del])
    js.apply(inserts=[(5, 6), (7, 8)], deletes=[(1, 2)])
    js.apply(deletes=[base_del])
    mid, _ = run_batch(TA.bfs(0), ts.graph, ts.pack, cfg, [0], delta=ts.delta)
    merged = ts.finish_compact()
    same_report(js.finish_compact(), merged)
    same_state(js, ts)
    assert ts.rebuilds == 1 and merged.rebuild
    assert merged.n_inserted == r1.n_inserted + r2.n_inserted == 2
    assert merged.n_deleted == r1.n_deleted + r2.n_deleted == 2
    src = np.asarray(jg.out.src_idx)
    dst = np.asarray(jg.out.col_idx)
    w = np.asarray(jg.out.weights)
    keep = np.ones(src.shape[0], bool)
    keep[0] = False
    src2 = np.concatenate([src[keep], [3, 5, 7]])
    dst2 = np.concatenate([dst[keep], [4, 6, 8]])
    w2 = np.concatenate([w[keep], [1.0, 1.0, 1.0]])
    assert np.array_equal(ts.live_out_degrees(), np.bincount(src2, minlength=n)[:n])
    g_ref = tcsr.from_edges(src2, dst2, n, w2, directed=True, dedupe=False, device="cpu")
    full, _ = run_batch(TA.bfs(0), ts.graph, ts.pack, cfg, [0], delta=ts.delta)
    ref, _ = run_batch(TA.bfs(0), g_ref, tpacking.pack_ell(g_ref.inc), cfg, [0])
    assert torch.equal(full["dist"], ref["dist"])
    assert torch.equal(mid["dist"], full["dist"])


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------


def test_device_sweep_equals_host_sweep_and_the_reference():
    """The device fixpoint's dirty, affected and boundary sets equal the
    host sweep's and the reference's, over random graphs and chained
    insert+delete batches (tests/test_streaming.py's property case)."""
    rng = np.random.default_rng(42)
    for trial in range(4):
        directed = bool(trial % 2)
        jg = jgen.rmat(8 + trial % 2, 6, seed=trial, directed=directed)
        tg = tgraph(jg)
        jh = JSG(jg, delta_cap=64, sweep="host")
        th = StreamingGraph(tg, delta_cap=64, sweep="host")
        td = StreamingGraph(tg, delta_cap=64, sweep="device")
        for _batch in range(3):
            ins, dels = draw(rng, jh, 7, 4)
            rj, rh, rd = jh.apply(ins, dels), th.apply(ins, dels), td.apply(ins, dels)
            for r in (rh, rd):
                assert np.array_equal(rj.dirty_src, r.dirty_src), (trial, _batch)
                assert np.array_equal(rj.affected_del, r.affected_del), (trial, _batch)
                assert np.array_equal(rj.boundary, r.boundary), (trial, _batch)
        assert "reverse" in td._sweep_dev and not th._sweep_dev


def test_device_sweep_survives_overflow_batch(monkeypatch):
    """An overflowing batch (pending insertions past delta_cap before the
    rebuild) sweeps on the device with no pad to outgrow; its report equals
    the host sweep's and the reference's."""
    jg = jgen.rmat(9, 8, seed=11, directed=True)
    ins = [(i, (3 * i + 7) % jg.n_nodes) for i in range(1, 9)]
    rj = JSG(jg, delta_cap=4, sweep="device").apply(inserts=ins)
    rh = StreamingGraph(tgraph(jg), delta_cap=4, sweep="host").apply(inserts=ins)
    td = StreamingGraph(tgraph(jg), delta_cap=4, sweep="device")

    def no_host_sweep(*a):
        raise AssertionError("the host sweep ran")

    monkeypatch.setattr(delta_mod, "_reach", no_host_sweep)
    rd = td.apply(inserts=ins)
    assert rd.rebuild and rh.rebuild
    same_report(rj, rd)
    assert np.array_equal(rd.dirty_src, rh.dirty_src)
    assert td.stats()["rebuilds"] == 1


def test_sweep_auto_routes_by_size():
    """'auto' keeps small graphs on the host path and big ones on device."""
    tg = tgen.rmat(9, 8, seed=3, device="cpu")
    sg = StreamingGraph(tg, delta_cap=8)
    assert tg.n_edges < sg.DEVICE_SWEEP_MIN_EDGES
    sg.apply(inserts=[(1, 2)])
    assert not sg._sweep_dev, "a small graph must not take the device sweep"
    sg.sweep = "device"
    sg.apply(inserts=[(3, 4)])
    assert "reverse" in sg._sweep_dev
    big = tgen.rmat(12, 16, seed=1, device="cpu")
    sg = StreamingGraph(big, delta_cap=8)
    assert big.n_edges >= sg.DEVICE_SWEEP_MIN_EDGES
    sg.apply(inserts=[(1, 2)])
    assert "reverse" in sg._sweep_dev


# ---------------------------------------------------------------------------
# the overlay's own contracts (tests/test_streaming.py on the port)
# ---------------------------------------------------------------------------


def test_overlay_noop_matches_plain():
    tg = tgen.rmat(9, 8, seed=3, device="cpu")
    sg = StreamingGraph(tg, delta_cap=32)
    cfg = default_config(tg, max_iters=64)
    sources = [0, 7, tg.n_nodes - 1]
    m_ov, _ = run_batch(TA.bfs(0), sg.graph, sg.pack, cfg, sources, delta=sg.delta)
    m_pl, _ = run_batch(TA.bfs(0), tg, tpacking.pack_ell(tg.inc), cfg, sources)
    for k in m_pl:
        assert torch.equal(m_ov[k], m_pl[k])


def test_deletion_cuts_chain():
    n = 64
    tg = tgen.chain(n, weighted=False, device="cpu")
    sg = StreamingGraph(tg, delta_cap=8)
    cfg = default_config(tg, max_iters=256)
    prev, _ = run_batch(TA.bfs(0), sg.graph, sg.pack, cfg, [0], delta=sg.delta)
    assert float(query_result(prev, "dist", 0)[n - 1]) == n - 1
    cut = n // 2
    assert sg.apply(deletes=[(cut, cut + 1)]).n_deleted == 2
    cut_run, _ = run_batch(TA.bfs(0), sg.graph, sg.pack, cfg, [0], delta=sg.delta)
    d = query_result(cut_run, "dist", 0).numpy()
    big = float(np.finfo(np.float32).max / 4)
    assert np.all(d[:cut + 1] == np.arange(cut + 1))
    assert np.all(d[cut + 1:] == big), "beyond the cut must be unreachable"
    sg.apply(inserts=[(cut, cut + 1)])          # back through the delta buffer
    again, _ = run_batch(TA.bfs(0), sg.graph, sg.pack, cfg, [0], delta=sg.delta)
    assert float(query_result(again, "dist", 0)[n - 1]) == n - 1


def test_delta_overflow_triggers_rebuild():
    tg = tgen.grid2d(6, seed=1, device="cpu")
    sg = StreamingGraph(tg, delta_cap=4)
    cfg = default_config(tg, max_iters=256)
    rng = np.random.default_rng(2)
    inserted = []
    for _ in range(4):
        u, v = rng.integers(0, 36, size=2)
        while u == v:
            u, v = rng.integers(0, 36, size=2)
        if sg.apply(inserts=[(int(u), int(v))]).n_inserted:
            inserted.append((int(u), int(v)))
    assert sg.rebuilds >= 1
    full, _ = run_batch(TA.bfs(0), sg.graph, sg.pack, cfg, [0], delta=sg.delta)
    src = np.concatenate([tg.out.src_idx.numpy(), [e[0] for e in inserted]])
    dst = np.concatenate([tg.out.col_idx.numpy(), [e[1] for e in inserted]])
    g2 = tcsr.from_edges(src, dst, 36, None, directed=False, dedupe=True, device="cpu")
    ref, _ = run_batch(TA.bfs(0), g2, tpacking.pack_ell(g2.inc), cfg, [0])
    assert torch.equal(full["dist"], ref["dist"])


def test_materialize_is_identity_stable_across_batches():
    """A batch re-creates ONLY the view tensors whose backing state it
    touched: insert-only keeps the CSR and the slices, a deletion keeps the
    delta views and every slice it did not hit."""
    tg = tgen.rmat(9, 8, seed=3, directed=True, device="cpu")
    sg = StreamingGraph(tg, delta_cap=16)
    col0, d0 = sg.graph.out.col_idx, sg.delta.src
    slices0 = [s.nbr for s in sg.pack.slices[:-1]]
    sg.apply(inserts=[(1, 2)])
    assert sg.graph.out.col_idx is col0
    assert all(a is b.nbr for a, b in zip(slices0, sg.pack.slices[:-1]))
    assert sg.delta.src is not d0
    d1, dslice = sg.delta.src, sg.pack.slices[-1].nbr
    rep = sg.apply(deletes=[(int(tg.out.src_idx[5]), int(tg.out.col_idx[5]))])
    assert rep.n_deleted == 1
    assert sg.graph.out.col_idx is not col0
    assert sg.delta.src is d1 and sg.pack.slices[-1].nbr is dslice
    hit = int(sg._pack_pos[int(tpacking_pos(sg, tg, 5)), 0])
    for si, (a, b) in enumerate(zip(slices0, sg.pack.slices[:-1])):
        assert (a is b.nbr) == (si != hit), si
    assert torch.equal(col0[:5], sg.graph.out.col_idx[:5])       # a clone, one write
    assert int(sg.graph.out.col_idx[5]) == tg.n_nodes


def tpacking_pos(sg, tg, e):
    """The in-CSR position of out-edge `e` (u, v): the edge (v <- u)."""
    u, v = int(tg.out.src_idx[e]), int(tg.out.col_idx[e])
    rp, ci = tg.inc.row_ptr.numpy(), tg.inc.col_idx.numpy()
    return rp[v] + np.searchsorted(ci[rp[v]:rp[v + 1]], u)


def test_delta_buffers_keep_static_shapes():
    n, cap = 50, 16
    empty = tpacking.delta_ell_slice(np.zeros(0), np.zeros(0), np.zeros(0), n, cap,
                                     device="cpu")
    filled = tpacking.delta_ell_slice(np.asarray([1, 2, 3]), np.asarray([4, 5, 6]),
                                      np.asarray([1.0, 1.0, 1.0]), n, cap, device="cpu")
    assert empty.nbr.shape == filled.nbr.shape
    assert empty.row_id.shape == filled.row_id.shape
    assert not filled.rows_ascending
    d = tcsr.empty_delta(n, cap, device="cpu")
    assert d.src.shape == (cap,) and bool((d.src == n).all())


# ---------------------------------------------------------------------------
# the solo engine with a delta
# ---------------------------------------------------------------------------


def test_solo_engine_delta_bitwise_vs_rebuild():
    """`core.engine.run(..., delta=sg.delta)` over the overlay views is
    bit-equal to a run on the graph folded from the live edges, for the
    monotone programs, and to the reference's overlay run."""
    jg = jgen.rmat(10, 8, seed=7, directed=True)
    tg = tgraph(jg)
    rng = np.random.default_rng(1)
    n = jg.n_nodes
    ins = [(int(rng.integers(0, n)), int(rng.integers(0, n)),
            float(rng.integers(1, 65))) for _ in range(12)]
    eidx = rng.integers(0, jg.n_edges, size=6)
    dels = [(int(jg.out.src_idx[i]), int(jg.out.col_idx[i])) for i in eidx]
    js, sg = JSG(jg, delta_cap=64), StreamingGraph(tg, delta_cap=64)
    js.apply(ins, dels)
    sg.apply(ins, dels)
    src, dst = sg.live_edges_coo()
    w = torch.cat([tg.out.weights[~sg._dead_out],
                   torch.tensor([e[2] for e in sg._ins], dtype=torch.float32)])
    g_ref = tcsr.from_edges(src, dst, n, w, directed=True, dedupe=False, device="cpu")
    pack_ref = tpacking.pack_ell(g_ref.inc)
    cfg = default_config(tg, max_iters=256)
    jcfg = JE.EngineConfig(frontier_cap=cfg.frontier_cap, edge_cap=cfg.edge_cap,
                           max_iters=256)
    for jf, tf in ((JA.bfs, TA.bfs), (JA.sssp, TA.sssp)):
        for source in (0, 17, 333, n - 1):
            m_ov, _ = TE.run(tf(source), sg.graph, sg.pack, cfg, delta=sg.delta)
            m_rb, _ = TE.run(tf(source), g_ref, pack_ref, cfg)
            assert torch.equal(m_ov["dist"], m_rb["dist"]), source
            m_j, _ = JE.run(jf(source), js.graph, js.pack, jcfg, delta=js.delta)
            assert np.array_equal(np.asarray(m_j["dist"]), m_ov["dist"].numpy()), source


def test_solo_engine_delta_matches_batched_overlay():
    tg = tgen.rmat(9, 8, seed=3, device="cpu")
    sg = StreamingGraph(tg, delta_cap=32)
    sg.apply(inserts=[(0, 9), (9, 41), (200, 3)])
    cfg = default_config(tg, max_iters=64)
    sources = [0, 9, 200]
    m_b, _ = run_batch(TA.bfs(0), sg.graph, sg.pack, cfg, sources, delta=sg.delta)
    for lane, s in enumerate(sources):
        m_s, _ = TE.run(TA.bfs(s), sg.graph, sg.pack, cfg, delta=sg.delta)
        assert torch.equal(query_result(m_b, "dist", lane), m_s["dist"][:-1]), s


# ---------------------------------------------------------------------------
# the rest of the surface
# ---------------------------------------------------------------------------


def test_delta_shards_names_the_multi_device_item():
    sg = StreamingGraph(tgen.rmat(6, 4, seed=1, device="cpu"), delta_cap=4)
    with pytest.raises(NotImplementedError, match="item 8"):
        sg.delta_shards(2)


def test_apply_records_a_flight_event(monkeypatch):
    ring = recorder.FlightRecorder(capacity=16)
    monkeypatch.setattr(recorder, "GLOBAL", ring)
    sg = StreamingGraph(tgen.rmat(6, 4, seed=1, device="cpu"), delta_cap=4)
    sg.apply(inserts=[(1, 2)], deletes=[(5, 5)])
    ev = [e for e in ring.events() if e["kind"] == "stream_apply"]
    assert len(ev) == 1
    assert (ev[0]["version"], ev[0]["inserted"], ev[0]["ignored"]) == (1, 2, 1)


def test_views_live_on_the_graphs_device_and_default_to_the_card():
    sg = StreamingGraph(tgen.rmat(6, 4, seed=1, device="cpu"), delta_cap=4)
    assert sg.device.type == "cpu"
    assert all(s.nbr.device.type == "cpu" for s in sg.pack.slices)
    assert sg.delta.src.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tgen.rmat(6, 4, seed=1)
