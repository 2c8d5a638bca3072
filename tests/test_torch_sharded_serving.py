"""Sharded pools behind the port's `GraphServer` (`serving/placement.py`,
`GraphServer(mesh=, placements=)`), with streaming updates, against the
reference on small graphs and CPU meshes of `["cpu"] * k`.

Mirrors the placement cases of tests/test_sharded.py, the sharded cases of
tests/test_ppr_delta.py and tests/test_streaming.py's edge-sharded refresh.
The reference's sharded serving paths raise under the installed JAX (ROADMAP
§3), so completions are held against the reference's and the port's
single-device servers (DESIGN.md §9: replicated placements and min programs
bit-equal, edge-sharded sums within rtol 1e-5, atol 1e-7, residual lanes
resumed across an update within 1e-3), and the shipped counts against the
rows and leaves the reference's diff would ship, computed from the
reference's own `partition` functions.
"""

import types

import numpy as np
import pytest
import torch

from repro import serving as JS
from repro.core import algorithms as JA
from repro.graph import generators as jgen
from repro.graph import pack_ell as jpack
from repro.graph import partition as jpart
from repro.streaming import StreamingGraph as JStreamingGraph
from repro_torch import interop
from repro_torch import serving as TS
from repro_torch.core import algorithms as TA
from repro_torch.graph import packing as tpacking
from repro_torch.launch import serve_graph as tserve
from repro_torch.launch import stream_graph as tstream
from repro_torch.serving import placement as TP
from repro_torch.serving.batch_engine import HOST_READS, GraphDims

SHIP_KEYS = {"replicated_leaves_shipped", "replicated_leaves_total", "edge_shards_shipped",
             "delta_shards_shipped", "n_edge_shards"}


def _mesh(d, s):
    return TS.make_serving_mesh(d, s, devices=["cpu"] * (d * s))


def _tgraph(jg):
    return interop.graph_from_numpy(interop.csr_arrays(jg.out), interop.csr_arrays(jg.inc),
                                    device="cpu")


@pytest.fixture(scope="module")
def served():
    jg = jgen.rmat(9, 8, seed=3, directed=True)
    tg = _tgraph(jg)
    return jg, jpack(jg.inc), tg, tpacking.pack_ell(tg.inc)


def _progs(A, names):
    return {a: getattr(A, a)(0) for a in names}


# ---------------------------------------------------------------------------
# placement plumbing
# ---------------------------------------------------------------------------


def test_placement_coercion_and_mesh_validation():
    for P in (JS.Placement, TS.Placement):
        assert P.of("replicated") == P("replicated", 1)
        assert P.of(("edge_sharded", 4)).n_shards == 4
        assert P.of(P("replicated", 2)).kind == "replicated"
        with pytest.raises(AssertionError):
            P("diagonal", 2)
        with pytest.raises(AssertionError):
            P("replicated", 0)
        mesh = types.SimpleNamespace(shape={"data": 2, "model": 4})
        with pytest.raises(AssertionError, match="wants 1 query shards"):
            P("replicated", 1).check_mesh(mesh)
        with pytest.raises(AssertionError, match="wants 2 edge shards"):
            P("edge_sharded", 2).check_mesh(mesh)
        P("replicated", 2).check_mesh(mesh)
        P("edge_sharded", 4).check_mesh(mesh)
    tm = _mesh(2, 4)
    TS.Placement("replicated", 2).check_mesh(tm)
    with pytest.raises(AssertionError):
        TS.Placement("edge_sharded", 2).check_mesh(tm)


def test_free_lanes_round_robin_across_shards(served):
    _jg, _jp, tg, tp = served
    pool = TP.ShardedAlgoPool("bfs", TA.bfs(0), tg, tp, TS.default_config(tg), 6,
                              _mesh(2, 1), ("replicated", 2))
    # shard 0 owns lanes 0-2, shard 1 owns 3-5: alternate between them
    assert pool.free_lanes() == [0, 3, 1, 4, 2, 5]
    pool.admit(0, 7, 5)        # a busy lane drops out, the order holds
    assert pool.free_lanes() == [3, 1, 4, 2, 5]
    with pytest.raises(AssertionError):
        TP.ShardedAlgoPool("bfs", TA.bfs(0), tg, tp, TS.default_config(tg), 5,
                           _mesh(2, 1), ("replicated", 2))
    with pytest.raises(AssertionError, match="placements require a serving mesh"):
        TS.GraphServer(tg, tp, {"bfs": TA.bfs(0)}, placements={"bfs": "replicated"})


@pytest.mark.parametrize("algo", ["ppr", "ppr_delta"])
def test_edge_sharded_sum_pools_key_cache_by_placement(served, algo):
    _jg, _jp, tg, tp = served
    cfg = TS.default_config(tg, max_iters=128)
    srv = TS.GraphServer(tg, tp, _progs(TA, (algo, "bfs")), slots=2, cfg=cfg,
                         cache_capacity=16, result_fields={algo: "rank"}, mesh=_mesh(1, 1),
                         placements={algo: ("edge_sharded", 1), "bfs": ("edge_sharded", 1)})
    tag = (("placement", "edge_sharded"),)
    assert srv.pools[algo].cache_params == tag
    assert srv.pools["bfs"].cache_params == ()       # min programs are bit-exact
    rid = srv.submit(algo, 3)
    srv.drain()
    assert any(k[1] == algo and k[3] == tag for k in srv.cache._entries)
    rid2 = srv.submit(algo, 3)
    comp = [c for c in srv.drain() if c.rid == rid2][0]
    assert comp.from_cache and rid != rid2
    assert srv.stats()["pools"][algo]["placement"] == "edge_sharded"


# ---------------------------------------------------------------------------
# serving through placed pools
# ---------------------------------------------------------------------------

ALGOS = ("bfs", "sssp", "ppr", "ppr_delta")
FIELDS = {"ppr": "rank", "ppr_delta": "rank"}


def _stream(srv, n, k=24):
    rng = np.random.default_rng(0)
    for i in range(k):
        algo = ALGOS[i % len(ALGOS)]
        src = int(rng.integers(0, n))
        while srv.submit(algo, src) is None:
            srv.pump()
        srv.pump()
    return srv.drain()


@pytest.mark.parametrize("shape,kind", [((2, 1), "replicated"), ((4, 1), "replicated"),
                                        ((1, 2), "edge_sharded"), ((2, 2), "edge_sharded")])
def test_placed_server_serves_the_single_device_results(served, shape, kind):
    jg, jp, tg, tp = served
    n_shards = shape[0] if kind == "replicated" else shape[1]
    kw = dict(slots=4, queue_cap=8, cache_capacity=8, result_fields=FIELDS)
    srv = TS.GraphServer(tg, tp, _progs(TA, ALGOS), cfg=TS.default_config(tg), mesh=_mesh(*shape),
                         placements={a: TS.Placement(kind, n_shards) for a in ALGOS}, **kw)
    one = TS.GraphServer(tg, tp, _progs(TA, ALGOS), cfg=TS.default_config(tg), **kw)
    ref = JS.GraphServer(jg, jp, _progs(JA, ALGOS), cfg=JS.default_config(jg), **kw)
    reads = HOST_READS["pool"]
    got = _stream(srv, tg.n_nodes)
    reads = HOST_READS["pool"] - reads
    steps = sum(p.steps for _n, p, _d in srv._leaves())
    assert steps <= reads <= 3 * steps       # one read a step, one a round of admissions
    for want_list, bits in ((_stream(one, tg.n_nodes), kind == "replicated"),
                            (_stream(ref, jg.n_nodes), False)):
        assert len(got) == len(want_list) == 24
        for c, w in zip(got, want_list):
            assert (c.rid, c.algo, c.source, c.from_cache) == (w.rid, w.algo, w.source,
                                                               w.from_cache)
            if bits or TA.__dict__[c.algo](0).combiner.name != "sum":
                np.testing.assert_array_equal(c.result, np.asarray(w.result), err_msg=c.algo)
            else:
                np.testing.assert_allclose(c.result, np.asarray(w.result), rtol=1e-5,
                                           atol=1e-7, err_msg=c.algo)
            if bits:
                assert c.iterations == w.iterations


def _reference_ship(jsg, prev, kind, n_shards):
    """What the reference's `set_graph` diff ships for the reference
    StreamingGraph `jsg` after the previous views `prev`: the edge and
    overlay shard rows whose contents changed (its own partition functions),
    and the replicated leaves whose contents changed. (The reference's diff
    goes by leaf identity, and its streaming layer re-creates a touched
    slice's unchanged `row_id`, so it ships that leaf too; the port's keeps
    an unchanged leaf's identity.)"""
    import jax

    if kind == "replicated":
        views = (jsg.graph, jsg.pack, jsg.delta)
        # copies: `np.asarray` of a CPU jax array can alias its buffer, which
        # a later update may reuse, so the previous version's contents would
        # read as the new ones
        leaves = [[np.array(x) for x in jax.tree_util.tree_leaves(v)] for v in views]
        total = sum(len(x) for x in leaves)
        if prev is None:
            return {"replicated_leaves_total": total, "replicated_leaves_shipped": total}, leaves
        shipped = 0
        for new, old in zip(leaves, prev):
            shipped += (sum(not np.array_equal(a, b) for a, b in zip(new, old))
                        if len(new) == len(old) else len(new))
        return {"replicated_leaves_total": total, "replicated_leaves_shipped": shipped}, leaves
    es = jpart.shard_edges_np(jsg.graph, n_shards)
    ds = jpart.shard_delta_np(jsg.delta, n_shards, jsg.n)
    if prev is None:
        return {"edge_shards_shipped": n_shards, "delta_shards_shipped": n_shards}, (es, ds)

    def rows(new, old):
        return {r for a, b in zip(new, old) for r in range(n_shards)
                if not np.array_equal(a[r], b[r])}

    return ({"edge_shards_shipped": len(rows(es, prev[0])),
             "delta_shards_shipped": len(rows(ds, prev[1]))}, (es, ds))


@pytest.mark.parametrize("kind", ["replicated", "edge_sharded"])
def test_apply_updates_ships_what_the_reference_ships_and_never_serves_stale(served, kind):
    jg, _jp, tg, _tp = served
    n_shards = 3
    shape = (3, 1) if kind == "replicated" else (1, 3)
    cfg = TS.default_config(tg, max_iters=128)
    srv = TS.GraphServer(tg, None, _progs(TA, ("bfs", "sssp", "ppr_delta")), slots=3, cfg=cfg,
                         cache_capacity=32, delta_cap=16, result_fields=FIELDS,
                         mesh=_mesh(*shape),
                         placements={a: (kind, n_shards) for a in ("bfs", "sssp", "ppr_delta")})
    jsg = JStreamingGraph(jg, delta_cap=16)
    _ship, prev = _reference_ship(jsg, None, kind, n_shards)
    batches = [([(1, 5), (9, 41)], []),
               ([], [(int(jg.out.src_idx[0]), int(jg.out.col_idx[0]))]),
               ([(7, 9), (300, 2), (2, 300)], [(int(jg.out.src_idx[50]), int(jg.out.col_idx[50]))]),
               ([(11, 12)], [])]
    snapshots = {0: (srv.sg.graph, srv.sg.pack, srv.sg.delta)}
    rng = np.random.default_rng(1)
    comps = []
    for ins, dels in batches:
        for _ in range(4):
            srv.submit(("bfs", "sssp", "ppr_delta")[int(rng.integers(0, 3))],
                       int(rng.integers(0, tg.n_nodes)))
        srv.pump()
        st = srv.apply_updates(inserts=ins, deletes=dels)
        jsg.apply(ins, dels)
        snapshots[st["version"]] = (srv.sg.graph, srv.sg.pack, srv.sg.delta)
        want, prev = _reference_ship(jsg, prev, kind, n_shards)
        for name, ship in st["shipped"].items():
            assert set(ship) == SHIP_KEYS, name
            assert ship["n_edge_shards"] == (1 if kind == "replicated" else n_shards)
            for k, v in want.items():
                assert ship[k] == v, (name, k, ship, want)
        assert srv.stats()["last_update"]["shipped"] == st["shipped"]
    comps = srv.drain()
    assert comps
    for c in comps:
        g, p, d = snapshots[c.graph_version]
        ref, _ = TS.run_batch(TA.__dict__[c.algo](0), g, p, cfg, [c.source], delta=d)
        want = TS.query_result(ref, srv.pools[c.algo].result_field, 0).numpy()
        if c.algo == "ppr_delta":
            assert np.abs(c.result - want).max() < 1e-3
        else:
            np.testing.assert_array_equal(c.result, want, err_msg=(c.algo, c.graph_version))
    counts = srv.stats()["shard_delta"]
    assert set(counts) == {"full_reslice", "short_circuit"}


def test_edge_sharded_admission_is_csr_free(served, monkeypatch):
    _jg, _jp, tg, tp = served
    cfg = TS.default_config(tg, max_iters=64)
    srv = TS.GraphServer(tg, tp, {"sssp": TA.sssp(0)}, slots=2, cfg=cfg, cache_capacity=0,
                         mesh=_mesh(1, 2), placements={"sssp": ("edge_sharded", 2)})
    ref = TS.GraphServer(tg, tp, {"sssp": TA.sssp(0)}, slots=2, cfg=cfg, cache_capacity=0)
    pool = srv.pools["sssp"]
    assert pool.live_deg is pool.engine.deg, "the degree count is reused"
    seen = []
    real = TP._admit_lane

    def spy(program, g, *a, **kw):
        seen.append((g, kw["deg"]))
        return real(program, g, *a, **kw)

    monkeypatch.setattr(TP, "_admit_lane", spy)
    for s in [0, 7, 101, tg.n_nodes - 1]:
        srv.submit("sssp", s)
        ref.submit("sssp", s)
    c1 = {c.source: c.result for c in srv.drain()}
    c2 = {c.source: c.result for c in ref.drain()}
    assert len(seen) == 4
    assert all(isinstance(g, GraphDims) and d is pool.live_deg for g, d in seen)
    for k in c2:
        np.testing.assert_array_equal(c1[k], c2[k])


def test_overflow_rebuild_refreshes_the_edge_count(served):
    jg, _jp, tg, _tp = served
    cfg = TS.default_config(tg, max_iters=64)
    srv = TS.GraphServer(tg, None, _progs(TA, ("bfs", "sssp")), slots=2, cfg=cfg,
                         cache_capacity=0, delta_cap=2, mesh=_mesh(1, 1),
                         placements={"bfs": ("replicated", 1), "sssp": ("edge_sharded", 1)})
    m0 = srv.pools["sssp"].engine.n_edges
    st = srv.apply_updates(inserts=[(1, 5), (2, 9), (3, 7)])     # 3 > cap 2
    assert st["rebuild"]
    sg = srv.sg
    for algo in ("bfs", "sssp"):
        assert srv.pools[algo].engine.n_edges == sg.graph.n_edges != m0
        rid = srv.submit(algo, 3)
        comp = [c for c in srv.drain() if c.rid == rid][0]
        ref, _ = TS.run_batch(TA.__dict__[algo](0), sg.graph, sg.pack, cfg, [3], delta=sg.delta)
        np.testing.assert_array_equal(comp.result, ref["dist"][:-1, 0].numpy())


def test_cached_ppr_delta_refreshes_through_edge_sharded_pool():
    """tests/test_streaming.py's case: tagged (rank, resid) entries refresh
    and re-key under the same tag."""
    g8 = jgen.grid2d(8, seed=5)
    tg = _tgraph(g8)
    cfg = TS.default_config(tg, max_iters=256)
    srv = TS.GraphServer(tg, None, {"ppr_delta": TA.ppr_delta(0)}, slots=2, cfg=cfg,
                         cache_capacity=64, delta_cap=32, result_fields=FIELDS,
                         mesh=_mesh(1, 2), placements={"ppr_delta": ("edge_sharded", 2)})
    tag = srv.pools["ppr_delta"].cache_params
    assert tag == (("placement", "edge_sharded"),)
    for s in [0, 33]:
        srv.submit("ppr_delta", s)
    srv.drain()
    st = srv.apply_updates(inserts=[(1, 62)], deletes=[(0, 1)])
    assert st["cache_refreshed"] == 2 and st["cache_dropped"] == 0, st
    assert all(k[3] == tag for k in srv.cache._entries)
    rid = srv.submit("ppr_delta", 0)
    comp = [c for c in srv.drain() if c.rid == rid][0]
    assert comp.from_cache
    sg = srv.sg
    ref, _ = TS.run_batch(TA.ppr_delta(0), sg.graph, sg.pack, cfg, [0], delta=sg.delta)
    assert np.abs(comp.result - ref["rank"][:-1, 0].numpy()).max() < 1e-3


@pytest.mark.parametrize("kind", ["replicated", "edge_sharded"])
def test_sharded_pool_inflight_resume_across_update(kind):
    """tests/test_ppr_delta.py's case on a 2-shard mesh: the in-flight
    residual resume goes through the sharded pool's gathered state."""
    tg = _tgraph(jgen.grid2d(8, seed=5))
    cfg = TS.default_config(tg, max_iters=256)
    srv = TS.GraphServer(tg, None, {"ppr_delta": TA.ppr_delta(0)}, slots=2, cfg=cfg,
                         cache_capacity=16, delta_cap=16, result_fields=FIELDS,
                         mesh=_mesh(2, 1) if kind == "replicated" else _mesh(1, 2),
                         placements={"ppr_delta": TS.Placement(kind, 2)})
    srv.submit("ppr_delta", 0)
    srv.submit("ppr_delta", 63)
    srv.pump()
    pool = srv.pools["ppr_delta"]
    assert any(r is not None for r in pool.lane_rid)
    before = pool.engine_queries
    st = srv.apply_updates(inserts=[(1, 62)], deletes=[(0, 1)])
    assert st["resumed_inflight"] >= 1, st
    assert pool.engine_queries == before, "a resume is not a readmit"
    comps = {c.source: c for c in srv.drain()}
    sg = srv.sg
    ref, _ = TS.run_batch(TA.ppr_delta(0), sg.graph, sg.pack, cfg, [0, 63], delta=sg.delta)
    for i, s in enumerate([0, 63]):
        assert np.abs(comps[s].result - ref["rank"][:-1, i].numpy()).max() < 1e-3, s


def test_preempt_resume_through_a_replicated_pool_bit_identical(served):
    """A preempted ppr_delta lane of a 2-shard pool resumes in a lane of the
    other shard and finishes with the bits of an uninterrupted run."""
    _jg, _jp, tg, tp = served
    cfg = TS.default_config(tg, max_iters=256)
    pool = TP.ShardedAlgoPool("ppr_delta", TA.ppr_delta(0), tg, tp, cfg, 4, _mesh(2, 1),
                              ("replicated", 2), result_field="rank")
    ref = TS.AlgoPool("ppr_delta", TA.ppr_delta(0), tg, tp, cfg, 4, result_field="rank")
    for p in (pool, ref):
        p.admit(0, 1, 17)
        p.admit(2, 2, 40)
        for _ in range(3):
            p.step()
    saved = pool.preempt(0)
    pool.admit_resume(3, 1, saved)
    out = {}
    for p in (pool, ref):
        while p.live():
            p.step()
            for lane, rid, res, _it, _x in p.harvest():
                out.setdefault(rid, []).append(res)
    for rid, (a, b) in out.items():
        np.testing.assert_array_equal(a, b, err_msg=rid)


def test_stats_schema_equal_to_the_reference(served):
    """`stats()` of a placed server has the reference's single-device schema
    plus a pool's `shipped` and placement kind."""
    jg, jp, tg, tp = served

    def schema(d):
        if isinstance(d, dict):
            return {k: schema(v) for k, v in d.items()
                    if not (isinstance(k, str) and "." in k)}
        return type(d).__name__ if d is not None else None

    kw = dict(slots=2, cache_capacity=8, result_fields=FIELDS, telemetry=True, delta_cap=8)
    jsrv = JS.GraphServer(jg, None, _progs(JA, ("bfs", "ppr_delta")), **kw)
    tsrv = TS.GraphServer(tg, None, _progs(TA, ("bfs", "ppr_delta")), mesh=_mesh(2, 1),
                          placements={"bfs": ("replicated", 2), "ppr_delta": ("replicated", 2)},
                          **kw)
    for srv in (jsrv, tsrv):
        srv.submit("bfs", 3)
        srv.submit("ppr_delta", 3)
        srv.drain()
        srv.apply_updates(inserts=[(1, 2)])
    js, ts = jsrv.stats(), tsrv.stats()
    for name in ("bfs", "ppr_delta"):
        assert ts["pools"][name].pop("shipped").keys() == SHIP_KEYS
        assert ts["pools"][name]["placement"] == "replicated"
        js["pools"][name]["placement"] = "replicated"
        js["pools"][name]["imbalance"]["shard_edges"] = ts["pools"][name]["imbalance"][
            "shard_edges"]
    js["last_update"]["shipped"] = ts["last_update"]["shipped"] = {}
    assert set(ts) == set(js) | {"queue"}       # the port's queue-wait counter
    for k in js:
        if k == "obs":
            continue
        assert schema(js[k]) == schema(ts[k]), k
    assert len(ts["pools"]["bfs"]["imbalance"]["shard_edges"]) == 2


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh,placement", [("4x1", "replicated"), ("1x4", "edge_sharded")])
def test_serve_graph_mesh_verifies(capsys, mesh, placement):
    rc = tserve.main(["--device", "cpu", "--requests", "16", "--slots", "4", "--scale", "8",
                      "--mesh", mesh, "--placement", placement, "--verify"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[serve_graph] verify: 16/16 OK" in out
    assert f"[serve_graph] sharded pools: mesh {mesh}, placement={placement}" in out
    assert "[serve_graph] mesh " + mesh + ": all 4 shards on cpu" in out
    assert out.count(f"[{placement}]") == 3


@pytest.mark.parametrize("mesh,placement,algos", [
    ("4x1", "replicated", "bfs,sssp,ppr"),
    ("1x4", "edge_sharded", "bfs,sssp,ppr_delta"),
])
def test_stream_graph_mesh_verifies(capsys, mesh, placement, algos):
    rc = tstream.main(["--device", "cpu", "--requests", "24", "--slots", "4", "--scale", "8",
                       "--update-every", "4", "--mesh", mesh, "--placement", placement,
                       "--algos", algos, "--verify"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[stream_graph] verify: 24/24 OK" in out
    assert f"[stream_graph] sharded pools: mesh {mesh}, placement={placement}" in out


def test_launcher_mesh_errors(capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--mesh", "4by1"])
    with pytest.raises(SystemExit):
        tstream.main(["--device", "cpu", "--mesh", "3x1", "--slots", "4"])
    assert "must divide over 3 query shards" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tserve.device_mesh(2, 1, torch.device("cuda"), "serve_graph")
