"""The port's edge partition (`graph/partition.py`), mesh collectives
(`mesh.py`) and `serving.ShardedBatchEngine`, against the reference on small
RMAT graphs and CPU meshes of `["cpu"] * k`.

Contracts (tests/test_sharded.py's): query-sharded lanes and mode traces are
bit-equal to the single-device batched engine; edge-partitioned min programs
are bit-equal and sums within rtol 1e-5, atol 1e-7; the compacted edge scan
is bit-equal to the dense one (also when it overflows); a (1, 1) mesh is
bit-equal to `run_batch` (the edge-sharded sums within tolerance, as in the
reference: the COO scan replaces the ELL tree). The reference's sharded
ppr_delta path fails under this JAX, so ppr_delta is held against the
single-device engines (DESIGN.md §9), and one subprocess holds bfs, sssp and
ppr against the reference's own `ShardedBatchEngine` on a forced (2, 2) mesh.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from jax import numpy as jnp

from repro import serving as JS
from repro.core import algorithms as JA
from repro.graph import generators as jgen
from repro.graph import pack_ell as jpack
from repro.graph import partition as jpart
from repro.graph.csr import EdgeDelta as JEdgeDelta
from repro.graph.csr import from_edges
from repro_torch import interop
from repro_torch import mesh as TM
from repro_torch import serving as TS
from repro_torch.core import algorithms as TA
from repro_torch.core.acc import SUM_AGG
from repro_torch.core.engine import EngineConfig
from repro_torch.graph import csr as tcsr
from repro_torch.graph import packing as tpacking
from repro_torch.graph import partition as tpart
from repro_torch.obs import TELE_LEN, shard_plane, tele_dict
from repro_torch.serving import batch_engine as TB
from repro_torch.serving import sharded as TSH
from repro_torch.streaming import StreamingGraph

ROOT = Path(__file__).resolve().parent.parent
CPU4 = ["cpu"] * 4
PROGRAMS = ("bfs", "sssp", "ppr", "ppr_delta")
FIELD = {"bfs": "dist", "sssp": "dist", "ppr": "rank", "ppr_delta": "rank"}


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


def _assert_lanes(name, got, want):
    if TA.__dict__[name](0).combiner.name == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_shard_edges_equal_to_the_reference(served, n_shards):
    jg, _jp, tg, _tp = served
    ref = jpart.shard_edges_np(jg, n_shards)
    host = tpart.shard_edges_np(tg, n_shards)
    dev = tpart.shard_edges(tg, n_shards)
    for r, h, d in zip(ref, host, (dev.src, dev.dst, dev.wgt)):
        np.testing.assert_array_equal(h, r)
        np.testing.assert_array_equal(d.numpy(), r)
        assert h.dtype == r.dtype
    assert dev.n_shards == n_shards and dev.edges_per_shard % 128 == 0
    assert tpart.shard_nodes(tg.n_nodes, n_shards) == jpart.shard_nodes(jg.n_nodes, n_shards)


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_shard_delta_equal_to_the_reference_and_counted(n_shards):
    n, cap = 100, 7
    src = np.full(cap, n, np.int32)
    dst = np.full(cap, n, np.int32)
    w = np.zeros(cap, np.float32)
    src[:4], dst[:4], w[:4] = [1, 2, 3, 9], [4, 5, 6, 8], [1.0, 2.0, 3.0, 4.0]
    jd = JEdgeDelta(*(jnp.asarray(a) for a in (src, dst, w)))
    td = tcsr.EdgeDelta(*(torch.from_numpy(a) for a in (src, dst, w)))
    before = dict(tpart.SHARD_DELTA_STATS)
    ref = jpart.shard_delta(jd, n_shards, n)
    got = tpart.shard_delta(td, n_shards, n)
    for r, g in zip((ref.src, ref.dst, ref.w), (got.src, got.dst, got.w)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for r, g in zip(jpart.shard_delta_np(jd, n_shards, n), tpart.shard_delta_np(td, n_shards, n)):
        np.testing.assert_array_equal(g, r)
    key = "short_circuit" if n_shards == 1 else "full_reslice"
    other = "full_reslice" if n_shards == 1 else "short_circuit"
    assert tpart.SHARD_DELTA_STATS[key] == before[key] + 1
    assert tpart.SHARD_DELTA_STATS[other] == before[other]
    if n_shards == 1:       # the overlay's own lanes, reshaped
        assert got.src.data_ptr() == td.src.data_ptr()


def test_streaming_delta_shards_keep_static_shapes(served):
    _jg, _jp, tg, _tp = served
    sg = StreamingGraph(tg, delta_cap=12)
    shape0 = sg.delta_shards(3).src.shape
    sg.apply(inserts=[(1, 2), (3, 4), (5, 6)])
    sh = sg.delta_shards(3)
    assert sh.src.shape == shape0 == (3, 4)
    assert int((sh.src.reshape(-1) != tg.n_nodes).sum()) == 3


def test_spmm_edge_sharded_sums_the_reference_partials(served):
    jg, _jp, tg, _tp = served
    rng = np.random.default_rng(1)
    feats = rng.random((jg.n_nodes + 1, 5)).astype(np.float32)
    es = jpart.shard_edges_np(jg, 3)
    want = sum(np.asarray(jpart.spmm_edge_sharded(
        *(jnp.asarray(a[s]) for a in es), jnp.asarray(feats),
        jg.n_nodes, axis_names=())) for s in range(3))
    ts = tpart.shard_edges(tg, 3)
    f = torch.from_numpy(feats)
    got = tpart.spmm_edge_sharded([ts.src[s] for s in range(3)], [ts.dst[s] for s in range(3)],
                                  [ts.wgt[s] for s in range(3)], [f] * 3, tg.n_nodes)
    assert len(got) == 3 and all(torch.equal(got[0], x) for x in got)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------


def test_collectives_fold_in_shard_order_and_min_max_exact():
    rng = np.random.default_rng(2)
    parts = [torch.from_numpy((rng.standard_normal(257) * 10.0 ** rng.integers(-3, 6, 257))
                              .astype(np.float32)) for _ in range(4)]
    got = TM.reduce_to(parts, "sum")
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(got, want)
    assert not torch.equal(got, ((parts[3] + parts[2]) + parts[1]) + parts[0])
    mn = TM.reduce_to(parts, "min")
    assert torch.equal(mn, torch.stack(parts).amin(0))
    assert torch.equal(TM.reduce_to(parts[::-1], "max"), torch.stack(parts).amax(0))
    masks = [p > 0 for p in parts]
    assert torch.equal(TM.reduce_to(masks, "or"), torch.stack(masks).any(0))
    out = TM.all_reduce(parts[:1], "sum")
    assert out[0] is parts[0]           # one shard: nothing is copied
    out = TM.all_reduce(parts, "max")
    assert all(o is out[0] for o in out)


def test_mesh_shape_devices_and_errors():
    m = _mesh(2, 3)
    assert m.shape == {"data": 2, "model": 3}
    assert m.device(1, 2) == torch.device("cpu") and m.distinct() == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="needs 8 devices"):
        TS.make_serving_mesh(2, 4, devices=CPU4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TS.make_serving_mesh(1, 1)


def test_split_and_gather_state_round_trip(served):
    _jg, _jp, tg, tp = served
    cfg = dataclasses.replace(TS.default_config(tg), masked_pull=True)
    st = TB.init_batch(TA.ppr_delta(0), tg, cfg, [1, 2, 3, 4, 5, 6], pack=tp, telemetry=True,
                       tele_shards=3)
    rows = TSH.split_state(st, [torch.device("cpu")] * 3)
    assert [r.it.shape[0] for r in rows] == [2, 2, 2]
    assert rows[1].m["resid"].is_contiguous()
    back = TSH.gather_state(rows)
    for name in TB.BatchState._fields:
        a, b = getattr(st, name), getattr(back, name)
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        elif isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        elif a is not None:
            assert torch.equal(a, b), name
    rows[0].m["resid"][0, 0] = 7.0      # a shard owns its lanes
    assert st.m["resid"][0, 0] != 7.0
    assert TSH.split_state(st, [torch.device("cpu")])[0].m["resid"] is st.m["resid"]


def test_shard_sources_blocks():
    assert [list(b) for b in TS.shard_sources(np.arange(8), 4)] == [[0, 1], [2, 3], [4, 5],
                                                                    [6, 7]]
    with pytest.raises(AssertionError):
        TS.shard_sources(np.arange(8), 3)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

SOURCES = [0, 7, 101, 511, 3, 64, 200, 300]


@pytest.fixture(scope="module")
def batch_refs(served):
    """The port's and the reference's single-device run_batch of every
    program (max_iters 64, as tests/test_sharded.py)."""
    jg, jp, tg, tp = served
    out = {}
    for name in PROGRAMS:
        tm, tst = TS.run_batch(TA.__dict__[name](0), tg, tp,
                               TS.default_config(tg, max_iters=64), SOURCES)
        jm, jst = JS.run_batch(JA.__dict__[name](0), jg, jp,
                               JS.default_config(jg, max_iters=64), SOURCES)
        out[name] = (tm, tst, jm, jst)
    return out


@pytest.mark.parametrize("name", PROGRAMS)
def test_one_shard_mesh_bit_equal_to_run_batch(served, batch_refs, name):
    _jg, _jp, tg, tp = served
    cfg = TS.default_config(tg, max_iters=64)
    tm, tst, jm, _jst = batch_refs[name]
    f = FIELD[name]
    for consensus in ("global", "local"):
        m, st = TS.run_sharded(TA.__dict__[name](0), tg, tp, cfg, _mesh(1, 1), SOURCES,
                               consensus=consensus)
        for k in tm:
            assert torch.equal(m[k], tm[k]), (name, consensus, k)
        assert torch.equal(st["mode_trace"], tst["mode_trace"])
    _assert_lanes(name, m[f].numpy(), np.asarray(jm[f]))
    m_es, _ = TS.run_sharded(TA.__dict__[name](0), tg, tp, cfg, _mesh(1, 1), SOURCES,
                             placement="edge_sharded")
    _assert_lanes(name, m_es[f].numpy(), tm[f].numpy())


@pytest.mark.parametrize("name", PROGRAMS)
@pytest.mark.parametrize("d", [2, 4])
def test_replicated_lanes_and_trace_bit_equal(served, batch_refs, name, d):
    _jg, _jp, tg, tp = served
    cfg = TS.default_config(tg, max_iters=64)
    tm, tst, jm, jst = batch_refs[name]
    m, st = TS.run_sharded(TA.__dict__[name](0), tg, tp, cfg, _mesh(d, 1), SOURCES)
    for k in tm:
        assert torch.equal(m[k], tm[k]), (name, k)
    for k in ("mode_trace", "per_query_iters", "push_iters", "pull_iters", "switches"):
        assert torch.equal(st[k], tst[k]), (name, k)
    np.testing.assert_array_equal(st["mode_trace"].numpy(), np.asarray(jst["mode_trace"]))
    _assert_lanes(name, m[FIELD[name]].numpy(), np.asarray(jm[FIELD[name]]))


def _broom_path():
    """Two shards' workloads that want opposite modes: a chain of 5 hubs
    fanning 50 leaves each (heavy for its edge budget) and a 100-vertex path
    (volume-1 frontiers)."""
    broom = []
    for i in range(5):
        broom.append((i, i + 1))
        broom += [(i, 500 + 50 * i + j) for j in range(50)]
    path = [(200 + i, 201 + i) for i in range(100)]
    e = np.asarray(broom + path, dtype=np.int64)
    g = from_edges(e[:, 0], e[:, 1], 800, directed=True)
    return g, _tgraph(g)


def test_local_consensus_diverges_where_the_reference_does():
    """consensus='local' runs each query shard on its own union: its trace
    is the reference's run_batch of each shard's sources alone (no
    collectives), which diverges from the global trace; results agree."""
    jg, tg = _broom_path()
    jp, tp = jpack(jg.inc), tpacking.pack_ell(tg.inc)
    tcfg = EngineConfig(frontier_cap=800, edge_cap=40, max_iters=256)
    jcfg = JS.batch_engine.EngineConfig(frontier_cap=800, edge_cap=40, max_iters=256)
    srcs = [200, 200, 0, 0]            # shard 0: path, shard 1: broom
    mesh = _mesh(2, 1)
    m_g, st_g = TS.run_sharded(TA.sssp(0), tg, tp, tcfg, mesh, srcs)
    m_l, st_l = TS.run_sharded(TA.sssp(0), tg, tp, tcfg, mesh, srcs, consensus="local")
    tr_g, tr_l = st_g["mode_trace"].numpy(), st_l["mode_trace"].numpy()
    assert not np.array_equal(tr_g, tr_l)
    assert tr_g[0, 1] == 1 and tr_l[0, 1] == 0, (tr_g[0, :6], tr_l[0, :6])
    assert torch.equal(m_g["dist"], m_l["dist"])
    j_all = JS.run_batch(JA.sssp(0), jg, jp, jcfg, srcs)[1]["mode_trace"]
    j_loc = np.concatenate([np.asarray(JS.run_batch(JA.sssp(0), jg, jp, jcfg, b)[1]["mode_trace"])
                            for b in TS.shard_sources(srcs, 2)])
    np.testing.assert_array_equal(tr_g, np.asarray(j_all))
    # iteration 0 runs the mode `init` took from every lane (the global
    # one), as the reference's engine does; from then on each shard's own
    np.testing.assert_array_equal(tr_l[:, 0], tr_g[:, 0])
    np.testing.assert_array_equal(tr_l[:, 1:], j_loc[:, 1:])


@pytest.mark.parametrize("name", PROGRAMS)
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_edge_sharded_against_run_batch_and_the_dense_scan(served, batch_refs, name, shape):
    _jg, _jp, tg, tp = served
    cfg = TS.default_config(tg, max_iters=64)
    tm, _tst, jm, _jst = batch_refs[name]
    f = FIELD[name]
    mesh = _mesh(*shape)
    m, st = TS.run_sharded(TA.__dict__[name](0), tg, tp, cfg, mesh, SOURCES,
                           placement="edge_sharded")
    _assert_lanes(name, m[f].numpy(), tm[f].numpy())
    _assert_lanes(name, m[f].numpy(), np.asarray(jm[f]))
    m_d, st_d = TS.run_sharded(TA.__dict__[name](0), tg, tp,
                               dataclasses.replace(cfg, shard_compact=False), mesh, SOURCES,
                               placement="edge_sharded")
    for k in m:
        assert torch.equal(m[k], m_d[k]), (name, k)
    assert torch.equal(st["mode_trace"], st_d["mode_trace"])


def _star_path():
    hub = [(0, i) for i in range(1, 201)]
    path = [(200 + i, 201 + i) for i in range(200)]
    e = np.asarray(hub + path, dtype=np.int64)
    g = from_edges(e[:, 0], e[:, 1], 402, directed=True)
    return _tgraph(g)


@pytest.mark.parametrize("name", ["sssp", "ppr_delta"])
def test_compacted_overflow_falls_back_to_the_dense_scan(name):
    tg = _star_path()
    tp = tpacking.pack_ell(tg.inc)
    cfg = EngineConfig(frontier_cap=402, edge_cap=tg.n_edges, max_iters=256, alpha=0.9,
                       shard_compact_frac=1e-6)
    srcs = [0, 0, 200, 250]
    outs = []
    for c in (cfg, dataclasses.replace(cfg, shard_compact=False)):
        eng = TS.ShardedBatchEngine(TA.__dict__[name](0), tg, tp, c, _mesh(1, 2),
                                    placement="edge_sharded", telemetry=True)
        outs.append(eng.run(eng.init(srcs)))
    (m_c, st_c), (m_d, st_d) = outs
    for k in m_c:
        assert torch.equal(m_c[k], m_d[k]), k
    assert torch.equal(st_c["mode_trace"], st_d["mode_trace"])
    named = tele_dict(st_c["tele"].numpy())
    assert named["compact_dense_fallbacks"] > 0 and named["compact_hits"] > 0
    plane = shard_plane(st_c["tele"].numpy())
    assert plane.sum() == named["push_edges_scanned"] + named["pull_edges_scanned"]


def test_presorted_shard_scan_bit_equal_to_the_per_step_sort(served):
    """The engine sorts each edge shard (base edges, then overlay lanes) by
    destination once per update; a segment sum over it equals the stable
    sort `Combiner.segment` would make every step, bit for bit."""
    _jg, _jp, tg, _tp = served
    sg = StreamingGraph(tg, delta_cap=16)
    sg.apply(inserts=[(3, 9), (9, 3), (0, 5), (7, 7)], deletes=[])
    eng = TS.ShardedBatchEngine(TA.ppr(0), sg.graph, sg.pack, TS.default_config(tg), _mesh(1, 3),
                                placement="edge_sharded", delta=sg.delta)
    base = tpart.shard_edges(sg.graph, 3)
    dl = tpart.shard_delta(sg.delta, 3, tg.n_nodes)
    rng = np.random.default_rng(0)
    for s, v in enumerate(eng.shard_views(0)):
        src = torch.cat([base.src[s], dl.src[s]])
        dst = torch.cat([base.dst[s], dl.dst[s]])
        vals = torch.from_numpy(rng.random((src.shape[0], 3)).astype(np.float32))
        order = torch.sort(dst, stable=True)[1]
        assert torch.equal(v.src, src[order]) and torch.equal(v.dst, dst[order])
        want = SUM_AGG.segment(vals, dst, tg.n_nodes + 1)
        got = SUM_AGG.segment(vals[order], v.dst, tg.n_nodes + 1, sorted_ids=True)
        assert torch.equal(got, want)


def test_edge_sharded_push_only_program_skips_capacity_check(served):
    _jg, _jp, tg, tp = served
    push_bfs = dataclasses.replace(TA.bfs(0), modes="push")
    lean = EngineConfig(frontier_cap=tg.n_nodes, edge_cap=64, max_iters=64)
    full = EngineConfig(frontier_cap=tg.n_nodes, edge_cap=tg.n_edges, max_iters=64)
    with pytest.raises(ValueError):
        TS.run_batch(push_bfs, tg, tp, lean, [0, 7, 101])
    m_es, _ = TS.run_sharded(push_bfs, tg, tp, lean, _mesh(1, 2), [0, 7, 101],
                             placement="edge_sharded")
    m_ref, _ = TS.run_batch(push_bfs, tg, tp, full, [0, 7, 101])
    assert torch.equal(m_es["dist"], m_ref["dist"])


@pytest.mark.parametrize("shape,kind", [((4, 1), "replicated"), ((1, 4), "edge_sharded")])
def test_telemetry_plane_sums_to_the_global_counters(served, shape, kind):
    """Each shard's slot of the imbalance plane holds its own scan volume;
    the plane sums to the global push + pull counters (tests/test_obs.py's
    forced-mesh identity)."""
    _jg, _jp, tg, tp = served
    srv = TS.GraphServer(tg, tp, {"bfs": TA.bfs(0), "sssp": TA.sssp(0)}, slots=8,
                         cfg=TS.default_config(tg), mesh=_mesh(*shape),
                         placements={a: TS.Placement(kind, 4) for a in ("bfs", "sssp")},
                         telemetry=True)
    for src in (0, 7, 63, 150):
        srv.submit("bfs", src)
        srv.submit("sssp", src)
    srv.drain()
    for name, pool in srv.pools.items():
        tele = pool.state.tele.numpy()
        assert tele.shape == (TELE_LEN + 4,)
        named = tele_dict(tele)
        total = named["push_edges_scanned"] + named["pull_edges_scanned"]
        assert shard_plane(tele).sum() == total > 0
        imb = srv.stats()["pools"][name]["imbalance"]
        assert imb["shard_edges"] == [int(x) for x in shard_plane(tele)]
    gauges = srv.stats()["obs"]["metrics"]
    assert "bfs.shard_skew" in gauges


def test_flags_are_one_read_a_step(served):
    """A run reads one packed tensor a step for all shards, whatever the
    number of shards; a pool one a step."""
    _jg, _jp, tg, tp = served
    cfg = TS.default_config(tg, max_iters=64)
    for shape, kind in (((1, 4), "edge_sharded"), ((4, 1), "replicated")):
        eng = TS.ShardedBatchEngine(TA.sssp(0), tg, tp, cfg, _mesh(*shape), placement=kind)
        st = eng.init(SOURCES)
        before = dict(TB.HOST_READS)
        _m, stats = eng.run(st)
        reads = TB.HOST_READS["loop"] - before["loop"]
        assert reads == int(stats["iterations"]) + 1, (kind, reads)
        assert TB.HOST_READS["gmode"] == before["gmode"]


def test_against_the_reference_sharded_engine_on_a_forced_mesh(served, tmp_path):
    """The reference's own ShardedBatchEngine on a forced (2, 2) CPU mesh (a
    subprocess with 4 host devices): bfs, sssp and ppr, replicated and
    edge-sharded, against the port on a (2, 2) mesh of the CPU. Where the
    reference's sharded path raises under the installed JAX (its
    `NamedSharding` TypeError, ROADMAP §3), the case is held against the
    reference's single-device `run_batch` from the same subprocess instead,
    which DESIGN.md §9 says the sharded engine equals."""
    out = tmp_path / "ref.npz"
    script = textwrap.dedent(f"""
        import numpy as np
        from repro.core import algorithms as alg
        from repro.graph import generators, pack_ell
        from repro.serving import default_config, make_serving_mesh, run_batch, run_sharded
        g = generators.rmat(9, 8, seed=3, directed=True)
        pack = pack_ell(g.inc)
        cfg = default_config(g, max_iters=64)
        try:
            mesh = make_serving_mesh(2, 2)
        except Exception:
            mesh = None
        res = {{}}
        for name, field in (("bfs", "dist"), ("sssp", "dist"), ("ppr", "rank")):
            m, st = run_batch(getattr(alg, name)(0), g, pack, cfg, {SOURCES!r})
            res[name + "/batch"] = np.asarray(m[field])
            res[name + "/batch/trace"] = np.asarray(st["mode_trace"])
            for kind in ("replicated", "edge_sharded"):
                try:
                    m, st = run_sharded(getattr(alg, name)(0), g, pack, cfg, mesh,
                                        {SOURCES!r}, placement=kind)
                except Exception as e:
                    print("reference sharded path raised:", name, kind, type(e).__name__)
                    continue
                res[name + "/" + kind] = np.asarray(m[field])
                res[name + "/" + kind + "/trace"] = np.asarray(st["mode_trace"])
        np.savez({str(out)!r}, **res)
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(out)
    _jg, _jp, tg, tp = served
    cfg = TS.default_config(tg, max_iters=64)
    for name in ("bfs", "sssp", "ppr"):
        for kind in ("replicated", "edge_sharded"):
            m, st = TS.run_sharded(TA.__dict__[name](0), tg, tp, cfg, _mesh(2, 2), SOURCES,
                                   placement=kind)
            key = f"{name}/{kind}" if f"{name}/{kind}" in ref.files else f"{name}/batch"
            _assert_lanes(name, m[FIELD[name]].numpy(), ref[key])
            if kind == "replicated" or key.endswith("edge_sharded"):
                np.testing.assert_array_equal(st["mode_trace"].numpy(), ref[key + "/trace"],
                                              err_msg=(name, kind))
