"""The port's streaming server (`GraphServer(delta_cap=...)`,
`apply_updates`) and driver (`launch/stream_graph.py`) against the
reference's.

The same submit / pump / update schedule goes through both servers: the
`apply_updates` stats must be equal (`shipped` is {} here: no sharded pools)
and the completions equal (bfs/sssp/wcc/kcore bit-equal, ppr_delta within
rtol 1e-5); `stream_graph` prints the reference's lines and
`verify: N/N OK`. The single-device serving cases of tests/test_streaming.py,
tests/test_catalog.py and tests/test_ppr_delta.py are mirrored on the port:
it never serves a stale result, resumes in-flight ppr_delta lanes,
re-enqueues dirty lanes and refreshes dirty cache entries of the whole
catalog.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from repro import serving as JS
from repro.core import algorithms as JA
from repro.graph import generators as jgen
from repro.launch import stream_graph as jstream
from repro.streaming import StreamingGraph as JSG
from repro_torch import interop
from repro_torch import serving as TS
from repro_torch.core import algorithms as TA
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen
from repro_torch.graph import pack_ell
from repro_torch.launch import catalog as tcatalog
from repro_torch.launch import stream_graph as tstream
from repro_torch.serving import batch_engine as TB
from repro_torch.serving import default_config, query_result, run_batch
from repro_torch.streaming import StreamingGraph
from repro_torch.streaming.incremental import resume_fields

EXACT = ("bfs", "sssp", "wcc", "kcore", "mis")
FIELDS = ("rid", "algo", "source", "tenant", "iterations", "from_cache",
          "graph_version", "deadline_missed", "dropped", "degraded", "preempted")


def tgraph(jg):
    inc = None if jg.inc is jg.out else interop.csr_arrays(jg.inc)
    return interop.graph_from_numpy(interop.csr_arrays(jg.out), inc, device="cpu")


def _progs(A, names):
    make = {"bfs": lambda: A.bfs(0), "sssp": lambda: A.sssp(0), "wcc": A.wcc,
            "kcore": lambda: A.kcore(k=4), "ppr": lambda: A.ppr(0),
            "ppr_delta": lambda: A.ppr_delta(0)}
    return {n: make[n]() for n in names}


def same_completions(cj, ct):
    assert len(cj) == len(ct)
    for a, b in zip(cj, ct):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), (f, a.rid)
        ra = np.asarray(a.result)
        assert b.result.dtype == ra.dtype and b.result.shape == ra.shape
        if a.algo in EXACT:
            assert np.array_equal(b.result, ra), (a.algo, a.source)
        else:
            np.testing.assert_allclose(b.result, ra, rtol=1e-5, atol=1e-8)


def _isolated_grid():
    """grid2d(8) plus 16 isolated vertices (64..79): sources there stay
    clean across any update of the grid."""
    g = tgen.grid2d(8, seed=5, device="cpu")
    return tcsr.from_edges(g.out.src_idx, g.out.col_idx, 80, g.out.weights,
                           directed=False, device="cpu")


def _fresh(srv, prog, cfg, sources, field):
    sg = srv.sg
    m, _ = run_batch(prog, sg.graph, sg.pack, cfg, sources, delta=sg.delta)
    return [query_result(m, field, i).numpy() for i in range(len(sources))]


# ---------------------------------------------------------------------------
# the same stream through both servers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("refresh", ["incremental", "drop"])
def test_apply_updates_stats_equal_the_reference(refresh):
    """rmat(9) undirected, bfs/sssp/ppr_delta/wcc/kcore at 3 slots, delta_cap
    24 (the third update batch overflows and rebuilds): four rounds of 6
    submits and 2 pumps, each followed by an update batch drawn as
    `stream_graph` draws it. Every update's stats, the completions and
    `stats()` agree with the reference's."""
    names = ["bfs", "sssp", "ppr_delta", "wcc", "kcore"]
    jg = jgen.rmat(9, 8, seed=3)
    tg = tgraph(jg)
    kw = dict(slots=3, cache_capacity=32, delta_cap=24)
    j = JS.GraphServer(jg, None, _progs(JA, names),
                       cfg=JS.default_config(jg, max_iters=256), **kw)
    t = TS.GraphServer(tg, None, _progs(TA, names),
                       cfg=TS.default_config(tg, max_iters=256), **kw)
    rng_j, rng_t = np.random.default_rng(4), np.random.default_rng(4)
    hot = [0, 7, 33]
    rebuilt = 0
    for rnd in range(4):
        for i in range(6):
            a, s = names[(rnd + i) % len(names)], hot[i % 3] + rnd * (i % 2)
            assert (j.submit(a, s) is None) == (t.submit(a, s) is None)
        for _ in range(2):
            j.pump()
            t.pump()
        uj = jstream.random_update_batch(rng_j, j.sg, 5, 3)
        ut = tstream.random_update_batch(rng_t, t.sg, 5, 3)
        assert uj == ut
        sj = j.apply_updates(*uj, refresh=refresh)
        st = t.apply_updates(*ut, refresh=refresh)
        assert sj["shipped"] == st["shipped"] == {}
        assert sj == st, rnd
        rebuilt += st["rebuild"]
    assert rebuilt >= 1
    same_completions(j.drain(), t.drain())
    a, b = j.stats(), t.stats()
    assert a["graph"] == b["graph"] and b["graph"]["streaming"] == t.sg.stats()
    assert a["updates"] == b["updates"] == 4
    assert a["last_update"] == b["last_update"]
    for k in ("completed", "queued", "rejected", "inflight", "cache", "graph_version"):
        assert a[k] == b[k], k


@pytest.mark.parametrize("refresh", ["incremental", "drop"])
def test_apply_updates_never_serves_stale(refresh):
    tg = _isolated_grid()
    cfg = default_config(tg, max_iters=256)
    srv = TS.GraphServer(tg, None, {"bfs": TA.bfs(0), "ppr": TA.ppr(0)}, slots=4,
                         cfg=cfg, cache_capacity=64, delta_cap=32,
                         result_fields={"ppr": "rank"})
    sources = [0, 9, 33, 70, 75]
    for s in sources:
        srv.submit("bfs", s)
        srv.submit("ppr", s)
    srv.drain()
    assert len(srv.cache) == 2 * len(sources)
    st = srv.apply_updates(inserts=[(1, 62)], deletes=[(0, 1)], refresh=refresh)
    assert st["version"] == 1
    assert st["cache_retained"] >= 4, st
    if refresh == "incremental":
        assert st["cache_refreshed"] > 0, st
    for algo, prog, field in [("bfs", TA.bfs(0), "dist"), ("ppr", TA.ppr(0), "rank")]:
        rids = [srv.submit(algo, s) for s in sources]
        comps = {c.rid: c for c in srv.drain()}
        want = _fresh(srv, prog, cfg, sources, field)
        for i, rid in enumerate(rids):
            assert np.array_equal(comps[rid].result, want[i]), (
                algo, sources[i], comps[rid].from_cache, refresh)


def test_apply_updates_resumes_inflight_ppr_delta():
    """Dirty ppr_delta lanes in flight RESUME from corrected residuals (no
    readmit: engine_queries and iteration counters survive), clean cached
    entries re-key, and every completion is within 1e-3 of a fresh run."""
    tg = _isolated_grid()
    cfg = default_config(tg, max_iters=256)
    srv = TS.GraphServer(tg, None, {"ppr_delta": TA.ppr_delta(0)}, slots=2, cfg=cfg,
                         cache_capacity=64, delta_cap=32,
                         result_fields={"ppr_delta": "rank"})
    for s in [70, 75]:
        srv.submit("ppr_delta", s)
    srv.drain()
    assert len(srv.cache) == 2
    srv.submit("ppr_delta", 0)
    srv.submit("ppr_delta", 33)
    srv.pump()
    pool = srv.pools["ppr_delta"]
    assert any(r is not None for r in pool.lane_rid)
    queries_before = pool.engine_queries
    it_before = pool.state.it.clone()
    reads0 = TB.HOST_READS["pool"]
    st = srv.apply_updates(inserts=[(1, 62)], deletes=[(0, 1)])
    assert st["resumed_inflight"] >= 1, st
    assert st["reenqueued_inflight"] == 0
    assert st["cache_retained"] == 2, st
    assert pool.engine_queries == queries_before
    assert bool((pool.state.it >= it_before).all())
    assert pool._mirror is None                  # the resume wrote the state
    assert TB.HOST_READS["pool"] == reads0       # the harvest reused the mirror
    comps = {c.source: c for c in srv.drain()}
    want = _fresh(srv, TA.ppr_delta(0), cfg, [0, 33], "rank")
    for i, s in enumerate([0, 33]):
        assert np.abs(comps[s].result - want[i]).max() < 1e-3, s
    rid = srv.submit("ppr_delta", 70)
    assert [c for c in srv.drain() if c.rid == rid][0].from_cache


def test_apply_updates_reenqueues_dirty_inflight():
    tg = tgen.grid2d(10, seed=3, device="cpu")
    cfg = default_config(tg, max_iters=256)
    srv = TS.GraphServer(tg, None, {"sssp": TA.sssp(0)}, slots=2, cfg=cfg,
                         cache_capacity=0, delta_cap=16)
    srv.submit("sssp", 0)
    srv.submit("sssp", 99)
    srv.pump()
    assert any(r is not None for r in srv.pools["sssp"].lane_rid)
    q0 = srv.pools["sssp"].engine_queries
    st = srv.apply_updates(deletes=[(0, 1)])
    assert st["reenqueued_inflight"] >= 1, st
    assert srv.pools["sssp"].engine_queries == q0 + st["reenqueued_inflight"]
    by_src = {c.source: c for c in srv.drain()}
    want = _fresh(srv, TA.sssp(0), cfg, [0, 99], "dist")
    for i, s in enumerate([0, 99]):
        assert np.array_equal(by_src[s].result, want[i])


def test_cached_ppr_delta_survives_update_incrementally():
    """Dirty cached ppr_delta entries carry (rank, resid) and REFRESH
    through the residual correction instead of dropping."""
    tg = _isolated_grid()
    cfg = default_config(tg, max_iters=256)
    srv = TS.GraphServer(tg, None, {"ppr_delta": TA.ppr_delta(0)}, slots=2, cfg=cfg,
                         cache_capacity=64, delta_cap=32,
                         result_fields={"ppr_delta": "rank"})
    sources = [0, 33, 70]
    for s in sources:
        srv.submit("ppr_delta", s)
    srv.drain()
    st = srv.apply_updates(inserts=[(1, 62)], deletes=[(0, 1)])
    assert (st["cache_refreshed"], st["cache_retained"], st["cache_dropped"]) == (2, 1, 0)
    rids = {s: srv.submit("ppr_delta", s) for s in sources}
    comps = {c.rid: c for c in srv.drain()}
    want = _fresh(srv, TA.ppr_delta(0), cfg, sources, "rank")
    for i, s in enumerate(sources):
        c = comps[rids[s]]
        assert c.from_cache, s
        assert np.abs(c.result - want[i]).max() < 1e-3, s
    # a refreshed entry owns its memory, as a harvested one does
    entry = srv.cache.get(TS.make_key(srv.graph_version, "ppr_delta", 0, ()))
    for a in (entry.result, *entry.extras.values()):
        held = a.base.untyped_storage().nbytes() if isinstance(a.base, torch.Tensor) \
            else a.nbytes
        assert held == a.nbytes


def test_server_refreshes_whole_catalog_across_update():
    """tests/test_catalog.py's round trip: every catalog program's cache
    entry refreshes in place through a delete-only update, and each
    refreshed hit agrees with a fresh run (bit-equal, sums within 1e-4)."""
    tg = tgraph(jgen.rmat(7, 8, seed=3))
    cfg = default_config(tg, max_iters=256)
    names = ["wcc", "kcore", "mis", "pagerank_delta"]
    cat = tcatalog.make_catalog()
    programs = {a: cat[a] for a in names}
    srv = TS.GraphServer(tg, None, programs, slots=2, cfg=cfg, cache_capacity=16,
                         delta_cap=16)
    for a, p in programs.items():
        pool = srv.pools[a]
        assert pool.result_field == p.param("result", p.primary), a
        assert pool.cache_extra_fields == tuple(
            f for f in resume_fields(p) if f != pool.result_field), a
    for a in names:
        assert srv.submit(a, 3) is not None
    srv.drain()
    dels = [(int(tg.out.src_idx[i]), int(tg.out.col_idx[i])) for i in (0, 7)]
    st = srv.apply_updates(deletes=dels)
    assert st["cache_refreshed"] == len(names), st
    assert st["cache_dropped"] == 0, st
    for a in names:
        rid = srv.submit(a, 3)
        comp = [c for c in srv.drain() if c.rid == rid][0]
        assert comp.from_cache, a
        p = programs[a]
        want = _fresh(srv, p, cfg, [3], p.param("result", p.primary))[0]
        if p.combiner.name == "sum":
            assert np.allclose(comp.result, want, rtol=1e-5, atol=1e-4), a
        else:
            assert np.array_equal(comp.result, want), a


def test_masked_pull_pools_survive_a_rebuild():
    """A masked-pull pool's partial caches follow the rebuilt pack's row
    counts (`_reset_masked_pull_cache`), and its results stay exact."""
    tg = tgen.rmat(8, 6, seed=2, device="cpu")
    cfg = dataclasses.replace(default_config(tg, max_iters=256), masked_pull=True)
    srv = TS.GraphServer(tg, None, {"bfs": TA.bfs(0)}, slots=2, cfg=cfg,
                         cache_capacity=0, delta_cap=2)
    srv.submit("bfs", 0)
    srv.submit("bfs", 5)
    srv.pump()
    st = srv.apply_updates(inserts=[(1, 2), (3, 4)])
    assert st["rebuild"]
    pool = srv.pools["bfs"]
    assert [p.shape[0] for p in pool.state.pseg] == [s.rows for s in srv.sg.pack.slices]
    assert bool(pool.state.pull_dense)
    by_src = {c.source: c for c in srv.drain()}
    want = _fresh(srv, TA.bfs(0), default_config(tg, max_iters=256), [0, 5], "dist")
    assert np.array_equal(by_src[0].result, want[0])
    assert np.array_equal(by_src[5].result, want[1])


def test_streaming_stats_with_telemetry_read_nothing_from_the_card():
    """tests/test_obs.py's streaming schema case: a telemetry-on streaming
    server after an update reports the unified schema with the graph's
    stream stats, and reading `stats()` issues no device transfer."""
    from repro_torch import obs

    tg = tgen.rmat(7, 4, seed=3, directed=True, device="cpu")
    srv = TS.GraphServer(tg, None, {"bfs": TA.bfs(0)}, slots=2, telemetry=True,
                         cfg=default_config(tg, max_iters=64), delta_cap=16)
    srv.submit("bfs", 3)
    srv.drain()
    srv.submit("bfs", 3)                       # hit
    srv.drain()
    srv.apply_updates(inserts=[(0, 77)])
    st = srv.stats()
    assert st["updates"] == 1 and st["last_update"]["version"] == 1
    assert st["graph"]["streaming"] == srv.sg.stats() and st["cache"]["hits"] >= 1
    assert "tele" in st["pools"]["bfs"] and st["obs"]["enabled"] is True
    before = obs.TRANSFER_COUNT
    srv.stats()
    assert obs.TRANSFER_COUNT == before


def test_cache_invalidation_counter_on_update():
    """Entries dropped by an update count as cache invalidations."""
    tg = tgen.rmat(7, 4, seed=3, directed=True, device="cpu")
    srv = TS.GraphServer(tg, None, {"bfs": TA.bfs(0)}, slots=2, telemetry=True,
                         cfg=default_config(tg, max_iters=64), delta_cap=16)
    srv.submit("bfs", 0)
    srv.submit("bfs", 1)
    srv.drain()
    inv0 = srv.cache.stats()["invalidations"]
    srv.apply_updates(inserts=[(0, 1)], refresh="drop")
    st = srv.stats()["last_update"]
    assert st["cache_dropped"] > 0
    assert srv.cache.stats()["invalidations"] == inv0 + st["cache_dropped"]


def test_static_server_reports_no_stream():
    tg = tgen.rmat(7, 8, seed=3, device="cpu")
    srv = TS.GraphServer(tg, pack_ell(tg.inc), {"bfs": TA.bfs(0)}, slots=2)
    assert srv.sg is None and srv.stats()["graph"]["streaming"] is None


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

_TIMED = re.compile(r" in [0-9.]+s \([0-9.]+ q/s\)")


@pytest.mark.parametrize("extra", [
    [],
    ["--delta-cap", "12", "--inserts", "6", "--deletes", "3", "--hot-frac", "0.7",
     "--algos", "bfs,sssp,ppr_delta"],
])
def test_stream_graph_cli_matches_reference(capsys, extra):
    """Scale 8, an update every 4 (or 5) requests, --verify: the same update
    lines (edges, cache retained/refreshed/dropped, re-enqueued, resumed,
    rebuilds) and `verify: N/N OK`."""
    cli = ["--requests", "24", "--slots", "3", "--scale", "8", "--update-every",
           "4", "--verify"] + extra
    assert jstream.main(cli) == 0
    ref = capsys.readouterr().out
    assert tstream.main(cli + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _TIMED.sub("", got).splitlines() == _TIMED.sub("", ref).splitlines()
    assert "verify: 24/24 OK" in got
    if extra:
        assert "rebuild=True" in got


def test_stream_graph_cli_defaults_to_the_card_and_refuses_mesh(capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tstream.main(["--scale", "6", "--requests", "2"])
    with pytest.raises(SystemExit):
        tstream.main(["--mesh", "1x2", "--device", "cpu"])
    assert "item 8" in capsys.readouterr().err


def test_random_update_batch_draws_the_reference_batches():
    """The port's draw finds live base edges from the deleted positions
    alone; it consumes the generator as the reference's does."""
    jg = jgen.rmat(8, 6, seed=2)
    js, ts = JSG(jg, delta_cap=64), StreamingGraph(tgraph(jg), delta_cap=64)
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(6):
        uj = jstream.random_update_batch(rj, js, 4, 7)
        ut = tstream.random_update_batch(rt, ts, 4, 7)
        assert uj == ut
        js.apply(*uj)
        ts.apply(*ut)
    assert rj.integers(0, 1 << 30) == rt.integers(0, 1 << 30)
