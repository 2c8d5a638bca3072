"""The port's serving scheduler (`repro_torch.serving.GraphServer`) against
the reference's (`repro.serving.GraphServer`) on rmat(9, 8, seed=3).

The same submit sequence and pump schedule go through both servers. The
completions must agree: rid, order, algo, source, tenant, iterations,
`from_cache` and the SLO flags equal, results bit-equal for bfs, sssp, wcc
and kcore and within rtol 1e-5 for ppr and ppr_delta (sum combiners, as
tests/test_torch_batch_engine.py holds `run_batch`). `stats()` has the same
keys and counts. The cases
mirror tests/test_serving.py's scheduler cases; the port's own contracts
(one packed host read a pool step, gathered harvests, the CLI, the
`NotImplementedError` of the parts not ported yet) are added.
"""

import re

import numpy as np
import pytest
import torch

from repro import serving as JS
from repro.core import algorithms as JA
from repro.graph import generators as jgen
from repro.graph import pack_ell as jpack
from repro.launch import serve_graph as jserve
from repro_torch import interop
from repro_torch import serving as TS
from repro_torch.core import algorithms as TA
from repro_torch.graph import packing as tpacking
from repro_torch.launch import serve_graph as tserve
from repro_torch.serving import batch_engine as TB

EXACT = ("bfs", "sssp", "wcc", "kcore")
FIELDS = ("rid", "algo", "source", "tenant", "iterations", "from_cache",
          "graph_version", "deadline_missed", "dropped", "degraded", "preempted")


@pytest.fixture(scope="module")
def graphs():
    jg = jgen.rmat(9, 8, seed=3)                 # 512 nodes, power-law
    tg = interop.graph_from_numpy(interop.csr_arrays(jg.out), device="cpu")
    return jg, jpack(jg.inc), tg, tpacking.pack_ell(tg.inc)


def _progs(A, names):
    make = {"bfs": lambda: A.bfs(0), "sssp": lambda: A.sssp(0), "wcc": A.wcc,
            "kcore": lambda: A.kcore(k=4), "ppr": lambda: A.ppr(0),
            "ppr_delta": lambda: A.ppr_delta(0)}
    return {n: make[n]() for n in names}


def _both(graphs, names, **kw):
    """(reference server, port server) over the same graph and programs."""
    jg, jp, tg, tp = graphs
    j = JS.GraphServer(jg, jp, _progs(JA, names),
                       cfg=JS.default_config(jg, max_iters=64), **kw)
    t = TS.GraphServer(tg, tp, _progs(TA, names),
                       cfg=TS.default_config(tg, max_iters=64), **kw)
    return j, t


def same_completions(cj, ct):
    assert len(cj) == len(ct)
    for a, b in zip(cj, ct):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), (f, a.rid)
        if a.result is None:
            assert b.result is None
            continue
        ra = np.asarray(a.result)
        assert b.result.dtype == ra.dtype and b.result.shape == ra.shape
        if a.algo in EXACT:
            assert np.array_equal(b.result, ra), (a.algo, a.source)
        else:
            np.testing.assert_allclose(b.result, ra, rtol=1e-5, atol=1e-8)


def _plain(d):
    """A stats dict with numpy scalars and arrays as Python values."""
    if isinstance(d, dict):
        return {k: _plain(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_plain(v) for v in d]
    if isinstance(d, np.generic):
        return d.item()
    return d


def same_stats(sj, st):
    """Equal stats: every key, every count. The reference's `shard_delta` is
    its process-wide sharded counters (other test files move them); the
    port's are zero. Timed values (latency histograms, health quantiles) are
    compared by key only. The port has one key more, `queue` (its queue-wait
    counter, host floats)."""
    assert set(st) == set(sj) | {"queue"}
    q = st["queue"]
    engine = sum(p["engine_queries"] for p in st["pools"].values())
    assert q["wait_s"] >= 0 and 0 <= q["admitted"] <= engine
    assert set(sj["shard_delta"]) == set(st["shard_delta"])
    assert st["shard_delta"] == {"full_reslice": 0, "short_circuit": 0}
    for k in sj:
        if k in ("shard_delta", "health", "obs"):
            continue
        assert _plain(sj[k]) == _plain(st[k]), k
    assert set(sj["health"]) == set(st["health"])
    assert set(sj["obs"]) == set(st["obs"])
    if sj["obs"]["enabled"]:
        mj, mt = sj["obs"]["metrics"], st["obs"]["metrics"]
        assert set(mj) == set(mt)
        for name, v in mj.items():
            if not isinstance(v, dict):       # counters and gauges
                assert v == mt[name], name
            else:                             # histograms: counts agree
                assert v["count"] == mt[name]["count"], name


def _solo(graphs, algo, source):
    _, _, tg, tp = graphs
    prog = _progs(TA, [algo])[algo]
    cfg = TS.default_config(tg, max_iters=64)
    field = prog.param("result", prog.primary)
    return TS.run_sequential(lambda: _progs(TA, [algo])[algo], tg, tp, cfg,
                             [source])[0][field][:-1].numpy()


# ---------------------------------------------------------------------------
# mirrored cases of tests/test_serving.py
# ---------------------------------------------------------------------------


def test_scheduler_drains_oversubscribed_stream(graphs):
    j, t = _both(graphs, ["bfs", "sssp"], slots=3, queue_cap=64, cache_capacity=0)
    rng = np.random.default_rng(11)
    want = {}
    for i in range(17):                        # 17 requests >> 3 slots/pool
        algo = "bfs" if i % 2 == 0 else "sssp"
        src = int(rng.integers(0, 512))
        assert j.submit(algo, src) == t.submit(algo, src)
        want[i] = (algo, src)
    cj, ct = j.drain(), t.drain()
    same_completions(cj, ct)
    same_stats(j.stats(), t.stats())
    assert {c.rid for c in ct} == set(want)
    for c in ct:                               # and the port's solo engine
        assert (c.algo, c.source) == want[c.rid]
        assert np.array_equal(c.result, _solo(graphs, c.algo, c.source))
    assert all(r is None for p in t.pools.values() for r in p.lane_rid)


def test_weighted_fairness_hot_algo_cannot_starve(graphs):
    j, t = _both(graphs, ["bfs", "sssp"], slots=2, queue_cap=8, cache_capacity=0,
                 weights={"bfs": 1.0, "sssp": 3.0})
    assert t.queue_quota == j.queue_quota == {"bfs": 2, "sssp": 6}
    for srv in (j, t):
        bfs_rids = [srv.submit("bfs", s) for s in range(10)]
        assert sum(r is not None for r in bfs_rids) == 2
        assert srv.rejected == 8
        assert all(srv.submit("sssp", s) is not None for s in range(6))
    cj, ct = j.drain(), t.drain()
    assert len(ct) == 8 and {c.algo for c in ct} == {"bfs", "sssp"}
    same_completions(cj, ct)
    same_stats(j.stats(), t.stats())


def test_tenant_quota_hot_tenant_exhausts_only_its_share(graphs):
    j, t = _both(graphs, ["bfs"], slots=2, queue_cap=8, cache_capacity=0,
                 tenant_weights={"free": 1.0, "paid": 3.0})
    assert t.tenant_quota == j.tenant_quota == {("bfs", "free"): 2, ("bfs", "paid"): 6}
    for srv in (j, t):
        free = [srv.submit("bfs", s, tenant="free") for s in range(10)]
        assert sum(r is not None for r in free) == 2 and srv.rejected == 8
        assert all(srv.submit("bfs", s, tenant="paid") is not None for s in range(6))
    cj, ct = j.drain(), t.drain()
    assert sum(c.tenant == "paid" for c in ct) == 6
    same_completions(cj, ct)
    same_stats(j.stats(), t.stats())


def test_tenant_quota_composes_with_algo_weights(graphs):
    j, t = _both(graphs, ["bfs", "sssp"], slots=2, queue_cap=16, cache_capacity=0,
                 weights={"bfs": 1.0, "sssp": 3.0}, tenant_weights={"a": 1.0, "b": 1.0})
    assert t.queue_quota == j.queue_quota == {"bfs": 4, "sssp": 12}
    assert t.tenant_quota == j.tenant_quota == {
        ("bfs", "a"): 2, ("bfs", "b"): 2, ("sssp", "a"): 6, ("sssp", "b"): 6}


def test_tenant_unknown_raises(graphs):
    _, _, tg, tp = graphs
    srv = TS.GraphServer(tg, tp, {"bfs": TA.bfs(0)}, slots=2,
                         cfg=TS.default_config(tg, max_iters=64),
                         tenant_weights={"a": 1.0})
    with pytest.raises(KeyError):
        srv.submit("bfs", 0, tenant="nobody")
    with pytest.raises(KeyError):              # no 'default' tenant declared
        srv.submit("bfs", 0)
    with pytest.raises(KeyError):
        srv.submit("sssp", 0, tenant="a")


def test_tenant_round_robin_admission(graphs):
    j, t = _both(graphs, ["bfs"], slots=2, queue_cap=16, cache_capacity=0,
                 tenant_weights={"a": 1.0, "b": 1.0})
    for srv in (j, t):
        for s in range(4):
            assert srv.submit("bfs", s, tenant="a") is not None
        assert srv.submit("bfs", 7, tenant="b") is not None
        srv.pump()                             # admits one lane per tenant
        assert set(srv._inflight_tenants.values()) == {"a", "b"}
    cj, ct = j.drain(), t.drain()
    assert len(ct) == 5
    same_completions(cj, ct)


def test_tenant_rotation_prevents_starvation_under_backlog(graphs):
    j, t = _both(graphs, ["bfs"], slots=1, queue_cap=64, cache_capacity=0,
                 tenant_weights={"whale": 8.0, "minnow": 1.0})
    order = {}
    for name, srv in (("ref", j), ("port", t)):
        for s in range(8):
            assert srv.submit("bfs", s, tenant="whale") is not None
        minnow = srv.submit("bfs", 100, tenant="minnow")
        done = []
        for pump in range(200):
            done += [c.rid for c in srv.pump()]
            srv.submit("bfs", 200 + pump, tenant="whale")
            if minnow in done:
                break
        assert minnow in done and len(done) <= 2, done
        order[name] = done
    assert order["port"] == order["ref"]
    same_completions(j.completions, t.completions)


def test_scheduler_backpressure(graphs):
    j, t = _both(graphs, ["bfs"], slots=2, queue_cap=4, cache_capacity=0)
    for srv in (j, t):
        accepted = [srv.submit("bfs", s) for s in range(10)]
        assert accepted[:4] == [0, 1, 2, 3]
        assert all(r is None for r in accepted[4:]) and srv.rejected == 6
    with pytest.raises(TS.QueueFull):
        t.submit("bfs", 99, strict=True)
    with pytest.raises(JS.QueueFull):
        j.submit("bfs", 99, strict=True)
    cj, ct = j.drain(), t.drain()
    assert len(ct) == 4
    same_completions(cj, ct)
    same_stats(j.stats(), t.stats())


def test_cache_hit_skips_engine(graphs):
    j, t = _both(graphs, ["bfs"], slots=2, cache_capacity=8)
    for srv in (j, t):
        rid1 = srv.submit("bfs", 42)
        first = {c.rid: c for c in srv.drain()}[rid1]
        assert not first.from_cache
        queries, steps = srv.pools["bfs"].engine_queries, srv.pools["bfs"].steps
        rid2 = srv.submit("bfs", 42)
        comp = [c for c in srv.drain() if c.rid == rid2][0]
        assert comp.from_cache and comp.iterations == 0
        assert srv.pools["bfs"].engine_queries == queries
        assert srv.pools["bfs"].steps == steps
        assert np.array_equal(np.asarray(comp.result), np.asarray(first.result))
    same_completions(j.completions, t.completions)
    same_stats(j.stats(), t.stats())


# ---------------------------------------------------------------------------
# a mixed stream over six programs, pumped as it arrives
# ---------------------------------------------------------------------------

NAMES = ["bfs", "sssp", "ppr", "ppr_delta", "wcc", "kcore"]


def _mixed(srv, n=40):
    rng = np.random.default_rng(5)
    for i in range(n):
        src = int(rng.integers(0, 512)) if rng.random() > 0.3 else 7
        srv.submit(NAMES[i % len(NAMES)], src)
        if i % 5 == 4:
            srv.pump()
    return srv.drain()


@pytest.fixture(scope="module")
def mixed(graphs):
    j, t = _both(graphs, NAMES, slots=3, queue_cap=64, cache_capacity=8,
                 cohorts={"sssp": 3})
    return j, _mixed(j), t, _mixed(t)


def test_mixed_stream_completions_equal(mixed):
    j, cj, t, ct = mixed
    assert len(ct) == 40 and {c.algo for c in ct} == set(NAMES)
    assert any(c.from_cache for c in ct)
    same_completions(cj, ct)


def test_mixed_stream_stats_equal(mixed):
    j, _, t, _ = mixed
    same_stats(j.stats(), t.stats())
    assert t.stats()["pools"]["sssp"]["cohorts"] == 3


def _held_bytes(a: np.ndarray) -> int:
    """The bytes that `a` keeps alive: the buffer at the root of its base
    chain (a numpy array, or the torch tensor `.numpy()` wraps)."""
    while isinstance(a.base, np.ndarray):
        a = a.base
    if isinstance(a.base, torch.Tensor):
        return a.base.untyped_storage().nbytes()
    return a.nbytes


def test_harvest_gathers_result_and_resume_planes(mixed):
    """A harvested result is a contiguous (n,) host array that holds no
    memory beyond its own (no other lane's row of the round's gather), so
    dropping a completion frees its result; ppr_delta's cached entries carry its (rank, resid)
    split as the reference's do."""
    j, cj, t, ct = mixed
    for c in ct:
        assert c.result.flags["C_CONTIGUOUS"] and c.result.shape == (512,)
    planes = [c.result for c in ct if not c.from_cache]
    planes += [x for e in t.cache._entries.values() for x in getattr(e, "extras", {}).values()]
    assert len(planes) > 2
    assert all(_held_bytes(x) == x.nbytes for x in planes)
    assert t.pools["ppr_delta"].cache_extra_fields == j.pools["ppr_delta"].cache_extra_fields
    ents = [v for k, v in t.cache._entries.items() if k[1] == "ppr_delta"]
    assert ents and all(set(e.extras) == {"resid"} for e in ents)


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------


def test_one_host_read_a_pool_step(graphs):
    """A pool reads one packed (done, it, gmode) a step, plus one after a
    round of admissions; no step reads gmode on its own, no run loop."""
    _, _, tg, tp = graphs
    srv = TS.GraphServer(tg, tp, _progs(TA, ["bfs", "sssp", "ppr"]), slots=2,
                         cfg=TS.default_config(tg, max_iters=64), cache_capacity=0,
                         cohorts={"sssp": 2})
    for s in range(9):
        srv.submit(("bfs", "sssp", "ppr")[s % 3], 11 * s)
    leaves = [p for _n, p, _d in srv._leaves()]
    rounds = 0
    while srv._queued() or any(p.live() for p in leaves):
        r0 = dict(TB.HOST_READS)
        steps0 = [p.steps for p in leaves]
        q0 = [p.engine_queries for p in leaves]
        srv.pump()
        steps = sum(p.steps - s for p, s in zip(leaves, steps0))
        admitted = sum(p.engine_queries > q for p, q in zip(leaves, q0))
        d = {k: TB.HOST_READS[k] - r0[k] for k in r0}
        assert d == {"loop": 0, "gmode": 0, "masked": 0, "pool": steps + admitted}, d
        rounds += 1
    assert rounds > 3 and len(srv.completions) == 9


def test_stats_read_nothing(graphs, monkeypatch):
    _, _, tg, tp = graphs
    srv = TS.GraphServer(tg, tp, _progs(TA, ["bfs"]), slots=2,
                         cfg=TS.default_config(tg, max_iters=64), telemetry=True)
    srv.submit("bfs", 3)
    srv.drain()
    reads = dict(TB.HOST_READS)
    calls = []
    monkeypatch.setattr(TB, "pool_flags", lambda st: calls.append(st))
    srv.stats()
    assert TB.HOST_READS == reads and not calls


def test_readmit_restarts_a_live_lane(graphs):
    """`readmit` re-initializes a live lane (same rid, same lane): the run
    ends as a fresh admission's, iterations counted from the restart, as in
    the reference's pool."""
    jg, jp, tg, tp = graphs
    out = {}
    for name, S, A, g, p in (("ref", JS, JA, jg, jp), ("port", TS, TA, tg, tp)):
        pool = S.AlgoPool("sssp", A.sssp(0), g, p, S.default_config(g, max_iters=64), 2)
        pool.admit(0, 0, 42)
        pool.admit(1, 1, 99)
        pool.step()
        pool.step()
        pool.readmit(0, 300)
        assert pool.engine_queries == 3
        done = {}
        while pool.live():
            pool.step()
            done.update({r: (np.asarray(res), it) for _l, r, res, it, _x in pool.harvest()})
        out[name] = done
    assert out["port"][0][1] == out["ref"][0][1]
    assert np.array_equal(out["port"][0][0], out["ref"][0][0])
    assert np.array_equal(out["port"][0][0], _solo(graphs, "sssp", 300))
    assert np.array_equal(out["port"][1][0], _solo(graphs, "sssp", 99))


@pytest.mark.parametrize("kw,item", [
    ({"delta_cap": 16, "mesh": object()}, "item 8"),
    ({"mesh": object()}, "item 8"),
    ({"placements": {"bfs": "edge_sharded"}}, "item 8"),
])
def test_unported_parts_raise(graphs, kw, item):
    """The sharded pools of ROADMAP queue 1 `item` are ported: a mesh
    without placements serves single-device pools and placements without a
    mesh are refused, as in the reference; nothing raises
    NotImplementedError. Placed pools are tests/test_torch_sharded_serving.py's."""
    jg, jp, tg, tp = graphs
    outcomes = []
    for S, A, g, p in ((JS, JA, jg, jp), (TS, TA, tg, tp)):
        try:
            srv = S.GraphServer(g, p, {"bfs": A.bfs(0)}, slots=2, **kw)
        except AssertionError as e:
            outcomes.append(("refused", "placements require a serving mesh" in str(e)))
        else:
            outcomes.append(("built", srv.mesh is kw.get("mesh"),
                             srv.stats()["pools"]["bfs"]["placement"]))
    assert outcomes[0] == outcomes[1]


def test_apply_updates_raises(graphs):
    """A static server (no `delta_cap`) has no graph to update, as in the
    reference."""
    _, _, tg, tp = graphs
    srv = TS.GraphServer(tg, tp, {"bfs": TA.bfs(0)}, slots=2)
    with pytest.raises(AssertionError, match="delta_cap"):
        srv.apply_updates(inserts=[(0, 1)])


# ---------------------------------------------------------------------------
# the CLI against the reference's
# ---------------------------------------------------------------------------

CLI = ["--graph", "rmat", "--scale", "8", "--slots", "4", "--requests", "36",
       "--hot-frac", "0.6", "--queue-cap", "6", "--telemetry"]
_TIMED = re.compile(r"queries in [0-9.]+s \([0-9.]+ q/s\)|latency \w+: .*")


def _cli_lines(out: str) -> list:
    return [_TIMED.sub("<timed>", line) for line in out.splitlines()
            if "result[:4]" not in line]


def test_serve_graph_cli_matches_reference(capsys):
    assert jserve.main(CLI) == 0
    ref = capsys.readouterr().out
    assert tserve.main(CLI + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _cli_lines(got) == _cli_lines(ref)
    assert re.search(r"cache: [1-9]\d* hits", got)            # hits happen
    assert re.search(r"backpressure events: [1-9]", got)     # and backpressure
    assert "36 queries" in got


def test_serve_graph_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--scale", "6", "--requests", "2"])


def test_serve_graph_cli_refuses_mesh(capsys):
    """`--mesh` is ported (ROADMAP queue 1 item 8): the CLI refuses only what
    the reference's refuses, a malformed mesh and slots that do not divide
    over the query shards."""
    with pytest.raises(SystemExit):
        tserve.main(["--mesh", "2by1", "--device", "cpu"])
    assert "--mesh must look like DxS" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tserve.main(["--mesh", "3x1", "--slots", "4", "--device", "cpu"])
    assert "must divide over 3 query shards" in capsys.readouterr().err
