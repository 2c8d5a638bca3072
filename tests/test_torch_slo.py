"""The port's SLO paths (`repro_torch.serving.SLOPolicy` in `GraphServer`)
against the reference's on rmat(9, 8, seed=3).

The cases mirror tests/test_slo.py's deadline, degradation, preemption,
cohort and stats cases (its workload and replay cases belong to the load
harness, not ported yet). Deadlines run on a clock the test advances: each
server module's `time` is replaced by one whose `monotonic()` reads it, so
nothing sleeps. Completions equal the reference's (flags, iterations;
ppr_delta within rtol 1e-5, bfs bit for bit); preempt -> resume is bit-equal
to an uninterrupted run inside the port, also from a state that the
reference's pool preempted.
"""

import types

import numpy as np
import pytest
import torch

import repro.serving.scheduler as jsched
import repro_torch.serving.scheduler as tsched
from repro import serving as JS
from repro.core import algorithms as JA
from repro.graph import generators as jgen
from repro.graph import pack_ell as jpack
from repro_torch import interop
from repro_torch import serving as TS
from repro_torch.core import algorithms as TA
from repro_torch.graph import packing as tpacking
from repro_torch.serving.cache import make_key

FLAGS = ("rid", "algo", "source", "tenant", "iterations", "from_cache",
         "deadline_missed", "dropped", "degraded", "preempted")
SOURCES = (5, 17, 40, 99, 123, 200, 310, 400)


@pytest.fixture(scope="module")
def graphs():
    jg = jgen.rmat(9, 8, seed=3)
    tg = interop.graph_from_numpy(interop.csr_arrays(jg.out), device="cpu")
    return jg, jpack(jg.inc), tg, tpacking.pack_ell(tg.inc)


class Clock:
    """A monotonic clock that moves only when told to."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    fake = types.SimpleNamespace(monotonic=c.monotonic)
    monkeypatch.setattr(jsched, "time", fake)
    monkeypatch.setattr(tsched, "time", fake)
    return c


def _server(S, A, g, pack, *, algos=("ppr_delta",), slots=2, policy=None,
            cohorts=None, affinity=None, tenant_weights=None, **kw):
    make = {"bfs": lambda: A.bfs(0), "sssp": lambda: A.sssp(0),
            "ppr_delta": lambda: A.ppr_delta(0)}
    return S.GraphServer(
        g, pack, {a: make[a]() for a in algos}, slots=slots,
        cfg=S.default_config(g), queue_cap=64,
        result_fields={"ppr_delta": "rank"}, tenant_weights=tenant_weights,
        cohorts=cohorts, slo=policy, cohort_affinity=affinity, **kw)


def _both(graphs, policy_args=None, **kw):
    jg, jp, tg, tp = graphs
    jpol = JS.SLOPolicy(**policy_args) if policy_args is not None else None
    tpol = TS.SLOPolicy(**policy_args) if policy_args is not None else None
    return (_server(JS, JA, jg, jp, policy=jpol, **kw),
            _server(TS, TA, tg, tp, policy=tpol, **kw))


def same_completions(cj, ct):
    assert len(cj) == len(ct)
    for a, b in zip(cj, ct):
        for f in FLAGS:
            assert getattr(a, f) == getattr(b, f), (f, a.rid)
        if a.result is None:
            assert b.result is None
        elif a.algo == "ppr_delta":
            np.testing.assert_allclose(b.result, np.asarray(a.result), rtol=1e-5, atol=1e-8)
        else:
            assert np.array_equal(b.result, np.asarray(a.result))


# ---------------------------------------------------------------------------
# deadline edge cases
# ---------------------------------------------------------------------------


def test_deadline_expired_at_submit_drops_under_policy(graphs):
    j, t = _both(graphs, {})
    for srv in (j, t):
        rid = srv.submit("ppr_delta", 7, deadline_ms=0.0)
        assert rid is not None
        comp = [c for c in srv.completions if c.rid == rid][0]
        assert comp.dropped and comp.deadline_missed and comp.result is None
    assert t.slo_counts == j.slo_counts
    assert t.slo_counts["dropped"] == 1 and t.slo_counts["deadline_missed"] == 1
    same_completions(j.completions, t.completions)


def test_deadline_expired_at_submit_still_served_without_policy(graphs):
    j, t = _both(graphs)
    for srv in (j, t):
        rid = srv.submit("ppr_delta", 7, deadline_ms=0.0)
        comp = {c.rid: c for c in srv.drain()}[rid]
        assert not comp.dropped and comp.result is not None and comp.deadline_missed
    same_completions(j.completions, t.completions)


def test_deadline_expiring_mid_residency_completes_as_missed(graphs, clock):
    j, t = _both(graphs, {}, slots=1)
    for srv in (j, t):
        clock.t = 1000.0
        rid = srv.submit("ppr_delta", 11, deadline_ms=150.0)
        srv.pump()
        assert rid in srv._inflight_sources
        clock.t += 0.2                          # the deadline passes mid-run
        comp = {c.rid: c for c in srv.drain()}[rid]
        assert not comp.dropped and comp.result is not None and comp.deadline_missed
        assert srv.slo_counts["dropped"] == 0
    same_completions(j.completions, t.completions)


def test_hopeless_queued_query_drops_before_expiry(graphs, clock):
    j, t = _both(graphs, {"hopeless_margin": 1.0}, slots=1)
    for srv in (j, t):
        clock.t = 1000.0
        blocker = srv.submit("ppr_delta", 3)
        srv.pump()
        srv.pools["ppr_delta"].ewma_resident_s = 10.0
        rid = srv.submit("ppr_delta", 9, deadline_ms=5000.0)
        srv.pump()                              # the admission scan sheds it
        comp = [c for c in srv.completions if c.rid == rid][0]
        assert comp.dropped and comp.deadline_missed
        assert {c.rid: c for c in srv.drain()}[blocker].result is not None
    same_completions(j.completions, t.completions)


def test_ewma_warmup_and_reset(graphs, clock):
    """The EWMA service-time estimate folds each harvested residency (0.8 /
    0.2) as the reference's does on the same clock; reset to None (what the
    load harness's warm-up does), a deadline query is no longer hopeless."""
    j, t = _both(graphs, {"hopeless_margin": 1.0}, slots=2)
    for srv in (j, t):
        clock.t = 1000.0
        for s in SOURCES[:4]:
            srv.submit("ppr_delta", s)
        while srv._queued() or srv.pools["ppr_delta"].live():
            srv.pump()
            clock.t += 0.25
    ej, et = j.pools["ppr_delta"].ewma_resident_s, t.pools["ppr_delta"].ewma_resident_s
    assert et is not None and et == ej
    same_completions(j.completions, t.completions)
    pool = t.pools["ppr_delta"]
    rid = t.submit("ppr_delta", 1, deadline_ms=1e3 * et * 0.5)
    t.pump()
    assert [c for c in t.completions if c.rid == rid][0].dropped
    pool.ewma_resident_s = None
    rid = t.submit("ppr_delta", 2, deadline_ms=1e3 * et * 0.5)
    t.pump()
    assert rid in t._inflight_sources


# ---------------------------------------------------------------------------
# degradation
# ---------------------------------------------------------------------------


def test_degraded_pool_serves_overflow_and_never_caches(graphs):
    j, t = _both(graphs, {"degrade_algos": ("ppr_delta",), "degrade_slots": 2,
                          "degrade_queue_depth": 1}, slots=1)
    for srv in (j, t):
        rids = [srv.submit("ppr_delta", s) for s in (20, 21, 22)]
        comps = {c.rid: c for c in srv.drain()}
        degraded = [comps[r] for r in rids if comps[r].degraded]
        assert len(degraded) == 2 and srv.slo_counts["degraded"] == 2
        main = srv.pools["ppr_delta"]
        for c in degraded:
            assert c.result is not None
            assert srv.cache.get(make_key(srv.graph_version, "ppr_delta", c.source,
                                          main.cache_params)) is None
        full = [comps[r] for r in rids if not comps[r].degraded][0]
        assert srv.cache.get(make_key(srv.graph_version, "ppr_delta", full.source,
                                      main.cache_params)) is not None
    same_completions(j.completions, t.completions)
    assert t.degraded_pools["ppr_delta"].program.param("tol") == pytest.approx(8e-5)


def test_degraded_variant_matches_reference():
    jp = JS.degraded_variant(JA.ppr_delta(3), 4.0)
    tp = TS.degraded_variant(TA.ppr_delta(3), 4.0)
    assert tp.params == jp.params
    with pytest.raises(AssertionError):
        TS.degraded_variant(TA.bfs(0), 4.0)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------


def _preempt_run(srv, src=42):
    rid = srv.submit("ppr_delta", src, tenant="bg")
    for _ in range(3):
        srv.pump()                              # the victim makes progress
    other = srv.submit("ppr_delta", 7, tenant="fg", deadline_ms=10_000.0)
    srv.pump()                                  # deadline pressure -> evict
    assert srv.slo_counts["preempted"] == 1
    assert srv._inflight_sources.get(other) == 7
    comps = {c.rid: c for c in srv.drain()}
    return comps[rid], comps[other]


def test_preempt_then_resume_bit_identical(graphs, clock):
    _, _, tg, tp = graphs
    ref = _server(TS, TA, tg, tp, slots=1)
    rid = ref.submit("ppr_delta", 42)
    want = {c.rid: c for c in ref.drain()}[rid]
    assert want.iterations > 3
    pol = {"preempt": True, "preempt_slack_s": 100.0, "preempt_min_resident_s": 0.0}
    j, t = _both(graphs, pol, slots=1, tenant_weights={"bg": 1.0, "fg": 1.0})
    vj, oj = _preempt_run(j)
    vt, ot = _preempt_run(t)
    assert vt.preempted and not vt.dropped
    assert vt.iterations == want.iterations
    assert np.array_equal(vt.result, want.result), "resume diverges from an uninterrupted run"
    same_completions([vj, oj], [vt, ot])
    assert t.slo_counts == j.slo_counts


def test_reference_preempted_state_resumes_in_port_pool(graphs):
    """A dict that a reference pool's `preempt` returned (host numpy) goes
    into a port pool's `admit_resume` unchanged: the lane's columns equal it
    bit for bit, and the resumed run ends where the reference's own resume
    of the same dict ends (iterations equal, ranks within rtol 1e-5)."""
    jg, jp, tg, tp = graphs
    jpool = JS.AlgoPool("ppr_delta", JA.ppr_delta(0), jg, jp, JS.default_config(jg), 2)
    jpool.admit(0, 0, 42)
    jpool.admit(1, 1, 99)
    for _ in range(3):
        jpool.step()
    saved = jpool.preempt(0)
    assert set(saved) == {"planes", "it", "trace"} and saved["it"] == 3
    jpool.admit_resume(0, 5, saved)              # the reference resumes it too
    tpool = TS.AlgoPool("ppr_delta", TA.ppr_delta(0), tg, tp, TS.default_config(tg), 2)
    tpool.admit(0, 7, 310)                      # a batch-mate in lane 0
    tpool.admit_resume(1, 5, saved)
    for k, plane in saved["planes"].items():
        assert np.array_equal(tpool.state.m[k][:, 1].numpy(), np.asarray(plane)), k
    assert int(tpool.state.it[1]) == 3
    assert np.array_equal(tpool.state.mode_trace[1].numpy(), np.asarray(saved["trace"]))
    ref_out = {}
    while jpool.live():
        jpool.step()
        ref_out.update({r: (res, it) for _l, r, res, it, _x in jpool.harvest()})
    out = {}
    while tpool.live():
        tpool.step()
        out.update({r: (res, it) for _l, r, res, it, _x in tpool.harvest()})
    assert out[5][1] == ref_out[5][1]
    np.testing.assert_allclose(out[5][0], np.asarray(ref_out[5][0]), rtol=1e-5, atol=1e-8)


def test_port_preempt_returns_plain_numpy(graphs):
    """The port's saved state is host numpy that shares nothing with the
    pool: writing the lane afterwards leaves it as it was."""
    _, _, tg, tp = graphs
    pool = TS.AlgoPool("ppr_delta", TA.ppr_delta(0), tg, tp, TS.default_config(tg), 1)
    pool.admit(0, 0, 42)
    pool.step()
    pool.step()
    saved = pool.preempt(0)
    assert all(isinstance(v, np.ndarray) for v in saved["planes"].values())
    assert isinstance(saved["trace"], np.ndarray) and saved["it"] == 2
    copy = {k: v.copy() for k, v in saved["planes"].items()}
    pool.admit(0, 1, 99)
    assert all(np.array_equal(saved["planes"][k], copy[k]) for k in copy)


# ---------------------------------------------------------------------------
# cohorts: bit-identity, cadence, affinity
# ---------------------------------------------------------------------------


def _drain_results(srv, tenants=None):
    rids = {}
    for i, s in enumerate(SOURCES):
        t = tenants[i % len(tenants)] if tenants else "default"
        rids[srv.submit("ppr_delta", s, tenant=t)] = s
    comps = {c.rid: c for c in srv.drain()}
    return {rids[r]: np.asarray(comps[r].result) for r in rids}


def test_cohorts_default_policy_bit_identical_to_unpoliced(graphs):
    _, _, tg, tp = graphs
    plain = _drain_results(_server(TS, TA, tg, tp, slots=4, cohorts={"ppr_delta": 2}))
    j, t = _both(graphs, {}, slots=4, cohorts={"ppr_delta": 2})
    policed = _drain_results(t)
    _drain_results(j)
    for s in SOURCES:
        assert np.array_equal(plain[s], policed[s]), s
    same_completions(j.completions, t.completions)
    pooled = _drain_results(_server(TS, TA, tg, tp, slots=4))
    for s in SOURCES:
        np.testing.assert_allclose(pooled[s], policed[s], atol=1e-5)


def test_cohort_cadence_reshapes_steps_not_results(graphs):
    _, _, tg, tp = graphs
    plain = _drain_results(_server(TS, TA, tg, tp, slots=4, cohorts={"ppr_delta": 2}))
    j, t = _both(graphs, {"drop_expired": False, "cohort_burst": 2,
                          "best_effort_stride": 3}, slots=4, cohorts={"ppr_delta": 2})
    shaped = _drain_results(t)
    _drain_results(j)
    for s in SOURCES:
        np.testing.assert_allclose(plain[s], shaped[s], atol=1e-6)
    steps = [p.steps for p in t.pool_groups["ppr_delta"]]
    assert all(0 < st < t._round for st in steps), (steps, t._round)
    assert steps == [p.steps for p in j.pool_groups["ppr_delta"]] and t._round == j._round
    same_completions(j.completions, t.completions)

    j2, t2 = _both(graphs, {"drop_expired": False, "cohort_burst": 3}, slots=4,
                   cohorts={"ppr_delta": 2})
    for srv in (j2, t2):
        rid = srv.submit("ppr_delta", 5, deadline_ms=60_000.0)
        srv.pump()
        leaf = next(p for p in srv.pool_groups["ppr_delta"] if rid in p.lane_rid)
        assert leaf.steps == 3


def test_cohort_affinity_confines_tenant(graphs):
    j, t = _both(graphs, None, slots=4, cohorts={"ppr_delta": 2},
                 tenant_weights={"pinned": 1.0, "free": 1.0}, affinity={"pinned": [1]})
    for srv in (j, t):
        for s in SOURCES:
            srv.submit("ppr_delta", s, tenant="pinned")
        srv.drain()
        leaves = srv.pool_groups["ppr_delta"]
        assert leaves[0].engine_queries == 0
        assert leaves[1].engine_queries == len(SOURCES)
        for s in SOURCES[:4]:                   # 405, 417, 440, 499 (< n)
            srv.submit("ppr_delta", 400 + s, tenant="free")
        srv.drain()
        assert leaves[0].engine_queries > 0
    assert ([p.engine_queries for p in t.pool_groups["ppr_delta"]]
            == [p.engine_queries for p in j.pool_groups["ppr_delta"]])
    same_completions(j.completions, t.completions)


def test_cohort_affinity_unknown_tenant_rejected(graphs):
    _, _, tg, tp = graphs
    with pytest.raises(AssertionError):
        _server(TS, TA, tg, tp, cohorts={"ppr_delta": 2},
                tenant_weights={"a": 1.0}, affinity={"nobody": [0]})


# ---------------------------------------------------------------------------
# stats surface
# ---------------------------------------------------------------------------


def test_stats_slo_schema(graphs):
    pol = {"degrade_algos": ("ppr_delta",), "cohort_burst": 2, "best_effort_stride": 2}
    j, t = _both(graphs, pol, slots=4, cohorts={"ppr_delta": 2},
                 tenant_weights={"t": 1.0}, affinity={"t": [0]})
    sj, st = j.stats(), t.stats()
    slo = st["slo"]
    assert slo["enabled"] is True
    for k in ("deadline_missed", "dropped", "degraded", "preempted"):
        assert isinstance(slo[k], int)
    assert slo == sj["slo"]
    assert slo["policy"]["cohort_burst"] == 2 and slo["cohort_affinity"] == {"t": [0]}
    assert st["pools"]["ppr_delta"]["cohorts"] == 2
    assert st["pools"]["ppr_delta@degraded"] == sj["pools"]["ppr_delta@degraded"]
    assert set(st) == set(sj) | {"queue"}       # the port's queue-wait counter
    assert torch.equal(t.pools["ppr_delta"].state.done,
                       torch.ones(2, dtype=torch.bool))
