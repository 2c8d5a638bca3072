"""The port's observability layer (`repro_torch.obs`) against the
reference's (`repro.obs`).

Host pieces run on the same inputs in both packages and must agree:
histogram summaries, P² estimates, the health window, the flight ring and
its JSON dump, span schema (scripts/trace_schema.py). Through the serving
stack on directed rmat(7, 4, seed=3): a telemetry-off server issues no
`device_fetch` (`TRANSFER_COUNT`) and is bit-neutral against a
telemetry-on one; the telemetry counters, iteration logs and push/pull
decision audit log equal the reference's. The cases mirror tests/test_obs.py
(its streaming cases are in tests/test_torch_stream_serving.py; its
forced-mesh cases wait for ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as obs
from repro import serving as JS
from repro.core import algorithms as JA
from repro.graph import generators as jgen
from repro.graph import pack_ell as jpack
from repro_torch import interop
from repro_torch import serving as TS
from repro_torch.core import algorithms as TA
from repro_torch.graph import packing as tpacking
from repro_torch.obs import (
    EVENT_KINDS,
    NOOP,
    TELE_FIELDS,
    FlightRecorder,
    Histogram,
    MetricsRegistry,
    Observability,
    P2Quantile,
    default_latency_buckets,
    iters_from_trace,
)
from repro_torch.obs import recorder as flight_recorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import trace_schema  # noqa: E402

# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_histogram_percentiles_match_numpy_and_reference():
    rng = np.random.default_rng(7)
    vals = rng.lognormal(mean=-4.0, sigma=1.5, size=2000)   # latency-shaped
    h = Histogram("lat", default_latency_buckets())
    ref = jobs.Histogram("lat", jobs.default_latency_buckets())
    for v in vals:
        h.observe(float(v))
        ref.observe(float(v))
    for q in (0.50, 0.95, 0.99):
        want = float(np.quantile(vals, q))
        got = h.percentile(q)
        assert want / 1.6 - 1e-12 <= got <= want * 1.6 + 1e-12, (q, want, got)
    s = h.summary()
    assert s == ref.summary()
    assert s["count"] == len(vals)
    assert s["min"] == pytest.approx(vals.min()) and s["max"] == pytest.approx(vals.max())
    assert s["p50"] <= s["p95"] <= s["p99"] <= s["max"]
    assert default_latency_buckets() == jobs.default_latency_buckets()
    assert obs.default_count_buckets() == jobs.default_count_buckets()


def test_histogram_single_value_and_empty():
    h = Histogram("x", [1.0, 10.0])
    assert math.isnan(h.percentile(0.5))
    for _ in range(5):
        h.observe(3.0)
    assert h.percentile(0.0) == h.percentile(0.5) == h.percentile(0.99) == 3.0
    h.observe(100.0)
    assert h.percentile(1.0) == 100.0


def test_registry_disabled_is_noop():
    reg = MetricsRegistry(enabled=False)
    c, g, h = reg.counter("a"), reg.gauge("b"), reg.histogram("c")
    assert c is NOOP and g is NOOP and h is NOOP
    c.inc()
    g.set(4)
    h.observe(1.0)
    assert reg.snapshot() == {}
    on = MetricsRegistry(enabled=True)
    assert on.counter("a") is on.counter("a")
    on.counter("a").inc(3)
    assert on.snapshot()["a"] == 3


def test_iters_from_trace_bounded_log_gaps():
    args = (np.asarray([0, 1, 0, -1], np.int8), [5, None, 7], [None, 11])
    recs = iters_from_trace(*args)
    assert recs == jobs.iters_from_trace(*args)
    assert [r["mode"] for r in recs] == ["push", "pull", "push"]
    assert recs[0]["frontier"] == 5 and "union_fe" not in recs[0]
    assert "frontier" not in recs[1] and recs[1]["union_fe"] == 11
    assert recs[2] == {"mode": "push", "frontier": 7}


def test_package_surface_matches_reference():
    assert set(obs.__all__) == set(jobs.__all__) | {"region"}     # the port's profiler ranges
    assert obs.EVENT_KINDS == jobs.EVENT_KINDS
    assert obs.MODE_NAMES == jobs.MODE_NAMES
    assert obs.SLO_FIELDS == jobs.SLO_FIELDS and obs.TELE_FIELDS == jobs.TELE_FIELDS
    assert set(Observability(enabled=True).snapshot()) == set(
        jobs.Observability(enabled=True).snapshot())


# ---------------------------------------------------------------------------
# serving-stack integration
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    jg = jgen.rmat(7, 4, seed=3, directed=True)
    tg = interop.graph_from_numpy(interop.csr_arrays(jg.out),
                                  interop.csr_arrays(jg.inc), device="cpu")
    return jg, jpack(jg.inc), tg, tpacking.pack_ell(tg.inc)


def _server(S, A, g, pack, **kw):
    return S.GraphServer(
        g, pack, {"bfs": A.bfs(0), "ppr_delta": A.ppr_delta(0)},
        slots=4, cfg=S.default_config(g), result_fields={"ppr_delta": "rank"}, **kw)


def _port(graphs, **kw):
    _, _, tg, tp = graphs
    return _server(TS, TA, tg, tp, **kw)


def test_span_lifecycle_and_trace_schema(graphs, tmp_path):
    path = str(tmp_path / "trace.jsonl")
    srv = _port(graphs, telemetry=True, trace=path)
    for s in (0, 9, 33, 70):
        srv.submit("bfs", s)
        srv.submit("ppr_delta", s)
    srv.drain()
    srv.submit("bfs", 9)                       # repeat -> cache-hit span
    comps = srv.drain()
    srv.obs.close()

    spans = list(srv.obs.tracer.finished)
    assert len(spans) == len(comps) == 9 and srv.obs.tracer.open_count() == 0
    eng = [sp for sp in spans if not sp.from_cache]
    hits = [sp for sp in spans if sp.from_cache]
    assert len(hits) == 1 and hits[0].iterations == 0 and not hits[0].iters
    for sp in spans:
        ev = sp.events
        seq = [ev[k] for k in ("submit", "admit", "harvest", "complete") if k in ev]
        assert all(b >= a for a, b in zip(seq, seq[1:])), ev
        d = sp.durations()
        assert all(v >= 0 for v in d.values())
        assert d["queue_wait_s"] + d["resident_s"] <= d["total_s"] + 1e-6
    for sp in eng:
        assert sp.iterations > 0 and sp.iters and len(sp.iters) <= sp.iterations
        for it in sp.iters:
            assert it["mode"] in ("push", "pull")
            assert it.get("frontier", 0) >= 0 and it.get("union_fe", 0) >= 0
    n, errs = trace_schema.check(path)
    assert n == 9 and not errs, errs
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    assert {r["trace_id"] for r in recs} == {sp.trace_id for sp in spans}
    snap = srv.stats()["obs"]
    assert snap["enabled"] and snap["spans"]["emitted"] == 9
    lat = snap["metrics"]["bfs.latency_total_s"]
    assert lat["count"] == 4 and lat["p50"] <= lat["p99"]


def test_span_iters_equal_reference(graphs):
    """The per-iteration span records (mode, lane frontier, union volume)
    of every engine-served request equal the reference's."""
    jg, jp, _, _ = graphs
    j = _server(JS, JA, jg, jp, telemetry=True)
    t = _port(graphs, telemetry=True)
    for srv in (j, t):
        for s in (0, 9, 33, 70, 101):
            srv.submit("bfs", s)
            srv.submit("ppr_delta", s)
        srv.drain()
    sj = {sp.rid: sp for sp in j.obs.tracer.finished}
    st = {sp.rid: sp for sp in t.obs.tracer.finished}
    assert set(sj) == set(st)
    for rid, sp in st.items():
        assert (sp.algo, sp.source, sp.iterations) == (sj[rid].algo, sj[rid].source,
                                                       sj[rid].iterations)
        assert sp.iters == sj[rid].iters, rid


def test_disabled_path_is_transfer_free_and_bit_neutral(graphs):
    sources = [0, 5, 17, 40, 99]
    off = _port(graphs, telemetry=False)
    for name, pool in off.pools.items():
        assert pool.state.tele is None, name
    before = obs.TRANSFER_COUNT
    for s in sources:
        off.submit("bfs", s)
        off.submit("ppr_delta", s)
    comps_off = off.drain()
    assert obs.TRANSFER_COUNT == before
    st = off.stats()
    assert st["obs"] == {"enabled": False} and st["health"] == {"enabled": False}
    for k in ("tele", "imbalance", "audit"):
        assert k not in st["pools"]["bfs"], k

    on = _port(graphs, telemetry=True)
    for s in sources:
        on.submit("bfs", s)
        on.submit("ppr_delta", s)
    comps_on = on.drain()
    assert obs.TRANSFER_COUNT > before
    by_key = {(c.algo, c.source): c.result for c in comps_off}
    for c in comps_on:                         # telemetry is bit-neutral
        assert np.array_equal(c.result, by_key[(c.algo, c.source)]), (c.algo, c.source)
        assert not c.from_cache
    tele = on.stats()["pools"]["bfs"]["tele"]
    assert set(tele) == set(TELE_FIELDS) and all(v >= 0 for v in tele.values())
    assert tele["push_edges_scanned"] + tele["pull_edges_scanned"] > 0


def test_telemetry_fetches_one_vector_a_step(graphs):
    """With telemetry on, a pool step costs one `device_fetch` of the packed
    int64 sample, and a harvest that yields lanes one of the mode trace."""
    srv = _port(graphs, telemetry=True)
    for s in (0, 9, 33):
        srv.submit("bfs", s)
    steps0 = srv.pools["bfs"].steps
    before = obs.TRANSFER_COUNT
    harvests = 0
    while srv._queued() or srv.pools["bfs"].live():
        harvests += bool(srv.pump())
    steps = srv.pools["bfs"].steps - steps0
    assert obs.TRANSFER_COUNT - before == steps + harvests
    assert srv.pools["bfs"].iter_log[-1]["tele"].dtype == np.int64


def test_unified_stats_schema(graphs):
    srv = _port(graphs, telemetry=True)
    srv.submit("bfs", 3)
    srv.drain()
    srv.submit("bfs", 3)                       # hit
    srv.drain()
    st = srv.stats()
    for k in ("completed", "inflight", "queued", "rejected", "cache", "graph",
              "graph_version", "updates", "last_update", "shard_delta", "pools", "obs"):
        assert k in st, k
    assert st["graph"] == {"n_nodes": 128, "n_edges": srv.g.n_edges, "streaming": None}
    assert st["updates"] == 0 and st["last_update"] is None
    for k in ("hits", "misses", "evictions", "invalidations", "hit_rate"):
        assert k in st["cache"], k
    assert st["cache"]["hits"] >= 1
    for k in ("slots", "engine_queries", "steps", "tele", "last_iter"):
        assert k in st["pools"]["bfs"], k
    assert st["obs"]["enabled"] is True
    before = obs.TRANSFER_COUNT
    srv.stats()
    assert obs.TRANSFER_COUNT == before


def test_telemetry_stats_equal_reference(graphs):
    """Telemetry counters, the newest iteration sample, the imbalance plane
    and the decision-audit summary equal the reference's."""
    jg, jp, _, _ = graphs
    j = _server(JS, JA, jg, jp, telemetry=True)
    t = _port(graphs, telemetry=True)
    for srv in (j, t):
        for s in (0, 9, 33):
            srv.submit("bfs", s)
            srv.submit("ppr_delta", s)
        srv.drain()
    sj, st = j.stats(), t.stats()
    for name in ("bfs", "ppr_delta"):
        pj, pt = sj["pools"][name], st["pools"][name]
        for k in ("tele", "last_iter", "imbalance", "audit", "steps", "engine_queries"):
            assert pt[k] == pj[k], (name, k)
        assert len(t.pools[name].audit_log) == len(j.pools[name].audit_log)
        assert list(t.pools[name].audit_log) == list(j.pools[name].audit_log)


# ---------------------------------------------------------------------------
# P² streaming quantiles
# ---------------------------------------------------------------------------


def test_p2_exact_for_small_samples():
    rng = np.random.default_rng(5)
    for n in (1, 2, 3, 4, 5):
        vals = rng.lognormal(-4, 1.5, size=n)
        for q in (0.5, 0.95, 0.99):
            est = P2Quantile(q)
            for v in vals:
                est.observe(float(v))
            assert est.value() == pytest.approx(float(np.quantile(vals, q))), (n, q)
    assert math.isnan(P2Quantile(0.5).value())
    with pytest.raises(ValueError):
        P2Quantile(1.0)


@pytest.mark.parametrize("name", ["lognormal", "bimodal", "sorted"])
def test_p2_tracks_numpy_and_reference(name):
    rng = np.random.default_rng(0)
    lognormal = rng.lognormal(-4, 1.5, size=5000)
    streams = {
        "lognormal": (lognormal, 0.10),
        "bimodal": (np.concatenate([rng.normal(0.01, 0.001, 2500),
                                    rng.normal(1.0, 0.05, 2500)]), 0.15),
        "sorted": (np.sort(lognormal), 0.35),
    }
    vals, tol = streams[name]
    for q in (0.5, 0.95, 0.99):
        est, ref = P2Quantile(q), jobs.P2Quantile(q)
        for v in vals:
            est.observe(float(v))
            ref.observe(float(v))
        want = float(np.quantile(np.asarray(vals), q))
        assert abs(est.value() - want) <= tol * abs(want), (name, q)
        assert est.value() == ref.value() and est.n == len(vals)
    if name == "bimodal":
        med = P2Quantile(0.5)
        for v in vals:
            med.observe(float(v))
        assert 0.05 < med.value() < 0.95


def test_health_monitor_window_and_reset():
    t = [0.0]
    mon = obs.HealthMonitor(enabled=True, window_s=1.0, clock=lambda: t[0])
    ref = jobs.HealthMonitor(enabled=True, window_s=1.0, clock=lambda: t[0])
    for i in range(10):
        t[0] = i * 0.05
        for m in (mon, ref):
            m.on_complete(0.010, deadline_missed=(i % 2 == 0))
            m.on_queue_depth(i)
    snap = mon.snapshot()
    assert snap == ref.snapshot()
    assert snap["enabled"] and snap["window"]["completions"] == 10
    assert snap["window"]["deadline_missed"] == 5
    assert snap["window"]["miss_rate"] == pytest.approx(0.5)
    assert snap["window"]["goodput"] == pytest.approx(0.5)
    assert snap["queue_depth"]["peak"] == 9
    t[0] = 10.0
    aged = mon.snapshot()
    assert aged["window"]["completions"] == 0 and aged["window"]["goodput"] == 0.0
    assert aged["latency"]["n"] == 10
    mon.reset()
    assert mon.snapshot()["latency"]["n"] == 0
    cold = obs.HealthMonitor(enabled=False)
    cold.on_complete(1.0)
    assert cold.snapshot() == {"enabled": False}


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def test_flight_recorder_ring_bounded_seq_survives_wrap(tmp_path):
    rec = FlightRecorder(capacity=8)
    for i in range(20):
        rec.record("admit", rid=i)
    assert len(rec) == 8 and rec.seq == 20
    evs = rec.events()
    assert [e["rid"] for e in evs] == list(range(12, 20))
    seqs = [e["seq"] for e in evs]
    assert seqs == sorted(seqs) and seqs[0] == 12
    assert all(e["kind"] in EVENT_KINDS for e in evs)
    ts = [e["t"] for e in evs]
    assert all(b >= a for a, b in zip(ts, ts[1:]))
    path = str(tmp_path / "flight.jsonl")
    assert rec.dump(path) == 8
    n, errs = trace_schema.check_flight(path)
    assert n == 8 and not errs, errs
    rec.clear()
    assert len(rec) == 0 and rec.seq == 20
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


def test_global_recorder_unarmed_is_noop(tmp_path):
    saved = flight_recorder.GLOBAL
    flight_recorder.GLOBAL = None
    try:
        flight_recorder.record_global("drop", rid=1)
        path = str(tmp_path / "empty.jsonl")
        assert flight_recorder.dump_global(path) == 0
        assert os.path.getsize(path) == 0
        armed = flight_recorder.arm_global(capacity=16)
        assert flight_recorder.arm_global() is armed
        flight_recorder.record_global("drop", rid=2)
        assert flight_recorder.dump_global(path) == 1
    finally:
        flight_recorder.GLOBAL = saved


def test_flight_record_env_arms_global_ring():
    code = ("import repro_torch.obs as o; from repro_torch.obs import recorder as r\n"
            "assert r.GLOBAL is not None\n"
            "assert o.Observability().flight is r.GLOBAL\n")
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin",
           "REPRO_FLIGHT_RECORD": "1"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_armed_flight_with_telemetry_off_stays_transfer_free(graphs, tmp_path):
    sources = [0, 5, 17]
    plain = _port(graphs, telemetry=False)
    for s in sources:
        plain.submit("bfs", s)
    comps_plain = plain.drain()

    ring = FlightRecorder(capacity=64)
    armed = _port(graphs, obs=Observability(enabled=False, flight=ring))
    assert not armed.obs.enabled and armed.pools["bfs"].state.tele is None
    before = obs.TRANSFER_COUNT
    for s in sources:
        armed.submit("bfs", s)
    comps_armed = armed.drain()
    assert obs.TRANSFER_COUNT == before
    by_src = {c.source: c.result for c in comps_plain}
    for c in comps_armed:
        assert np.array_equal(c.result, by_src[c.source]), c.source
    kinds = {e["kind"] for e in ring.events()}
    assert "admit" in kinds and "harvest" in kinds
    assert not kinds & {"mode_switch", "compact_overflow", "imbalance"}
    path = str(tmp_path / "flight_off.jsonl")
    assert armed.dump_flight_record(path) == len(ring)
    n, errs = trace_schema.check_flight(path)
    assert n == len(ring) and not errs, errs


def test_decision_audit_log_records_consensus_inputs(graphs):
    srv = _port(graphs, telemetry=True)
    for s in (0, 9, 33):
        srv.submit("bfs", s)
        srv.submit("ppr_delta", s)
    srv.drain()
    pool = srv.stats()["pools"]["bfs"]
    audit = pool["audit"]
    assert audit["logged"] > 0 and audit["push"] + audit["pull"] == audit["logged"]
    assert audit["alpha_threshold"] > 0 and audit["edge_cap"] > 0
    last = audit["last"]
    for k in ("step", "union_fe", "overflow", "alpha_threshold", "edge_cap", "mode",
              "switched"):
        assert k in last, k
    heavy = (bool(last["overflow"]) or last["union_fe"] > last["alpha_threshold"]
             or last["union_fe"] > last["edge_cap"])
    assert last["mode"] == ("pull" if heavy else "push")
    imb = pool["imbalance"]
    assert len(imb["shard_edges"]) == 1 and imb["skew"] == pytest.approx(1.0)
    tele = pool["tele"]
    assert imb["shard_edges"][0] == tele["push_edges_scanned"] + tele["pull_edges_scanned"]
