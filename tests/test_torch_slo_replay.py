"""The port's load harness (`repro_torch.slo`: workloads, open-loop replay,
warm-up), its drivers (`launch/slo_replay.py`, `launch/obs_report.py`) and
fault 4 (query sources out of range), against the reference on small RMAT
graphs.

Fault 4: the reference writes a query's source with `.at[source].set(...)`,
which JAX drops when the id is out of range, and its gathers clamp; the port
indexed with the raw id and raised `IndexError` (a device assert on the
card). `tests/test_slo.py` submits sources 505-599 on a 512-vertex graph.
"""

import numpy as np
import pytest

from repro import serving as JS
from repro.core import algorithms as JA
from repro.core import engine as JE
from repro.graph import generators as jgen
from repro.graph import pack_ell as jpack
from repro_torch import interop
from repro_torch import serving as TS
from repro_torch.core import algorithms as TA
from repro_torch.core import engine as TE
from repro_torch.graph import packing as tpacking

ALGOS = ("bfs", "sssp", "ppr", "ppr_delta")


@pytest.fixture(scope="module")
def graphs():
    jg = jgen.rmat(7, 8, seed=3)
    tg = interop.graph_from_numpy(interop.csr_arrays(jg.out), device="cpu")
    return jg, jpack(jg.inc), tg, tpacking.pack_ell(tg.inc)


@pytest.fixture(scope="module")
def fault4(graphs):
    """Programs built once (the reference's jit caches by program) and one
    server a package, shared by the cases."""
    jg, jp, tg, tp = graphs
    progs = {a: (getattr(JA, a)(0), getattr(TA, a)(0)) for a in ALGOS}
    servers = [S.GraphServer(g, p, {a: progs[a][i] for a in ALGOS}, slots=2,
                             cfg=S.default_config(g), queue_cap=16)
               for i, (S, g, p) in enumerate(((JS, jg, jp), (TS, tg, tp)))]
    return progs, servers


def _out_of_range(n):
    return {"n+1": n + 1, "n+100": n + 100, "-1": -1, "-(n+2)": -(n + 2)}


@pytest.mark.parametrize("which", ["n+1", "n+100", "-1", "-(n+2)"])
def test_fault4_out_of_range_source_served_as_the_reference(graphs, fault4, which):
    jg, jp, tg, tp = graphs
    progs, servers = fault4
    n = jg.n_nodes
    src = _out_of_range(n)[which]
    jcfg = JE.EngineConfig(frontier_cap=n, edge_cap=jg.n_edges)
    tcfg = TE.EngineConfig(frontier_cap=n, edge_cap=jg.n_edges)
    for name in ALGOS:
        jm, jst = JE.run(progs[name][0], jg, jp, jcfg, source=np.int32(src))
        tm, tst = TE.run(progs[name][1], tg, tp, tcfg, source=src)
        for k in jm:
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=(name, k))
        for k in ("iterations", "push_iters", "pull_iters", "mode_trace", "fe_trace"):
            np.testing.assert_array_equal(np.asarray(tst[k]), np.asarray(jst[k]),
                                          err_msg=(name, k))
    # through the server: the out-of-range query shares its pool with an
    # in-range one, as in tests/test_slo.py
    done = []
    for srv in servers:
        n0 = len(srv.completions)
        for a in ALGOS:
            srv.submit(a, src)
            srv.submit(a, 5 + len(srv.completions))
        done.append(srv.drain()[n0:])
    jc, tc = done
    assert len(jc) == len(tc) == 2 * len(ALGOS)
    for a, b in zip(jc, tc):
        assert (a.rid, a.algo, a.source, a.iterations, a.from_cache) == (
            b.rid, b.algo, b.source, b.iterations, b.from_cache)
        np.testing.assert_array_equal(b.result, np.asarray(a.result), err_msg=a.algo)


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from repro import slo as JSLO  # noqa: E402
from repro.launch import obs_report as jreport  # noqa: E402
from repro.launch import slo_replay as jreplay  # noqa: E402
from repro_torch import slo as TSLO  # noqa: E402
from repro_torch.launch import obs_report as treport  # noqa: E402
from repro_torch.launch import slo_replay as treplay  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _workload(P, **kw):
    """The same spec in either package (`P` is `repro.slo` or the port's)."""
    tenants = (P.TenantClass("paid", 2.0, (("bfs", 1.0), ("sssp", 2.0)),
                             deadline_ms=100.0, hot_frac=0.5),
               P.TenantClass("batch", 1.0, (("ppr_delta", 1.0),)),
               P.TenantClass("hubs", 0.5, (("bfs", 1.0),), sources=(3, 5, 600),
                             hot_frac=0.2))
    spec = dict(arrival="mmpp", rate_qps=80.0, duration_s=4.0, update_every_s=0.7,
                update_batch=6, tenants=tenants, seed=11)
    spec.update(kw)
    return P.Workload(**spec)


@pytest.mark.parametrize("arrival,kw", [
    ("poisson", {}),
    ("mmpp", {}),
    ("mmpp", {"burst_factor": 12.0, "burst_frac": 0.1, "seed": 3}),
    ("poisson", {"update_every_s": 0.0, "hot_set": 1, "seed": 7}),
])
def test_generate_bit_equal_to_the_reference(arrival, kw):
    jw = _workload(JSLO, arrival=arrival, **kw)
    tw = _workload(TSLO, arrival=arrival, **kw)
    ja, ta = JSLO.generate(jw, 512), TSLO.generate(tw, 512)
    assert len(ja) == len(ta) > 0
    for a, b in zip(ja, ta):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert JSLO.describe(jw) == TSLO.describe(tw)
    if tw.update_every_s:
        assert any(a.kind == "update" and a.deletes for a in ta)


def test_percentiles_equal_to_the_reference():
    rng = np.random.default_rng(4)
    for samples in ([], [0.0], [0.0, 0.0, 0.5], list(rng.exponential(0.2, 101))):
        assert TSLO.percentiles(samples) == JSLO.percentiles(samples)


# ---------------------------------------------------------------------------
# replay and warm-up on a small server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slo_graphs():
    jg = jgen.rmat(9, 8, seed=3)
    tg = interop.graph_from_numpy(interop.csr_arrays(jg.out), device="cpu")
    return jg, jpack(jg.inc), tg, tpacking.pack_ell(tg.inc)


def _slo_server(tg, tp, policy=True, **kw):
    make = {"bfs": TA.bfs(0), "sssp": TA.sssp(0), "ppr_delta": TA.ppr_delta(0)}
    pol = (TS.SLOPolicy(degrade_algos=("ppr_delta",), degrade_slots=2)
           if policy else None)
    return TS.GraphServer(tg, tp, make, slots=2, cfg=TS.default_config(tg),
                          queue_cap=16, result_fields={"ppr_delta": "rank"},
                          tenant_weights={"paid": 2.0, "batch": 1.0}, slo=pol, **kw)


def test_warmup_leaves_an_empty_cache_and_no_ewma(slo_graphs):
    _jg, _jp, tg, tp = slo_graphs
    srv = _slo_server(tg, tp)
    TSLO.warmup(srv, {"bfs": 1, "sssp": 1, "ppr_delta": 1})
    assert len(srv.cache) == 0
    assert all(p.ewma_resident_s is None for _n, p, _d in srv._leaves())
    # the degraded pool was admitted into and drained
    assert srv.degraded_pools["ppr_delta"].engine_queries == 1
    assert not srv._degraded_rids and not srv._inflight_sources


def test_replay_accounts_every_query_as_deltas(slo_graphs):
    jg, _jp, tg, tp = slo_graphs
    srv = _slo_server(tg, tp, delta_cap=64)
    TSLO.warmup(srv, {"bfs": 1, "sssp": 1, "ppr_delta": 1})
    w = TSLO.Workload(
        arrival="poisson", rate_qps=120.0, duration_s=1.0, update_every_s=0.3,
        tenants=(TSLO.TenantClass("paid", 0.3, (("bfs", 1.0), ("sssp", 1.0)),
                                  deadline_ms=300.0),
                 TSLO.TenantClass("batch", 0.7, (("ppr_delta", 1.0),), hot_frac=0.25)),
        seed=5)
    arrivals = TSLO.generate(w, tg.n_nodes)
    reports = []
    for _ in range(2):          # the second replay runs on a warmed, used server
        rep = TSLO.replay(srv, arrivals, max_wall_s=60.0)
        reports.append(rep)
        assert rep.offered == sum(a.kind == "query" for a in arrivals)
        assert rep.crashed_lanes == 0
        assert rep.completed + rep.shed + rep.dropped == rep.offered
        assert rep.updates_applied == sum(a.kind == "update" for a in arrivals)
        assert 0.0 < rep.goodput <= 1.0
        assert set(rep.per_tenant) <= {"paid", "batch"}
        assert rep.total is None or rep.total["p50_seconds"] <= rep.total["p99_seconds"]
        assert rep.health == srv.stats()["health"]
        json.dumps(rep.to_json())
    assert srv.graph_version == 2 * reports[0].updates_applied


def _write_artifacts(tmp_path, tg, tp):
    """One replay of the port with a trace and an armed flight recorder."""
    trace, flight = tmp_path / "t.jsonl", tmp_path / "f.jsonl"
    from repro_torch.obs import Observability

    srv = _slo_server(tg, tp, delta_cap=32,
                      obs=Observability(enabled=True, trace=str(trace), flight=True))
    TSLO.warmup(srv, {"bfs": 1, "ppr_delta": 1})
    w = TSLO.Workload(arrival="poisson", rate_qps=60.0, duration_s=0.6,
                      update_every_s=0.25,
                      tenants=(TSLO.TenantClass("paid", 1.0, (("bfs", 1.0),),
                                                deadline_ms=500.0),
                               TSLO.TenantClass("batch", 1.0, (("ppr_delta", 1.0),))),
                      seed=2)
    TSLO.replay(srv, TSLO.generate(w, tg.n_nodes), max_wall_s=60.0)
    srv.obs.close()
    srv.dump_flight_record(str(flight))
    return trace, flight


def test_obs_report_prints_the_reference_report(slo_graphs, tmp_path, capsys):
    _jg, _jp, tg, tp = slo_graphs
    trace, flight = _write_artifacts(tmp_path, tg, tp)
    outs = []
    for mod in (jreport, treport):
        for args in (["--trace", str(trace), "--flight", str(flight)],
                     ["--trace", str(trace)], ["--flight", str(flight)]):
            assert mod.main(args) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "== trace:" in outs[1] and "phases (split at update_swap)" in outs[1]


def test_trace_schema_accepts_the_port_trace(slo_graphs, tmp_path):
    _jg, _jp, tg, tp = slo_graphs
    trace, flight = _write_artifacts(tmp_path, tg, tp)
    for args in ([str(trace)], ["--flight", str(flight)]):
        r = subprocess.run([sys.executable, str(ROOT / "scripts" / "trace_schema.py"), *args],
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr


def test_slo_replay_json_counts_equal_the_reference(capsys):
    args = ["--scale", "8", "--duration", "1", "--rate", "20", "--queue-cap", "256",
            "--update-every", "0.4", "--deadline-ms", "5000", "--json"]
    assert jreplay.main(args) == 0
    jout = capsys.readouterr().out
    assert treplay.main(args + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out

    def report(out):
        return json.loads(out[out.index("{"):])

    def head(out):
        return [ln for ln in out.splitlines() if ln.startswith("[slo_replay]")][:2]

    jr, tr = report(jout), report(tout)
    for k in ("offered", "shed", "updates_applied"):
        assert jr[k] == tr[k], k
    assert tr["shed"] == 0 and tr["crashed_lanes"] == 0
    assert set(jr) == set(tr)
    assert head(jout) == head(tout)
