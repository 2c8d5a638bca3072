"""The program's `simdx.*` ranges (`repro_torch.obs.region`) and the served
queue-wait counter, on the CPU on small rmat graphs.

Off the profiler a region enters no profiler range at all. Under
`torch.profiler` the solo engine opens one `engine.push`/`engine.pull` an
iteration and one `engine.read` a control-flow read, the batched engine one
`batch.combine` and one `batch.apply` a step and one `batch.read` a host
read, a server one `serve.admit` an admission, one `serve.step` a pool step
and one `serve.harvest` a pool a round; and the profiler changes no result,
mode trace, host read or telemetry transfer. The lifecycle recorder's epoch
lies on the profiler's clock, and `stats()["queue"]` sums the spans' queue
waits.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.obs as obs
from repro_torch.core import algorithms as A
from repro_torch.core import engine as E
from repro_torch.graph import generators as G
from repro_torch.graph import pack_ell
from repro_torch.obs import TraceRecorder, region
from repro_torch.serving import GraphServer, default_config
from repro_torch.serving import batch_engine as B


@pytest.fixture(scope="module")
def graph():
    g = G.rmat(9, 8, seed=1, device="cpu")
    return g, pack_ell(g.inc)


def _counts(prof) -> collections.Counter:
    return collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                               if e.name().startswith("simdx."))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _counts(prof)


def _solo_cfg(g, fusion="all"):
    return E.EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges, pull_impl="torch",
                          fusion=fusion)


def _serve(g, pack, telemetry=False):
    srv = GraphServer(g, pack, {"bfs": A.bfs(0), "ppr": A.ppr(0)}, slots=4,
                      telemetry=telemetry)
    for s in range(12):
        srv.submit("bfs", s)
        srv.submit("ppr", s)
    srv.drain()
    return srv


def _refuse(*args, **kwargs):
    raise AssertionError("a profiler range was entered with no profiler active")


def test_region_off_the_profiler_enters_no_range(graph, monkeypatch):
    """No path a cell runs enters a profiler range while none records."""
    g, pack = graph
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    assert not torch.autograd._profiler_enabled()
    assert region("simdx.x") is region("simdx.y")           # one shared no-op
    E.run(A.bfs(3), g, pack, _solo_cfg(g))
    B.run_batch(A.ppr(0), g, pack, default_config(g), [1, 2, 3])
    cfg = dataclasses.replace(default_config(g), masked_pull=True)
    B.run_batch(A.ppr_delta(0), g, pack, cfg, [1, 2, 3])
    _serve(g, pack, telemetry=True)


@pytest.mark.parametrize("fusion", ["all", "pushpull", "none"])
@pytest.mark.parametrize("algo", ["bfs", "sssp"])
def test_engine_spans_count_iterations_and_reads(graph, fusion, algo):
    g, pack = graph
    (m, stats), seen = _profiled(
        lambda: E.run(getattr(A, algo)(3), g, pack, _solo_cfg(g, fusion)))
    push, pull = int(stats["push_iters"]), int(stats["pull_iters"])
    assert push > 0 and pull > 0                 # both directions ran
    assert seen["simdx.engine.push"] == push and seen["simdx.engine.pull"] == pull
    assert seen["simdx.engine.read"] == int(stats["iterations"]) + 1


@pytest.mark.parametrize("algo,masked", [("ppr", False), ("bfs", False),
                                         ("ppr_delta", True)])
def test_batch_spans_one_combine_and_apply_a_step(graph, algo, masked):
    g, pack = graph
    cfg = dataclasses.replace(default_config(g), masked_pull=masked)
    reads0 = dict(B.HOST_READS)
    (m, stats), seen = _profiled(
        lambda: B.run_batch(getattr(A, algo)(0), g, pack, cfg, [1, 2, 3, 40]))
    steps = int(stats["iterations"])
    assert steps > 0
    assert seen["simdx.batch.combine"] == seen["simdx.batch.apply"] == steps
    delta = {k: B.HOST_READS[k] - reads0[k] for k in reads0}
    assert seen["simdx.batch.read"] == delta["loop"] + delta["masked"]
    assert (delta["masked"] > 0) == masked


def test_server_spans_one_admit_a_lane_one_harvest_a_pool_a_round(graph):
    g, pack = graph
    rounds = []

    def serve():
        srv = GraphServer(g, pack, {"bfs": A.bfs(0), "ppr": A.ppr(0)}, slots=4)
        for s in range(12):
            srv.submit("bfs", s)
            srv.submit("ppr", s)
        while srv._queued() or any(p.live() for _n, p, _d in srv._leaves()):
            srv.pump()
            rounds.append(1)
        return srv

    srv, seen = _profiled(serve)
    pools = srv.stats()["pools"]
    assert seen["simdx.serve.admit"] == sum(p["engine_queries"] for p in pools.values()) == 24
    assert seen["simdx.serve.harvest"] == len(rounds) * len(pools)
    assert seen["simdx.serve.step"] == sum(p["steps"] for p in pools.values())
    assert seen["simdx.batch.combine"] == seen["simdx.serve.step"]


def _solo_and_batch(g, pack):
    m, stats = E.run(A.bfs(3), g, pack, _solo_cfg(g))
    mb, sb = B.run_batch(A.ppr(0), g, pack, default_config(g), [1, 2, 3])
    return m, stats, mb, sb


def test_the_profiler_changes_no_result_trace_or_read(graph):
    """Results, mode traces, host reads and telemetry transfers are the same
    with and without the profiler recording."""
    g, pack = graph
    runs = []
    for traced in (False, True):
        reads0, fetch0 = dict(B.HOST_READS), obs.TRANSFER_COUNT
        with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
            m, stats, mb, sb = _solo_and_batch(g, pack)
            srv = _serve(g, pack, telemetry=True)
        runs.append({
            "solo": m["dist"], "solo_trace": stats["mode_trace"], "batch": mb["rank"],
            "batch_trace": sb["mode_trace"],
            "served": sorted((c.algo, c.source, c.result.tobytes()) for c in srv.completions),
            "reads": {k: B.HOST_READS[k] - reads0[k] for k in reads0},
            "fetches": obs.TRANSFER_COUNT - fetch0})
    off, on = runs
    for k in ("solo", "solo_trace", "batch", "batch_trace"):
        assert torch.equal(off[k], on[k]), k
    for k in ("served", "reads", "fetches"):
        assert off[k] == on[k], k
    assert on["fetches"] > 0


def test_queue_wait_equals_the_spans_admit_minus_submit(graph):
    g, pack = graph
    srv = _serve(g, pack, telemetry=True)
    q = srv.stats()["queue"]
    spans = [sp for sp in srv.obs.tracer.finished if not sp.from_cache]
    assert q["admitted"] == len(spans) == 24
    waits = sum(sp.events["admit"] - sp.events["submit"] for sp in spans)
    assert abs(q["wait_s"] - waits) <= 1e-6
    assert q["wait_s"] > 0


def test_queue_wait_is_kept_with_telemetry_off(graph):
    g, pack = graph
    srv = _serve(g, pack, telemetry=False)
    q = srv.stats()["queue"]
    assert q["admitted"] == 24 and q["wait_s"] > 0
    assert srv.stats()["obs"] == {"enabled": False}


def test_recorder_epoch_lies_on_the_profilers_clock():
    """A range opened at a recorder stamp maps to within 5 ms of it."""
    rec = TraceRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t = rec.now()
        with region("simdx.epoch_check"):
            np.zeros(4).sum()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "simdx.epoch_check"]
    assert abs(ev.start_ns() - (rec.epoch_unix_ns + t * 1e9)) <= 5e6
    snap = obs.Observability(enabled=True).snapshot()["spans"]
    assert isinstance(snap["epoch_unix_ns"], int) and snap["epoch_unix_ns"] > 0
    assert rec.stats()["epoch_unix_ns"] == rec.epoch_unix_ns


def test_recorder_takes_the_callers_stamps():
    rec = TraceRecorder()
    t0 = time.monotonic()
    rec.begin(1, "bfs", 0, "default", 0, t=t0)
    rec.mark(1, "admit", t=t0 + 0.25)
    span = rec.complete(1)
    assert span.durations()["queue_wait_s"] == pytest.approx(0.25, abs=1e-9)
