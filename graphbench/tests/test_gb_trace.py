"""`graphbench/spans.py`: the program's `simdx.*` ranges summarized from a
trace. Synthetic events pin the attribution (a device operation belongs to
the innermost range open when the call that launched it began), self time,
the count of device-to-host copies and the device-side copy of a host range
left out; a traced run of each cell at CPU size gives each cell's ranges;
and on the card, a tiny `engine.run` leaves no device operation unlinked."""

from __future__ import annotations

import math

import pytest
from conftest import run_tiny

from graphbench import spans
from graphbench.spans import Event

MS = 1_000_000


def host(name, a, b, corr=0):
    return Event(dev=False, name=name, start=a * MS, end=b * MS, corr=corr)


def launch(corr, a, name="cudaLaunchKernel"):
    return host(name, a, a + 0.01, corr=corr)


def device(name, a, b, corr=0, linked=0, annotation=False):
    return Event(dev=True, name=name, start=a * MS, end=b * MS, corr=corr, linked=linked,
                 annotation=annotation)


def trace():
    """gb.window [0, 100): an engine.push [10, 40) holding a batch.read
    [20, 30); an engine.read [50, 60); a kernel launched in each, one
    outside every range, and a device-side copy of the push range."""
    return [
        host("gb.window", 0, 100),
        host("simdx.engine.push", 10, 40),
        host("simdx.batch.read", 20, 30),
        host("simdx.engine.read", 50, 60),
        launch(1, 12), device("push_kernel", 41, 45, corr=1),
        launch(2, 21, "cudaMemcpyAsync"), device("Memcpy DtoH (Device -> Pageable)", 46, 47,
                                                 corr=2),
        launch(3, 35), device("push_tail", 47, 49, corr=3),
        launch(4, 52, "cudaMemcpyAsync"), device("Memcpy DtoH (Device -> Pageable)", 61, 62,
                                                 corr=4),
        launch(5, 70), device("outside_kernel", 70, 72, corr=5),
        device("simdx.engine.push", 41, 49, annotation=True),
    ]


def test_a_kernel_belongs_to_the_innermost_range_open_at_its_launch():
    s = spans.summarize(trace())
    rows = s["spans"]
    assert rows["simdx.engine.push"]["device_s"] == pytest.approx(6e-3)   # 4 + 2 ms
    assert rows["simdx.batch.read"]["device_s"] == pytest.approx(1e-3)
    assert rows["simdx.engine.read"]["device_s"] == pytest.approx(1e-3)
    assert s["outside_s"] == pytest.approx(2e-3)
    assert s["links"] == {"correlation": 5, "external id": 0, "none": 0}


def test_self_time_subtracts_the_child_ranges():
    rows = spans.summarize(trace())["spans"]
    assert rows["simdx.engine.push"]["host_s"] == pytest.approx(30e-3)
    assert rows["simdx.engine.push"]["self_s"] == pytest.approx(20e-3)
    assert rows["simdx.batch.read"]["self_s"] == pytest.approx(10e-3)
    assert {k: r["count"] for k, r in rows.items()} == {
        "simdx.batch.read": 1, "simdx.engine.push": 1, "simdx.engine.read": 1}


def test_device_to_host_copies_are_counted():
    rows = spans.summarize(trace())["spans"]
    assert rows["simdx.batch.read"]["dtoh"] == rows["simdx.engine.read"]["dtoh"] == 1
    assert rows["simdx.engine.push"]["dtoh"] == 0


def test_a_device_side_copy_of_a_range_is_not_device_time():
    s = spans.summarize(trace())
    assert s["device_s"] == pytest.approx(10e-3)      # 4 + 1 + 2 + 1 + 2 ms, no 8
    again = spans.summarize([e for e in trace() if not e.annotation])
    assert again == s


def test_device_time_is_clipped_to_the_window():
    events = trace() + [launch(6, 95), device("late", 98, 110, corr=6)]
    s = spans.summarize(events)
    assert s["device_s"] == pytest.approx(12e-3) and s["outside_s"] == pytest.approx(4e-3)


def test_without_the_runtime_link_the_launching_op_decides():
    """A trace without runtime calls: each device op's linked id names the
    host op that launched it."""
    events = [host("gb.window", 0, 100), host("simdx.batch.apply", 10, 40),
              host("aten::cat", 11, 12, corr=77), host("aten::add", 50, 51, corr=78),
              device("cat_kernel", 41, 44, corr=900, linked=77),
              device("add_kernel", 52, 53, corr=901, linked=78),
              device("orphan", 60, 61, corr=902)]
    s = spans.summarize(events)
    assert s["links"] == {"correlation": 0, "external id": 2, "none": 1}
    assert s["spans"]["simdx.batch.apply"]["device_s"] == pytest.approx(3e-3)
    assert s["outside_s"] == pytest.approx(2e-3)


def test_readings_are_the_ratios_of_the_rows():
    r = spans.readings(spans.summarize(trace()), rounds=2,
                       queue={"wait_s": 3.0, "admitted": 4})
    assert r["push_device_share"] == pytest.approx(60.0)
    assert r["host_syncs_per_iter"] == 1.0             # one read's copy, one push
    assert r["queue_wait_ms"] == pytest.approx(750.0)
    assert r["apply_device_ms"] is None and r["admit_ms"] is None
    assert r["harvest_ms"] is None and r["serve_spans_ms"] is None


def test_a_region_is_a_host_op_not_a_user_annotation():
    """So the harness's trace (which leaves out only `gb.*` device-side
    annotations) counts no copy of a program range as device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import region

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with region("simdx.test"):
            pass
    (e,) = [e for e in spans.events_of(prof) if e.name == "simdx.test"]
    assert not e.dev and not e.annotation


#: the ranges each cell's traced run must hold
CELLS = {
    "kron23-graph500": ("engine.push", "engine.pull", "engine.read"),
    "urand24-graph500": ("engine.push", "engine.pull", "engine.read"),
    "kron23-ppr64": ("batch.combine", "batch.apply", "batch.read"),
    "kron23-serve": ("serve.admit", "serve.step", "serve.harvest", "batch.combine",
                     "batch.apply", "batch.read"),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cells_traced_run_holds_its_ranges(tiny, cell):
    """A traced run of each cell at CPU size, its events kept as the report
    keeps them: the cell's ranges are there, the counts hold, the host-side
    readings are finite and the device's are not read."""
    got: dict = {}
    with spans._captured(got):
        result = run_tiny(tiny, cell, traced=True)
    assert result["correct"]
    s = spans.summarize(got["events"])
    for name in CELLS[cell]:
        assert s["spans"][f"simdx.{name}"]["count"] > 0, name
    rows, window = s["spans"], got["run"].window
    if cell.endswith("graph500"):
        iters = sum(it["iters"] for it in window.items)
        assert rows["simdx.engine.push"]["count"] + rows["simdx.engine.pull"]["count"] == iters
        assert rows["simdx.engine.read"]["count"] == iters + len(window.items)
    queue = got["stats"]["queue"] if cell == "kron23-serve" else None
    r = spans.readings(s, len(window.spans.get("pump", [])), queue)
    assert s["device_s"] == 0                  # a CPU run: no device reading
    assert r["push_device_share"] is r["host_syncs_per_iter"] is r["apply_device_ms"] is None
    if cell == "kron23-serve":
        assert queue["admitted"] == rows["simdx.serve.admit"]["count"]
        for k in ("admit_ms", "harvest_ms", "queue_wait_ms", "serve_spans_ms"):
            assert math.isfinite(r[k]) and r[k] >= 0, k


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the profiler's device events)")


@pytest.mark.cuda
def test_a_tiny_engine_run_on_the_card_leaves_no_op_unlinked(card):
    """Every device operation of a small `engine.run` links to the call that
    launched it; the ranges hold the loop's device time; each control-flow
    read is one device-to-host copy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import algorithms as A
    from repro_torch.core import engine as E
    from repro_torch.graph import generators as G
    from repro_torch.graph import pack_ell

    g = G.rmat(12, 8, seed=1, device="cuda")
    pack = pack_ell(g.inc)
    cfg = E.EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges)
    E.run(A.bfs(3), g, pack, cfg)                               # builds the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(spans.WINDOW):
            _, stats = E.run(A.bfs(3), g, pack, cfg)
            torch.cuda.synchronize()
    s = spans.summarize(spans.events_of(prof))
    rows = s["spans"]
    iters = int(stats["iterations"])
    assert s["links"]["none"] == 0 and s["links"]["correlation"] > 0, s["links"]
    assert rows["simdx.engine.read"]["count"] == iters + 1
    assert rows["simdx.engine.read"]["dtoh"] == iters + 1
    assert rows["simdx.engine.push"]["dtoh"] == rows["simdx.engine.pull"]["dtoh"] == 0
    inside = sum(r["device_s"] for r in rows.values())
    assert inside > 0 and inside + s["outside_s"] == pytest.approx(s["device_s"])
    r = spans.readings(s)
    assert r["host_syncs_per_iter"] == pytest.approx((iters + 1) / iters)
    print("links", s["links"], "rows", rows, "outside_s", s["outside_s"])
