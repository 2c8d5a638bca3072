"""The harness finds every cell's files by name, and a later configuration,
traffic mix, driver, check or metric enters as new files and entries alone."""

from __future__ import annotations

import json

import pytest
from conftest import REPO, edit, run_tiny

from graphbench import harness

BENCH = harness.load_benchmark(REPO)
CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cells_files_are_found_by_name(cell):
    c = harness.cell_of(BENCH, cell)
    config = harness.config_of(REPO, BENCH, c["config"])
    traffic = harness.traffic_of(REPO, c["traffic"])
    assert config["name"] == c["config"]
    driver = harness.module(REPO, "drivers", traffic["driver"])
    assert all(callable(getattr(driver, f)) for f in ("warm", "drive", "finish",
                                                       "control_sources"))
    for traced in (False, True):
        for m in harness.metrics_of(BENCH, cell, traced):
            assert callable(harness.module(REPO, "metrics", m["name"]).read)
    algos = traffic.get("programs") or traffic.get("algos") or [traffic["program"]]
    for algo in algos:
        mod = harness.module(REPO, "checks", algo)
        assert callable(mod.check) and callable(mod.control) and mod.LIMITS


def test_every_metric_has_its_reader():
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert (REPO / "graphbench" / "metrics" / f"{m['name']}.py").is_file()


def test_a_missing_file_is_named():
    with pytest.raises(FileNotFoundError, match="no_such_metric"):
        harness.module(REPO, "metrics", "no_such_metric")


def test_new_config_traffic_and_metrics_enter_as_files_and_entries(tiny):
    """A new deployment (a smaller Kronecker graph), a new mix (batched SSSP
    at Q = 4), a new end-to-end and a new per-layer metric: files and
    entries only, then the new cell runs and reports both metrics."""
    g = tiny / "graphbench"
    config = json.loads((g / "configs" / "gap-kron23.json").read_text())
    config.update(name="gap-kron9", scale=9)
    (g / "configs" / "gap-kron9.json").write_text(json.dumps(config))
    (g / "traffic" / "sssp4.json").write_text(json.dumps(
        {"driver": "batch", "program": "sssp", "batch": 4, "batches": 8, "check_queries": 3}))
    (g / "metrics" / "sssp_qps.py").write_text(
        "def read(run):\n    return len(run.window.items) / run.window.seconds\n")
    (g / "metrics" / "sssp_steps.sssp4.py").write_text(
        "def read(run):\n    return run.window.counters['steps']\n")
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gap-kron9", "source": "a smaller kron",
                             "file": "graphbench/configs/gap-kron9.json",
                             "reduced": ["scale"], "why": "a test"})
    bench["workloads"].append({"name": "kron9-sssp4", "config": "gap-kron9",
                               "traffic": "sssp4", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "sssp_qps", "unit": "queries/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["kron9-sssp4"]})
    bench["per_layer"].append({"name": "sssp_steps.sssp4", "unit": "steps",
                               "better": "lower", "source": "program_counter",
                               "layer": "serving.batch_engine", "moves": "sssp_qps",
                               "workloads": ["kron9-sssp4"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    plain = run_tiny(tiny, "kron9-sssp4")
    assert plain["correct"] and set(plain["metrics"]) == {"setup_s", "sssp_qps"}
    traced = run_tiny(tiny, "kron9-sssp4", traced=True)
    assert traced["correct"] and traced["metrics"]["sssp_steps.sssp4"]["value"] > 0
    assert traced["checks"]["sssp_mismatch"]["value"] == 0


def test_the_traffic_file_sets_the_work(tiny):
    """The mix's numbers reach the driver: a batch of 2 gives even counts of
    queries, a batch of 3 counts divisible by 3."""
    for q in (2, 3):
        edit(tiny / "graphbench" / "traffic" / "ppr64.json", batch=q)
        r = run_tiny(tiny, "kron23-ppr64", seconds=0.2)
        assert r["attempted"] % q == 0 and r["correct"]
