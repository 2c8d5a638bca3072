"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at a size
the CPU holds (scale 10 graphs, small pools), run through the harness on
the CPU with the card's check skipped."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: what the CPU copy changes: graph scale, and the traffic sizes that fill
#: pools and batches
TINY_SCALE = 10
TINY_TRAFFIC = {
    "ppr64": {"batch": 8},
    "serve": {"slots": 4, "clients": 24, "queue_cap": 72, "hot_set": 16, "stream": 512,
              "check_rate": 0.5, "check_requests": 12},
}


def make_tiny(dest: Path) -> Path:
    """Copy BENCHMARK.json and graphbench/ under `dest`, cut to CPU size."""
    shutil.copy(REPO / "BENCHMARK.json", dest)
    shutil.copytree(REPO / "graphbench", dest / "graphbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (dest / "graphbench" / "configs").glob("*.json"):
        edit(f, scale=TINY_SCALE)
    for name, changes in TINY_TRAFFIC.items():
        edit(dest / "graphbench" / "traffic" / f"{name}.json", **changes)
    return dest


def edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path)


def run_tiny(root: Path, workload: str, seed: int = 7, seconds: float = 0.5,
             traced: bool = False) -> dict:
    import time

    from graphbench import harness

    return harness.run_cell(workload, seed, seconds, traced, "cpu", time.perf_counter(),
                            root=root)
