"""The entry command: refuses without a card, and in a directory that holds
only BENCHMARK.json and the benchmark's files; the card tests (a short run,
and every cell's control at the cell's own size) decide in their fixture
whether there is a card."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
from conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
ARGS = ["--workload", "kron23-graph500", "--seed", "3", "--seconds", "1", "--trace", "0"]


def run(cwd, env=None):
    return subprocess.run([sys.executable, "graphbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=600, env=env)


def test_without_a_card_it_fails_and_prints_no_result():
    import os

    out = run(REPO, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_with_only_the_benchmarks_files_it_fails(tmp_path):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    for p in bench["paths"]:
        shutil.copytree(REPO / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark runs on the card only)")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    out = run(REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_the_cells_control_fails_on_the_card(card, cell):
    from graphbench import control, harness

    checks = control.control(cell, 11, "cuda:0")
    assert harness.fails(checks), checks
