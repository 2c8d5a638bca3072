"""The control of every cell fails its comparison at test size on the CPU:
the reference held in bfloat16 in the program's place. For the exact answers
it is SSSP that fails: GAP's weights in [1, 255] take distances past 256,
where bfloat16 stops holding integers, while hop counts stay exact. A
uniform graph at test size keeps every distance under 256, so its cell's
control fails only at the cell's own size (`test_gb_run.py`, on the card)."""

from __future__ import annotations

import pytest
import torch
from conftest import REPO

from graphbench import compare, control, gen, harness, reference

BENCH = harness.load_benchmark(REPO)
CELLS = [c["name"] for c in BENCH["workloads"]
         if harness.config_of(REPO, BENCH, c["config"])["generator"] != "uniform"]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", CELLS)
def test_the_cells_control_fails(tiny, cell, seed):
    checks = control.control(cell, seed, "cpu", root=tiny)
    assert harness.fails(checks), checks


def test_a_uniform_graph_at_test_size_stays_under_256(tiny):
    checks = control.control("urand24-graph500", 1, "cpu", root=tiny)
    assert not harness.fails(checks), checks


@pytest.mark.parametrize("seed", [1, 2])
def test_bfloat16_fails_sssp_and_holds_bfs_exactly(tiny, seed):
    checks = control.control("kron23-graph500", seed, "cpu", kind="bfloat16", root=tiny)
    assert harness.fails(checks) == ["sssp_mismatch"], checks


def test_bfloat16_distances_go_wrong_only_past_256():
    cfg = dict(harness.config_of(REPO, BENCH, "gap-kron23"), scale=9)
    e = gen.draw(cfg, 4, "cpu")
    adj = reference.Adjacency(e)
    root = gen.sources(e, 1, 4, salt=1)[0]
    d, db = reference.sssp(adj, root), reference.sssp(adj, root, dtype=torch.bfloat16)
    wrong = (d != db) & torch.isfinite(d)
    assert compare.mismatches(db, d) == int(wrong.sum()) > 0
    assert bool((d[wrong] > 256).all())
