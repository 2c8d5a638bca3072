"""The port's graph examples (`examples/torch/quickstart.py`,
`graph_analytics.py`) on the CPU against the reference's scripts
(`examples/quickstart.py`, `graph_analytics.py`): every printed line equal
(graph sizes, ELL fill, iterations, push/pull counts, switches, the
widest-path result), but the wall-clock milliseconds of `graph_analytics`.
Both scripts run at their only size (RMAT-11 and RMAT-12 + grid2d(64))."""

import re
import runpy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def run_reference(name, capsys, monkeypatch, argv=()):
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    runpy.run_path(str(ROOT / "examples" / name), run_name="__main__")
    return capsys.readouterr().out


def run_port(name, capsys, argv=()):
    mod = runpy.run_path(str(ROOT / "examples" / "torch" / name))
    mod["main"](["--device", "cpu"] + list(argv))
    return capsys.readouterr().out


@pytest.mark.parametrize("name", ["quickstart.py", "graph_analytics.py"])
def test_graph_example_prints_the_reference_lines(name, capsys, monkeypatch):
    mask = lambda out: re.sub(r" +\d+\.\d ms", " <ms> ms", out).splitlines()
    want = run_reference(name, capsys, monkeypatch)
    got = run_port(name, capsys)
    assert mask(got) == mask(want)
    assert "matches numpy maximin-dijkstra: True" in got or "== road" in got
