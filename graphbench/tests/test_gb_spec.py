"""BENCHMARK.json against the contract's form: keys, names, units, limits,
and that every metric and cell refers to what exists."""

from __future__ import annotations

import json
import re

import pytest
from conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert 1 <= len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (REPO / p).is_dir()


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_have_exactly_their_keys(group):
    for entry in BENCH[group]:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert KEYS[group] <= set(entry) <= KEYS[group] | extra, entry["name"]


@pytest.mark.parametrize("group", sorted(KEYS))
def test_names_and_units_use_allowed_characters(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for entry in BENCH[group]:
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry and group in ("configs", "workloads", "per_layer"):
                assert line(entry[key]), (entry["name"], key)
        for key in entry.get("reduced", []):
            assert NAME.match(key)
        if group == "workloads":
            assert NAME.match(entry["traffic"]) and NAME.match(entry["config"])


def test_metric_names_are_unique_across_groups():
    names = [m["name"] for g in ("end_to_end", "per_layer") for m in BENCH[g]]
    assert len(names) == len(set(names))


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def reported(group: str, cell: str) -> set:
    return {m["name"] for m in BENCH[group] if cell in m.get("workloads", [cell])}


def test_cells_report_what_the_contract_asks():
    cells = {c["name"] for c in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in BENCH["workloads"]:
        assert c["config"] in configs and c["chips"] in (1, 4)
        e2e = reported("end_to_end", c["name"])
        assert "setup_s" in e2e and len(e2e) >= 2 and reported("per_layer", c["name"])
    assert configs == {c["config"] for c in BENCH["workloads"]}
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert set(m.get("workloads", cells)) <= cells


def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [c["name"] for c in BENCH["workloads"]]):
            assert m["moves"] in reported("end_to_end", cell), (m["name"], cell)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_roofline_metrics_are_named_and_measured_as_the_contract_says():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
            assert m["source"] == "device_trace"


def test_command_names_only_files_under_paths():
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p.rstrip("/") + "/") for p in BENCH["paths"])
            assert (REPO / word).is_file()


def test_config_files_lie_under_paths_and_name_their_cut():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert set(c["reduced"]) == set(data["reduced"])
        for key in c["reduced"]:
            assert data[key] != data["published"][key]
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(sources) == len(set(sources))
