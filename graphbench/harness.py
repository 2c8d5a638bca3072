"""Run one cell of `BENCHMARK.json` and assemble its result line.

Everything that belongs to one configuration, traffic mix, driver, checked
algorithm or metric is a file found by its name:

  configs/<config>.json   the deployment: generator, scale, weights
  traffic/<mix>.json      the mix's parameters, and the driver that reads them
  drivers/<driver>.py     `warm(ctx)`, `drive(ctx, state, seconds)`,
                          `finish(ctx, state, window)`
  checks/<algo>.py        `check(ref, outputs, params)`, `control(...)`, `LIMITS`
  metrics/<metric>.py     `read(run)` -> a number, or None where there is
                          nothing to read; optional `WRAP`, a map from the
                          name of a `repro_torch.kernels.ops` function to
                          what the traced run keeps of each of its calls

so a later cell, mix or metric enters as new files and entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import re
import sys
import time
import zlib
from pathlib import Path
from typing import Optional

#: the checkout root (this file is <root>/graphbench/harness.py)
ROOT = Path(__file__).resolve().parents[1]
PKG = "graphbench"


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(root: Path, bench: dict, name: str) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return json.loads((root / entry["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_of(root: Path, name: str) -> dict:
    return json.loads((root / PKG / "traffic" / f"{name}.json").read_text())


def module(root: Path, kind: str, name: str):
    """`<root>/graphbench/<kind>/<name>.py`, loaded under a private name."""
    path = root / PKG / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    # keyed by the file, so two checkouts in one process never share one
    tag = zlib.crc32(str(path.resolve()).encode())
    modname = f"{PKG}_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}_{tag:08x}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str, traced: bool) -> list:
    """The cell's metric entries: end to end in a plain run, per layer in a
    traced one; an entry with `workloads` counts only in those cells."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Window:
    """What a driver returns from its measured window."""

    seconds: float                        # the window's length
    items: list                           # a dict per attempted unit of work
    counters: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)   # name -> [seconds]
    #: (algo, source, result) answers kept for the comparison, and the
    #: number of kept answers that never came
    outputs: list = dataclasses.field(default_factory=list)
    missing: int = 0
    #: what the driver saw, printed to standard error (no metric reads it)
    notes: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Ctx:
    """A cell's inputs, handed to its driver."""

    device: object
    seed: int
    config: dict
    traffic: dict
    traced: bool
    edges: object = None
    graph: object = None
    pack: object = None

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        from graphbench import trace

        return trace.span(self.traced, name)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    window: Window
    trace: Optional[object]


def build(ctx: Ctx) -> None:
    """Draw the edges on the device from the seed and build the port's graph
    and ELL pack from them (the port's own build, timed as set-up)."""
    from graphbench import gen
    from repro_torch.graph import from_edges, pack_ell

    ctx.edges = e = gen.draw(ctx.config, ctx.seed, ctx.device)
    ctx.graph = from_edges(e.src, e.dst, e.n, e.w, directed=False, device=ctx.device)
    ctx.pack = pack_ell(ctx.graph.inc)


def check(root: Path, ctx: Ctx, window: Window) -> dict:
    """name -> (value, limit) for every number compared: per algorithm its
    check module's numbers, and the kept answers that never came."""
    from graphbench.reference import RefGraph

    ref = RefGraph(ctx.edges)
    by_algo: dict = {}
    for algo, source, result in window.outputs:
        by_algo.setdefault(algo, []).append((source, result))
    out = {"missing_answers": (window.missing, 0)}
    for algo in sorted(by_algo):
        mod = module(root, "checks", algo)
        values = mod.check(ref, by_algo[algo], ctx.traffic.get("params", {}).get(algo, {}))
        out.update({k: (v, mod.LIMITS[k]) for k, v in values.items()})
    return out


def fails(checks: dict) -> list:
    """The names of the compared numbers outside their limits (a NaN fails)."""
    return [k for k, (v, lim) in checks.items() if not v <= lim]


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, root: Path = ROOT) -> dict:
    """One run of one cell; returns the result line as a dict. `t_start` is
    the host clock at the start of the process, where set-up begins."""
    import torch

    from graphbench import trace

    bench = load_benchmark(root)
    cell = cell_of(bench, workload)
    ctx = Ctx(device=torch.device(device), seed=int(seed),
              config=config_of(root, bench, cell["config"]),
              traffic=traffic_of(root, cell["traffic"]), traced=traced)
    driver = module(root, "drivers", ctx.traffic["driver"])
    readers = [(m, module(root, "metrics", m["name"])) for m in metrics_of(bench, workload, traced)]

    marks = [("start", time.perf_counter())]
    build(ctx)
    ctx.sync()
    marks.append(("CUDA start, draw, build, pack", time.perf_counter()))
    state = driver.warm(ctx)
    ctx.sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print("set-up s: process start and imports %.3f, " % (marks[0][1] - t_start)
          + ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])),
          file=sys.stderr)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)

    summary = None
    if traced:
        wrap: dict = {}
        for _, mod in readers:
            for name, record in getattr(mod, "WRAP", {}).items():
                if wrap.setdefault(name, record) is not record:
                    raise ValueError(f"two metrics record {name!r} calls differently")
        calls: dict = {}
        with trace.recording(wrap, calls), trace.profiler() as prof:
            with torch.profiler.record_function(trace.WINDOW):
                window = driver.drive(ctx, state, seconds)
        summary = trace.summarize(prof, calls)
    else:
        window = driver.drive(ctx, state, seconds)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0

    driver.finish(ctx, state, window)
    print(f"window: {window.seconds:.3f} s, {len(window.items)} attempted, "
          f"{json.dumps(window.notes)}", file=sys.stderr)
    run = Run(setup_s=setup_s, window=window, trace=summary)
    metrics = {}
    for entry, mod in readers:
        value = mod.read(run)
        if value is not None and math.isfinite(value):
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    del state
    ctx.graph = ctx.pack = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    checks = check(root, ctx, window)
    result = {
        "correct": not fails(checks),
        "attempted": len(window.items),
        "failed": sum(not it["ok"] for it in window.items),
        "metrics": metrics,
        "device": device_record(ctx.device, cell["chips"], peak, summary),
    }
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def device_record(dev, chips: int, peak: int, summary) -> dict:
    import torch

    rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if summary is not None:
        rec["busy_s"] = summary.busy_s
        rec["window_s"] = summary.window_s
    return rec
