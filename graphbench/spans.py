"""The program's own ranges in a traced run: `repro_torch.obs.region` opens a
`simdx.*` range around each solo push, pull and control-flow read, each
batched step's combine and apply, and each served admission, pool step and
harvest, while a `torch.profiler` records.

`summarize` reduces the profiler's events to one row a range name: how many,
their host seconds, their self seconds (host seconds less the part that
nested `simdx.*` ranges cover), the device seconds of the operations
launched inside them, and their device-to-host copies. A device operation
belongs to the innermost range open when the host call that launched it
began. The profiler links a device operation to that call (`cudaLaunch*`,
`cudaMemcpy*`) by correlation id; where a trace lacks the link, the
operation's linked id names the host operation that launched it instead,
and the row says which method it took.

`readings` turns a summary into the quantities a per-layer metric would
read. No metric of `BENCHMARK.json` reads them yet: the harness keeps no
profiler for its readers (`graphbench/trace.py`) and the serve driver keeps
no queue counter (`drivers/serve_closed.py`), files that only a benchmark
change may edit. Until then a traced run of a cell reports them:

    python3 graphbench/spans.py --workload <name> --seed <n> --seconds <s>

prints the harness's result line of a traced run, then one JSON line with
the summary, the readings and the cell's end-to-end metrics read from the
same traced window.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PREFIX = "simdx."
WINDOW = "gb.window"


@dataclasses.dataclass(frozen=True)
class Event:
    """What `summarize` reads of one profiler event."""

    dev: bool             # on a device's timeline
    name: str
    start: int            # ns, the profiler's clock
    end: int
    corr: int = 0         # correlation id
    linked: int = 0       # a device event's link to the host operation that launched it
    annotation: bool = False


def events_of(prof) -> list:
    """Every event a `torch.profiler.profile` kept, as `Event`s."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append(Event(dev=e.device_type() != torch.autograd.DeviceType.CPU,
                         name=e.name(), start=start, end=start + e.duration_ns(),
                         corr=e.correlation_id(),
                         linked=e.linked_correlation_id(),
                         annotation=e.is_user_annotation()))
    return out


def _is_call(e: Event) -> bool:
    """A host call into CUDA's runtime or driver API (`cudaLaunchKernel`,
    `cuLaunchKernel`, `cudaMemcpyAsync`, ...), by name: torch 2.11's events
    do not give their activity type."""
    return not e.dev and e.name.startswith("cu")


def _nest(spans: list) -> list:
    """The index of each span's parent (the innermost span that holds it),
    or -1; spans of one thread nest, so a stack finds it."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i].start, -spans[i].end))
    parent, stack = [-1] * len(spans), []
    for i in order:
        while stack and spans[stack[-1]].end <= spans[i].start:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    return parent


def _innermost(spans: list, starts: list, parent: list, t: int) -> int:
    """The index of the innermost span open at `t`, or -1: the latest span
    to start by `t` or, where it has ended, its nearest open ancestor."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and spans[i].end <= t:
        i = parent[i]
    return i


def summarize(events: list) -> dict:
    """The `simdx.*` rows of a trace: {"spans": {name: {"count", "host_s",
    "self_s", "device_s", "dtoh"}}, "device_s": device seconds of every
    operation in the window, "outside_s": those launched outside every
    range, "links": how many device operations each method attributed}.
    The window is the `gb.window` range where the trace has one, else the
    whole trace; device times are clipped to it, and a device-side copy of
    a host range (a user annotation) is not an operation."""
    window = [e for e in events if not e.dev and e.name == WINDOW]
    if window:
        w0, w1 = window[0].start, window[0].end
    else:
        w0 = min((e.start for e in events), default=0)
        w1 = max((e.end for e in events), default=0)
    spans = sorted((e for e in events if not e.dev and e.name.startswith(PREFIX)),
                   key=lambda e: (e.start, -e.end))
    starts = [e.start for e in spans]
    parent = _nest(spans)
    rows = defaultdict(lambda: {"count": 0, "host_s": 0.0, "self_s": 0.0,
                                "device_s": 0.0, "dtoh": 0})
    for i, s in enumerate(spans):
        row = rows[s.name]
        row["count"] += 1
        row["host_s"] += (s.end - s.start) / 1e9
        row["self_s"] += (s.end - s.start) / 1e9
        if parent[i] >= 0:
            rows[spans[parent[i]].name]["self_s"] -= (s.end - s.start) / 1e9

    # id 0 is no id
    call_at = {e.corr: e.start for e in events if e.corr and _is_call(e)}
    op_at = {e.corr: e.start for e in events if e.corr and not e.dev and not _is_call(e)}
    links = {"correlation": 0, "external id": 0, "none": 0}
    device_s = outside_s = 0.0
    for e in events:
        if not e.dev or e.annotation or e.end <= w0 or e.start >= w1:
            continue
        sec = (min(e.end, w1) - max(e.start, w0)) / 1e9
        device_s += sec
        if e.corr in call_at:
            t, how = call_at[e.corr], "correlation"
        elif e.linked in op_at:
            t, how = op_at[e.linked], "external id"
        else:
            links["none"] += 1
            outside_s += sec
            continue
        links[how] += 1
        i = _innermost(spans, starts, parent, t)
        if i < 0:
            outside_s += sec
            continue
        row = rows[spans[i].name]
        row["device_s"] += sec
        row["dtoh"] += "DtoH" in e.name
    return {"spans": {k: rows[k] for k in sorted(rows)}, "device_s": device_s,
            "outside_s": outside_s, "links": links}


def _ratio(num, den, scale=1.0):
    return scale * num / den if den else None


def readings(summary: dict, rounds: int = 0, queue=None) -> dict:
    """The per-layer quantities the ranges give, None where the trace has
    no such range, and the device's where it has no device time (a CPU
    run): `rounds` is the window's pump rounds, `queue` the served window's
    `stats()["queue"]`."""
    rows = summary["spans"]
    empty = {"count": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0, "dtoh": 0}

    def row(name):
        return rows.get(f"simdx.{name}", empty)

    iters = row("engine.push")["count"] + row("engine.pull")["count"]
    on_device = summary["device_s"] > 0
    reads = sum(row(f"engine.{k}")["dtoh"] for k in ("push", "pull", "read"))
    served = [row(f"serve.{k}") for k in ("admit", "step", "harvest")]
    return {
        # % of the window's device seconds launched inside a solo push
        "push_device_share": _ratio(row("engine.push")["device_s"],
                                    summary["device_s"], 100.0) if iters else None,
        # device-to-host copies inside the solo engine's ranges an iteration
        "host_syncs_per_iter": _ratio(reads, iters) if on_device else None,
        # device ms of a batched step's apply (one a step)
        "apply_device_ms": _ratio(row("batch.apply")["device_s"],
                                  row("batch.apply")["count"], 1e3) if on_device else None,
        # host ms of one admission
        "admit_ms": _ratio(row("serve.admit")["host_s"], row("serve.admit")["count"], 1e3),
        # the harvest's own host ms a pump round (its reads, which wait for
        # the step, left out)
        "harvest_ms": _ratio(row("serve.harvest")["self_s"], rounds, 1e3)
        if row("serve.harvest")["count"] else None,
        # mean ms a request waited in the queue before a lane took it
        "queue_wait_ms": _ratio(queue["wait_s"], queue["admitted"], 1e3) if queue else None,
        # host ms a pump round inside the served ranges (admission, step,
        # harvest)
        "serve_spans_ms": _ratio(sum(r["host_s"] for r in served), rounds, 1e3)
        if served[0]["count"] else None,
    }


@contextlib.contextmanager
def _captured(out: dict):
    """For one traced run of the harness: keep the profiler's events (`trace.
    summarize`), the readers' `Run` (`harness.Run`) and the last served
    `stats()`; restored on exit."""
    from graphbench import harness, trace
    from repro_torch.serving import scheduler

    summarize0, run0, stats0 = trace.summarize, harness.Run, scheduler.GraphServer.stats

    def summarized(prof, calls):
        out["events"] = events_of(prof)
        return summarize0(prof, calls)

    def run(*args, **kwargs):
        out["run"] = run0(*args, **kwargs)
        return out["run"]

    def stats(self):
        out["stats"] = stats0(self)
        return out["stats"]

    trace.summarize, harness.Run, scheduler.GraphServer.stats = summarized, run, stats
    try:
        yield out
    finally:
        trace.summarize, harness.Run, scheduler.GraphServer.stats = summarize0, run0, stats0


def main(argv=None) -> int:
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from graphbench import harness

    got: dict = {}
    with _captured(got):
        result = harness.run_cell(args.workload, args.seed, args.seconds, True,
                                  args.device, t_start)
    print(json.dumps(result), flush=True)
    run = got["run"]
    summary = summarize(got["events"])
    queue = got.get("stats", {}).get("queue")
    pump = run.window.spans.get("pump", [])
    bench = harness.load_benchmark(ROOT)
    e2e = {}
    for m in harness.metrics_of(bench, args.workload, False):
        value = harness.module(ROOT, "metrics", m["name"]).read(run)
        if value is not None:
            e2e[m["name"]] = value
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "readings": readings(summary, len(pump), queue),
                      "pump_ms": _ratio(sum(pump), len(pump), 1e3), "queue": queue,
                      "traced_end_to_end": e2e, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
