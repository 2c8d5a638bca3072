"""Request-lifecycle tracing: one span per `GraphServer.submit`; and the
program's ranges on the profiler's timeline (`region`).

Port of `repro.obs.trace`: spans are host records. Two additions: the
recorder also reads its epoch on the wall clock that `torch.profiler`
stamps with (`epoch_unix_ns`), so a lifecycle stamp lays over a device
trace; and `region(name)` opens a `simdx.*` range while a profiler records.

A span walks the request through the serving stack's stations (DESIGN.md
§12):

    submit -> admit -> harvest -> complete          (engine-served)
    submit -> complete                              (cache hit)

Timestamps are `time.monotonic()` relative to the recorder's epoch, so a
trace file is self-consistent regardless of wall-clock adjustments. On
completion the recorder derives the lifecycle durations —

    queue_wait_s = admit - submit       (bounded FIFO + quota wait)
    resident_s   = harvest - admit      (iterations resident in a lane)
    total_s      = complete - submit

— and attaches the per-iteration engine telemetry the scheduler harvested
from the mode-trace machinery: executed push/pull mode, the lane's
post-iteration frontier size, and the pool's union-frontier edge volume
(`iters` below). The span is emitted as ONE JSON line:

    {"trace_id": "g0-000017", "rid": 23, "algo": "bfs", "source": 4,
     "tenant": "default", "graph_version": 0, "from_cache": false,
     "events": {"submit": 0.0012, "admit": 0.0014, "harvest": 0.0191,
                "complete": 0.0191},
     "durations": {"queue_wait_s": 0.0002, "resident_s": 0.0177,
                   "total_s": 0.0179},
     "iterations": 7,
     "iters": [{"mode": "push", "frontier": 2, "union_fe": 11}, ...]}

`iters` may be shorter than `iterations` when the engine's bounded mode
trace (cfg.trace_len) or the pool's bounded iteration log truncated —
validators must accept len(iters) <= iterations (scripts/trace_schema.py).

The recorder is a no-op when disabled: `begin/mark/complete` return
immediately, no span state is kept, nothing is written.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from collections import deque
from typing import Dict, List, Optional

import torch

MODE_NAMES = {0: "push", 1: "pull"}

_OFF = contextlib.nullcontext()


def region(name: str):
    """A range named `name` (a `simdx.*` name) on the timeline of a
    `torch.profiler` that is recording, else one shared no-op context.

    Nothing turns it on but a profiler someone else started: off the
    profiler a region costs one C call and a no-op `with`. The range is a
    host op on the profiler's clock (`_RecordFunctionFast`, function
    scope), so a device op belongs to the innermost region open when the
    host call that launched it began. Unlike a user-scope
    `record_function`, it draws no copy of itself on the device's
    timeline, where a trace reader would count it as device time."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


@dataclasses.dataclass
class Span:
    """One request's lifecycle record (host state only)."""

    trace_id: str
    rid: int
    algo: str
    source: int
    tenant: str
    graph_version: int
    from_cache: bool = False
    events: Dict[str, float] = dataclasses.field(default_factory=dict)
    iterations: int = 0
    iters: List[dict] = dataclasses.field(default_factory=list)
    #: SLO outcome (DESIGN.md §13), present only for requests that carried a
    #: deadline or were touched by policy: {"deadline_s": float|None,
    #: "deadline_missed"/"dropped"/"degraded"/"preempted": bool}
    slo: Optional[dict] = None

    def durations(self) -> dict:
        ev = self.events
        sub = ev.get("submit", 0.0)
        total = max(0.0, ev.get("complete", sub) - sub)
        queue_wait = max(0.0, ev.get("admit", sub) - sub)
        resident = max(0.0, ev.get("harvest", ev.get("admit", sub))
                       - ev.get("admit", sub))
        return {"queue_wait_s": queue_wait, "resident_s": resident,
                "total_s": total}

    def to_json(self) -> dict:
        rec = {
            "trace_id": self.trace_id,
            "rid": self.rid,
            "algo": self.algo,
            "source": self.source,
            "tenant": self.tenant,
            "graph_version": self.graph_version,
            "from_cache": self.from_cache,
            "events": {k: round(v, 9) for k, v in self.events.items()},
            "durations": {k: round(v, 9)
                          for k, v in self.durations().items()},
            "iterations": self.iterations,
            "iters": self.iters,
        }
        if self.slo is not None:   # absent pre-SLO field stays absent
            rec["slo"] = self.slo
        return rec


class TraceRecorder:
    """Span factory + JSONL sink with bounded in-memory retention.

    `sink` is a path or a writable text file object; None keeps spans only
    in the `finished` deque (the last `keep` completions), which is what
    `GraphServer.stats()` and the tests read. Disabled recorders do nothing
    at all.
    """

    def __init__(self, enabled: bool = True, sink=None, keep: int = 1024,
                 name: str = "g0"):
        self.enabled = enabled
        self.name = name
        self._epoch = time.monotonic()
        #: the same instant on the wall clock in ns, the clock that
        #: `torch.profiler` stamps its events with: a span time `t` lies at
        #: `epoch_unix_ns + t * 1e9` on a profiler's timeline
        self.epoch_unix_ns = time.time_ns()
        self._open: Dict[int, Span] = {}
        self.finished: deque = deque(maxlen=keep)
        self.emitted = 0
        self._file = None
        self._owns_file = False
        if enabled and sink is not None:
            if isinstance(sink, (str, bytes)):
                self._file = open(sink, "w")
                self._owns_file = True
            else:
                self._file = sink

    # -- lifecycle ----------------------------------------------------------

    def now(self) -> float:
        return time.monotonic() - self._epoch

    def since_epoch(self, t: Optional[float]) -> float:
        """A `time.monotonic()` stamp `t` as a span time (None: now)."""
        return self.now() if t is None else t - self._epoch

    def begin(self, rid: int, algo: str, source: int, tenant: str,
              graph_version: int, t: Optional[float] = None) -> Optional[Span]:
        """Open a span; `t` is the submit's `time.monotonic()` stamp
        where the caller took one (default: now)."""
        if not self.enabled:
            return None
        span = Span(
            trace_id=f"{self.name}-{rid:08d}", rid=rid, algo=algo,
            source=int(source), tenant=tenant,
            graph_version=int(graph_version),
        )
        span.events["submit"] = self.since_epoch(t)
        self._open[rid] = span
        return span

    def mark(self, rid: int, event: str, t: Optional[float] = None) -> None:
        if not self.enabled:
            return
        span = self._open.get(rid)
        if span is not None:
            span.events[event] = self.since_epoch(t)

    def complete(self, rid: int, *, from_cache: bool = False,
                 iterations: int = 0, iters: Optional[List[dict]] = None,
                 graph_version: Optional[int] = None,
                 slo: Optional[dict] = None) -> Optional[Span]:
        if not self.enabled:
            return None
        span = self._open.pop(rid, None)
        if span is None:
            return None
        span.from_cache = from_cache
        span.iterations = int(iterations)
        if iters is not None:
            span.iters = iters
        if graph_version is not None:
            span.graph_version = int(graph_version)
        if slo is not None:
            span.slo = slo
        span.events["complete"] = self.now()
        self.finished.append(span)
        if self._file is not None:
            json.dump(span.to_json(), self._file)
            self._file.write("\n")
        self.emitted += 1
        return span

    def open_count(self) -> int:
        return len(self._open)

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        self.flush()
        if self._owns_file and self._file is not None:
            self._file.close()
            self._file = None

    def stats(self) -> dict:
        return {"emitted": self.emitted, "open": self.open_count(),
                "kept": len(self.finished), "epoch_unix_ns": self.epoch_unix_ns}


# ---------------------------------------------------------------------------
# shared CLI plumbing (serve_graph)
# ---------------------------------------------------------------------------

def add_obs_cli_args(ap, trace_help: Optional[str] = None) -> None:
    """Install the shared observability flags on an argparse parser.

    Every serving CLI gets the same trio: `--trace PATH` (lifecycle spans as
    JSON lines, implies telemetry), `--telemetry` (the §12 switch), and
    `--flight-record PATH` (arm the §14 flight recorder; its ring is dumped
    to PATH at exit and automatically on lane crash)."""
    ap.add_argument("--trace", default="",
                    help=trace_help or
                    "write per-request lifecycle spans (queue-wait / "
                    "resident / total + per-iteration push-pull modes and "
                    "frontier volumes) as JSON lines to this path; implies "
                    "--telemetry")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable the unified telemetry layer (engine "
                         "counters, lifecycle metrics, stats() obs section)")
    ap.add_argument("--flight-record", default="", metavar="PATH",
                    help="arm the flight recorder (bounded host-side event "
                         "ring: admits, harvests, drops, mode switches, "
                         "update swaps) and dump it to PATH at exit; "
                         "host-only, works with telemetry off")


def obs_from_cli(args, name: str = "g0"):
    """Build the `Observability` a CLI passes to GraphServer(obs=...).

    `--flight-record` arms the PROCESS-GLOBAL ring (not a private one) so
    scheduler events and the streaming-path `stream_apply`/`incremental`
    events land in a single interleaved timeline."""
    # late: repro_torch.obs imports this module
    from repro_torch.obs import Observability
    flight = None
    if getattr(args, "flight_record", ""):
        from repro_torch.obs import recorder
        flight = recorder.arm_global()
    return Observability(
        enabled=bool(getattr(args, "telemetry", False)) or bool(args.trace),
        trace=args.trace or None,
        flight=flight,
        name=name,
    )


def finish_obs_cli(srv, args, tag: str) -> None:
    """Shared CLI epilogue: close sinks, report spans, dump the flight ring."""
    srv.obs.close()
    if srv.obs.enabled:
        spans = srv.obs.tracer.stats()
        print(f"[{tag}] telemetry: {spans['emitted']} spans emitted"
              + (f" -> {args.trace}" if args.trace else ""))
    path = getattr(args, "flight_record", "")
    if path:
        n = srv.dump_flight_record(path)
        print(f"[{tag}] flight record: {n} events -> {path}")


def iters_from_trace(mode_row, counts, union_fes) -> List[dict]:
    """Assemble a span's per-iteration list from the harvested machinery:
    `mode_row` is the lane's mode-trace row (int8, -1 = unused slot),
    `counts`/`union_fes` are the pool iteration log's per-iteration
    post-step (frontier size, union volume) samples for this lane, possibly
    shorter than the executed iteration count (bounded log)."""
    out = []
    for i, m in enumerate(mode_row):
        m = int(m)
        if m < 0:
            break
        rec = {"mode": MODE_NAMES.get(m, str(m))}
        if i < len(counts) and counts[i] is not None:
            rec["frontier"] = int(counts[i])
        if i < len(union_fes) and union_fes[i] is not None:
            rec["union_fe"] = int(union_fes[i])
        out.append(rec)
    return out
