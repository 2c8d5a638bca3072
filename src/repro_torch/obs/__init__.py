"""`repro_torch.obs` — unified telemetry for the serving stack, port of
`repro.obs` (DESIGN.md §12, §14).

Five pieces, one enable switch:

  metrics.py  -- host-side registry: counters, gauges, fixed-bucket
                 histograms with interpolated p50/p95/p99 summaries.
  trace.py    -- request-lifecycle spans (submit -> admit -> harvest ->
                 complete) exported as JSON lines; `region`, the engines'
                 and the scheduler's `simdx.*` ranges on the timeline of a
                 `torch.profiler` that someone started (none otherwise).
  recorder.py -- flight recorder: a bounded ring of host-side scheduler
                 events with post-mortem JSONL export; host-only, so it may
                 be armed without the telemetry switch.
  health.py   -- streaming SLO health: P² latency quantiles + windowed
                 deadline-miss burn rate / goodput / queue-depth gauges.
  (engine)    -- the batched engine's cumulative `BatchState.tele` counters
                 (the TELE_* layout below) plus a trailing per-shard
                 scan-volume plane; the scheduler reads one packed vector a
                 pool step through :func:`device_fetch`.

Everything funnels through :class:`Observability`, which `GraphServer`
owns. Disabled (the default), every hook is a no-op, the engines carry
`tele=None`, and no telemetry transfer is issued: every telemetry read of
device state goes through :func:`device_fetch`, whose call counter
`TRANSFER_COUNT` is what an overhead guard pins.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.obs.metrics import (
    NOOP,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_count_buckets,
    default_latency_buckets,
)
from repro_torch.obs.trace import MODE_NAMES, Span, TraceRecorder, iters_from_trace, region
from repro_torch.obs import recorder as _recorder
from repro_torch.obs.health import HealthMonitor, P2Quantile
from repro_torch.obs.recorder import (
    EVENT_KINDS,
    FlightRecorder,
    arm_global,
    dump_global,
    record_global,
)

# ---------------------------------------------------------------------------
# engine telemetry accumulator layout (BatchState.tele)
# ---------------------------------------------------------------------------

#: edges expanded by push iterations (union volume clamped to the edge
#: budget, plus streaming-delta COO lanes)
TELE_PUSH_EDGES = 0
#: ELL/COO slots scanned by pull / dense-shard iterations
TELE_PULL_EDGES = 1
#: edge-sharded shard-iterations served from the frontier-compacted buffer
TELE_COMPACT_HITS = 2
#: light shard-iterations whose compaction buffer overflowed -> dense scan
TELE_COMPACT_DENSE = 3
#: masked-pull slice scans forced dense (cache invalid or row-buffer
#: overflow)
TELE_MASKED_DENSE = 4
#: masked-pull ELL rows actually recomputed (hot rows, or all rows on a
#: dense fallback)
TELE_MASKED_ROWS = 5
TELE_LEN = 6

# An enabled accumulator is (TELE_LEN + n_shards,) int64 (the reference's
# int32 wraps at RMAT scale 22): the named global counters above, then the
# per-shard scan-volume plane (cumulative push + pull edges scanned by each
# shard; one slot on a single device).

TELE_FIELDS = (
    "push_edges_scanned",
    "pull_edges_scanned",
    "compact_hits",
    "compact_dense_fallbacks",
    "masked_dense_fallbacks",
    "masked_rows_recomputed",
)

#: the serving stack's SLO outcome counters (kept by the scheduler)
SLO_FIELDS = ("deadline_missed", "dropped", "degraded", "preempted")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tele_dict(tele) -> dict:
    """Name the global counters of an accumulator vector (host ints); the
    per-shard plane is read by :func:`shard_plane`, so the keys are exactly
    TELE_FIELDS."""
    if tele is None:
        return {}
    vals = [int(x) for x in _host(tele)[:TELE_LEN]]
    return dict(zip(TELE_FIELDS, vals))


def shard_plane(tele) -> np.ndarray:
    """Per-shard cumulative scanned-edge plane of an accumulator (empty for
    a (TELE_LEN,) vector)."""
    if tele is None:
        return np.zeros((0,), np.int64)
    return _host(tele)[TELE_LEN:].astype(np.int64)


def skew_ratio(plane) -> float:
    """Workload skew: max/mean of per-shard scanned edges (1.0 = balanced;
    0.0 when nothing was scanned or the plane is empty)."""
    plane = np.asarray(plane, np.float64)
    if plane.size == 0:
        return 0.0
    mean = float(plane.mean())
    return float(plane.max() / mean) if mean > 0 else 0.0


# ---------------------------------------------------------------------------
# the device->host chokepoint
# ---------------------------------------------------------------------------

#: telemetry-initiated device->host transfers since import
TRANSFER_COUNT = 0


def device_fetch(x) -> np.ndarray:
    """Fetch one tensor to the host as a numpy array, counting the
    transfer."""
    global TRANSFER_COUNT
    TRANSFER_COUNT += 1
    return _host(x)


def host_flags(x: torch.Tensor) -> list:
    """The engine's control-flow read: one small packed tensor to a host
    list. The callers count it in `batch_engine.HOST_READS` by kind."""
    return x.tolist()


def host_copy(x: torch.Tensor) -> np.ndarray:
    """A plane to the host as a numpy array that owns its memory (a harvested
    result, a preempted lane, a streaming sweep's set)."""
    return x.detach().to("cpu", copy=True).numpy()


class Observability:
    """One switch, one registry, one trace recorder — what `GraphServer`
    threads through the serving stack. `trace` is a path or writable text
    file; passing one implies enabled.

    `flight` arms the flight recorder: pass a :class:`FlightRecorder`, or
    True for a fresh default-capacity ring. When unset, the process-global
    recorder (armed via REPRO_FLIGHT_RECORD / :func:`arm_global`) is
    adopted if present. The recorder is host-only and deliberately NOT tied
    to `enabled` — arming it on a telemetry-disabled server stays
    transfer-free and bit-neutral.

    `health` gates the streaming SLO monitor (defaults to `enabled`);
    `health_window_s` is its sliding-window width."""

    def __init__(self, enabled: bool = False, trace=None,
                 keep_spans: int = 1024, name: str = "g0",
                 flight=None, flight_capacity: int = 4096,
                 health: Optional[bool] = None,
                 health_window_s: float = 10.0):
        self.enabled = bool(enabled) or trace is not None
        self.registry = MetricsRegistry(enabled=self.enabled)
        self.tracer = TraceRecorder(enabled=self.enabled, sink=trace,
                                    keep=keep_spans, name=name)
        if isinstance(flight, FlightRecorder):
            self.flight: Optional[FlightRecorder] = flight
        elif flight:
            self.flight = FlightRecorder(capacity=flight_capacity)
        else:
            self.flight = _recorder.GLOBAL
        self.health = HealthMonitor(
            enabled=self.enabled if health is None else bool(health),
            window_s=health_window_s)

    def close(self) -> None:
        self.tracer.close()

    def snapshot(self) -> dict:
        if not self.enabled:
            return {"enabled": False}
        out = {
            "enabled": True,
            "metrics": self.registry.snapshot(),
            "spans": self.tracer.stats(),
            "health": self.health.snapshot(),
        }
        if self.flight is not None:
            out["flight"] = {"events": len(self.flight),
                             "seq": self.flight.seq,
                             "capacity": self.flight.capacity}
        return out


__all__ = [
    "Observability",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "NOOP",
    "TraceRecorder",
    "Span",
    "iters_from_trace",
    "region",
    "MODE_NAMES",
    "device_fetch",
    "tele_dict",
    "shard_plane",
    "skew_ratio",
    "FlightRecorder",
    "EVENT_KINDS",
    "arm_global",
    "record_global",
    "dump_global",
    "HealthMonitor",
    "P2Quantile",
    "default_latency_buckets",
    "default_count_buckets",
    "TELE_LEN",
    "TELE_FIELDS",
    "SLO_FIELDS",
    "TELE_PUSH_EDGES",
    "TELE_PULL_EDGES",
    "TELE_COMPACT_HITS",
    "TELE_COMPACT_DENSE",
    "TELE_MASKED_DENSE",
    "TELE_MASKED_ROWS",
]
