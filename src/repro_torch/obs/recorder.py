"""Flight recorder: an always-cheap bounded ring buffer of host-side events.

Port of `repro.obs.recorder`, unchanged: the ring holds host dicts only.

The recorder answers the question "what was the scheduler doing in the
seconds before this crash / drop storm / flake?" — a post-mortem timeline,
not a metrics system.  Contracts (DESIGN.md §14):

  * **Host-only.**  Recording an event is a deque append of a small dict;
    it never reads device memory, so an armed recorder on a
    telemetry-disabled server stays transfer-free (``obs.TRANSFER_COUNT``
    unchanged) and bit-neutral.  Events that *derive from* device
    counters (``mode_switch``, ``compact_overflow``) therefore only appear
    when telemetry is also enabled.
  * **Bounded.**  The ring holds at most ``capacity`` events; old events
    fall off the front.  ``seq`` keeps counting monotonically so a dump
    shows how many events were lost ("seq jumps 120 -> 9000" == storm).
  * **Post-mortem export.**  ``dump()`` writes one JSON object per line
    (validated by ``scripts/trace_schema.py --flight``); every line carries
    ``t`` (seconds since the recorder was armed), ``seq`` and ``kind``.

A process-global recorder (armed by the ``REPRO_FLIGHT_RECORD`` env var, or
explicitly via :func:`arm_global`) lets code that never sees a
``GraphServer`` — the streaming refresh path, the residual-flake test —
drop events into the same timeline.  ``Observability`` adopts the global
recorder when no per-server one is configured, so scheduler and streaming
events interleave in one dump.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Optional

# Canonical event taxonomy (DESIGN.md §14).  scripts/trace_schema.py
# validates dumped records against this set; keep the two in sync via the
# import in that script.
EVENT_KINDS = frozenset({
    "admit",            # lane admission (payload: rid, algo, lane, batched)
    "resume",           # preempted lane re-admitted from residual state
    "harvest",          # lane completed and was freed (payload: rid, iters)
    "preempt",          # SLO policy evicted a running lane
    "drop",             # request dropped (expired / hopeless / shed)
    "degrade",          # ppr_delta tolerance degraded under pressure
    "mode_switch",      # consensus flipped push<->pull (telemetry only)
    "compact_overflow", # compacted edge scan fell back to dense (telemetry)
    "update_swap",      # apply_updates swapped the graph version
    "cache_hit",        # request served from the result cache
    "crash",            # lane still owned after drain / harvest wedge
    "drain_stuck",      # drain() hit its pump budget without converging
    "imbalance",        # per-shard scan-volume summary (emitted at dump)
    "stream_apply",     # StreamingGraph absorbed an update batch
    "incremental",      # incremental_batch chose a refresh mode
    "flake_dump",       # residual-flake handler captured state
})


class FlightRecorder:
    """Bounded ring of ``{"t", "seq", "kind", ...payload}`` event dicts."""

    def __init__(self, capacity: int = 4096, clock=time.monotonic):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._clock = clock
        self._epoch = clock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def seq(self) -> int:
        """Total events ever recorded (>= len(self) once the ring wraps)."""
        return self._seq

    def record(self, kind: str, **payload) -> None:
        ev = {"t": self._clock() - self._epoch, "seq": self._seq,
              "kind": kind}
        ev.update(payload)
        self._seq += 1
        self._ring.append(ev)

    def events(self) -> list:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def dump(self, path: str) -> int:
        """Write the ring to ``path`` as JSONL; returns events written."""
        evs = self.events()
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
        return len(evs)


# --------------------------------------------------------------------------
# process-global recorder (flake path, streaming refresh)

GLOBAL: Optional[FlightRecorder] = None


def arm_global(capacity: int = 4096) -> FlightRecorder:
    """Create (or return) the process-global recorder."""
    global GLOBAL
    if GLOBAL is None:
        GLOBAL = FlightRecorder(capacity=capacity)
    return GLOBAL


def record_global(kind: str, **payload) -> None:
    """Record into the global ring if armed; free when it is not."""
    if GLOBAL is not None:
        GLOBAL.record(kind, **payload)


def dump_global(path: str) -> int:
    """Dump the global ring to ``path``; returns events written (0 if
    unarmed — still writes an empty file so callers can ship the path)."""
    if GLOBAL is None:
        open(path, "w").close()
        return 0
    return GLOBAL.dump(path)


if os.environ.get("REPRO_FLIGHT_RECORD"):
    arm_global()
