"""Fault tolerance & straggler mitigation for long-running multi-pod jobs.

Port of `repro.distributed.fault`, host-side Python as in the reference.

Pieces (all exercised by tests and launch/train.py):
  * StepWatchdog     — EMA step-time tracking; steps slower than
                       `straggler_factor` x EMA are counted and logged
                       (on a real fleet this feeds the reschedule policy;
                       here it also powers the straggler test).
  * Heartbeat        — periodic liveness file with step + timestamp; an
                       external supervisor restarts ranks whose heartbeat
                       goes stale.
  * PreemptionGuard  — SIGTERM handler that requests a final checkpoint and
                       clean exit (preemption semantics; `install` works
                       on the main thread only, as `signal.signal` does).
  * SkippableIterator— wraps the data iterator; on shard failure, skips to
                       the next shard instead of stalling the job.
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Callable, Iterator, Optional


class StepWatchdog:
    def __init__(self, straggler_factor: float = 3.0, ema: float = 0.9):
        self.factor = straggler_factor
        self.ema_coeff = ema
        self.ema_time: Optional[float] = None
        self.stragglers = 0
        self.steps = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> bool:
        """Returns True when the step was a straggler."""
        dt = time.monotonic() - self._t0
        self.steps += 1
        is_straggler = (
            self.ema_time is not None and dt > self.factor * self.ema_time
        )
        if is_straggler:
            self.stragglers += 1
        else:
            # stragglers don't poison the EMA
            self.ema_time = (
                dt if self.ema_time is None
                else self.ema_coeff * self.ema_time + (1 - self.ema_coeff) * dt
            )
        return is_straggler

    def summary(self) -> dict:
        return {
            "steps": self.steps,
            "stragglers": self.stragglers,
            "ema_step_time_s": self.ema_time,
        }


class Heartbeat:
    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval = interval_s
        self._last = 0.0

    def beat(self, step: int, **extra):
        now = time.monotonic()
        if now - self._last < self.interval:
            return
        self._last = now
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "wall": time.time(), **extra}, f)
        os.replace(tmp, self.path)


class PreemptionGuard:
    """SIGTERM -> set flag; the train loop checkpoints and exits cleanly."""

    def __init__(self):
        self.preempted = False
        self._orig = None

    def install(self):
        def handler(signum, frame):
            self.preempted = True

        self._orig = signal.signal(signal.SIGTERM, handler)
        return self

    def uninstall(self):
        if self._orig is not None:
            signal.signal(signal.SIGTERM, self._orig)


class SkippableIterator:
    """Yields from `make_shard_iter(shard_id)`; a raising shard is skipped and
    counted rather than stalling training (straggler/failed-host mitigation
    for the input pipeline)."""

    def __init__(self, make_shard_iter: Callable[[int], Iterator], n_shards: int):
        self.make = make_shard_iter
        self.n = n_shards
        self.shard = 0
        self.skipped = []
        self._it = None

    def __iter__(self):
        return self

    def __next__(self):
        for _ in range(self.n + 1):
            try:
                if self._it is None:
                    self._it = self.make(self.shard)
                return next(self._it)
            except StopIteration:
                self.shard = (self.shard + 1) % self.n
                self._it = None
            except Exception:
                self.skipped.append(self.shard)
                self.shard = (self.shard + 1) % self.n
                self._it = None
        raise StopIteration
