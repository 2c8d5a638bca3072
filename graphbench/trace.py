"""The traced run: `torch.profiler` over the measured window, the benchmark's
own spans, and a record of the arguments of chosen kernel calls.

Spans are `record_function` ranges named `gb.<what>` that the drivers open
around their calls into the port; outside a traced run they cost nothing.
`summarize` reduces the profiler's events to what the metric readers and the
result's `device` and `breakdown` need: device busy time within the window,
device time by operation name, and the idle gaps labelled by what the host
was doing (the innermost benchmark span and the innermost host operation
open at the middle of the gap).
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
from collections import defaultdict

import torch

WINDOW = "gb.window"
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: dict            # operation name -> seconds on the device
    idle_gaps: list           # [[label, seconds], ...] longest first
    calls: dict               # op name -> [(args...), ...] recorded calls

    def kernel_s(self, names) -> float:
        """Device seconds of the operations whose name contains one of
        `names`."""
        return sum(s for k, s in self.device_s.items() if any(x in k for x in names))

    def breakdown(self) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": self.idle_gaps[:TOP]}


def span(on: bool, name: str):
    """A `gb.<name>` range in a traced run, else nothing."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"gb.{name}")


@contextlib.contextmanager
def recording(wrap: dict, calls: dict):
    """For each `name -> record` of `wrap`, keep `record(args, kwargs)` of
    every call into `repro_torch.kernels.ops.<name>` in `calls[name]` (the
    engines look the functions up on the module at each call); restored on
    exit."""
    from repro_torch.kernels import ops

    saved = {name: getattr(ops, name) for name in wrap}

    def wrapped(name, fn):
        log, record = calls.setdefault(name, []), wrap[name]

        def recorded(*args, **kwargs):
            log.append(record(args, kwargs))
            return fn(*args, **kwargs)

        return recorded

    for name, fn in saved.items():
        setattr(ops, name, wrapped(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def profiler():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _events(prof):
    """(device, name, start_ns, end_ns) of every event the profiler kept."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        if dev and name.startswith("gb."):
            continue                    # a host range drawn on the device's timeline
        start = e.start_ns()
        out.append((dev, name, start, start + e.duration_ns()))
    return out


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(events, times):
    """For each sorted time, the name of the latest-starting event that is
    open then, or None."""
    events = sorted(events, key=lambda e: e[2])
    heap, out, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][2] <= t:
            heapq.heappush(heap, (-events[i][2], events[i][3], events[i][1]))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def summarize(prof, calls: dict) -> Trace:
    events = _events(prof)
    window = [e for e in events if not e[0] and e[1] == WINDOW]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = window[0][2], window[0][3]
    device = [e for e in events if e[0] and e[3] > w0 and e[2] < w1]
    device_s = defaultdict(float)
    for _, name, a, b in device:
        device_s[name] += (min(b, w1) - max(a, w0)) / 1e9
    busy = _merge((max(a, w0), min(b, w1)) for _, _, a, b in device)
    busy_ns = sum(b - a for a, b in busy)
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    mids = sorted((a + b) // 2 for a, b in gaps)
    host = [e for e in events if not e[0] and e[1] != WINDOW]
    spans = _innermost([e for e in host if e[1].startswith("gb.")], mids)
    ops = _innermost([e for e in host if not e[1].startswith("gb.")], mids)
    label_of = {m: f"{s or 'no span'} / {o or 'no host op'}" for m, s, o in zip(mids, spans, ops)}
    idle = defaultdict(float)
    for a, b in gaps:
        idle[label_of[(a + b) // 2]] += (b - a) / 1e9
    idle_gaps = [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])]
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9, device_s=dict(device_s),
                 idle_gaps=idle_gaps, calls=calls)
