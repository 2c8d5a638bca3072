"""Render trace + flight-record JSONL into a human-readable obs report.

Port of `repro.launch.obs_report` (host only: JSONL in, text out; the same
report line for line). Post-mortem companion to the serving CLIs
(DESIGN.md §14): feed it the artifacts a run left behind —

  PYTHONPATH=src python -m repro_torch.launch.slo_replay \\
      --trace t.jsonl --flight-record f.jsonl
  PYTHONPATH=src python -m repro_torch.launch.obs_report \\
      --trace t.jsonl --flight f.jsonl

— and it prints, per algorithm, the request-lifecycle summary (latency
percentiles, queue-wait vs resident split, push/pull mode mix, frontier
volume spread), then walks the flight record: event counts by kind, a
per-phase timeline (phases are delimited by `update_swap` events, i.e.
graph-version epochs), and the per-shard workload-imbalance summary the
scheduler appends at dump time (`imbalance` events: raw shard scan volumes
plus the max/mean skew ratio). Either input is optional; the report renders
whatever it is given.
"""

from __future__ import annotations

import argparse
import json
from collections import Counter, defaultdict
from typing import List, Optional

import numpy as np


def _load_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _pct(samples: List[float]) -> Optional[dict]:
    if not samples:
        return None
    arr = np.asarray(samples, np.float64)
    return {"n": arr.size, "mean": float(arr.mean()),
            "p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)),
            "p99": float(np.percentile(arr, 99))}


def _ms(block: dict) -> str:
    return (f"p50={block['p50'] * 1e3:.1f}ms p95={block['p95'] * 1e3:.1f}ms "
            f"p99={block['p99'] * 1e3:.1f}ms (n={block['n']})")


def report_trace(spans: List[dict]) -> None:
    print(f"== trace: {len(spans)} spans ==")
    by_algo = defaultdict(list)
    for s in spans:
        by_algo[s.get("algo", "?")].append(s)
    for algo in sorted(by_algo):
        group = by_algo[algo]
        total = _pct([s["durations"]["total_s"] for s in group])
        queue = _pct([s["durations"]["queue_wait_s"] for s in group])
        resident = _pct([s["durations"]["resident_s"] for s in group])
        cache = sum(bool(s.get("from_cache")) for s in group)
        dropped = sum(bool((s.get("slo") or {}).get("dropped"))
                      for s in group)
        modes = Counter(it.get("mode", "?")
                        for s in group for it in s.get("iters", ()))
        frontiers = [it["frontier"] for s in group
                     for it in s.get("iters", ()) if "frontier" in it]
        print(f"  {algo}: {len(group)} spans "
              f"({cache} cache hits, {dropped} dropped)")
        if total:
            print(f"    total    {_ms(total)}")
            print(f"    queue    {_ms(queue)}")
            print(f"    resident {_ms(resident)}")
        if modes:
            mix = ", ".join(f"{k}={v}" for k, v in sorted(modes.items()))
            print(f"    iterations: {sum(modes.values())} ({mix})")
        if frontiers:
            f = _pct([float(x) for x in frontiers])
            print(f"    frontier volumes: p50={f['p50']:.0f} "
                  f"p95={f['p95']:.0f} max={max(frontiers)}")


def report_flight(events: List[dict]) -> None:
    print(f"== flight record: {len(events)} events ==")
    if not events:
        print("  (empty — recorder was unarmed or ring was cleared)")
        return
    seqs = [e.get("seq", 0) for e in events]
    lost = (seqs[-1] - seqs[0] + 1) - len(events)
    if lost > 0:
        print(f"  ring wrapped: {lost} events lost "
              f"(seq {seqs[0]}..{seqs[-1]})")
    kinds = Counter(e.get("kind", "?") for e in events)
    mix = ", ".join(f"{k}={v}" for k, v in kinds.most_common())
    print(f"  by kind: {mix}")

    # phase timeline: one epoch per graph version, split at update_swap
    phases: List[dict] = [{"version": None, "t0": events[0].get("t", 0.0),
                           "kinds": Counter()}]
    for e in events:
        if e.get("kind") == "update_swap":
            phases.append({"version": e.get("version"),
                           "t0": e.get("t", 0.0), "kinds": Counter()})
            continue
        phases[-1]["kinds"][e.get("kind", "?")] += 1
    if len(phases) > 1 or phases[0]["kinds"]:
        print("  phases (split at update_swap):")
        last_t = events[-1].get("t", 0.0)
        for i, ph in enumerate(phases):
            t1 = phases[i + 1]["t0"] if i + 1 < len(phases) else last_t
            ver = "v?" if ph["version"] is None and i == 0 else \
                f"v{ph['version']}" if ph["version"] is not None else "v?"
            if i == 0:
                ver = "initial"
            mix = ", ".join(f"{k}={v}"
                            for k, v in sorted(ph["kinds"].items()))
            print(f"    [{i}] {ver} t={ph['t0']:.3f}..{t1:.3f}s: "
                  f"{mix or '(no events)'}")

    imb = [e for e in events if e.get("kind") == "imbalance"]
    if imb:
        print("  workload imbalance (per-shard scan volumes at dump):")
        for e in imb:
            edges = e.get("shard_edges", [])
            skew = e.get("skew", 0.0)
            tag = (" <- SKEWED" if isinstance(skew, (int, float))
                   and skew >= 2.0 else "")
            print(f"    {e.get('pool', '?')}: skew={skew:.2f} "
                  f"shard_edges={edges}{tag}")
    drops = kinds.get("drop", 0) + kinds.get("preempt", 0)
    crash = kinds.get("crash", 0) + kinds.get("drain_stuck", 0)
    if crash:
        print(f"  !! {crash} crash/drain_stuck event(s) — inspect the tail "
              f"of the dump")
    elif drops:
        print(f"  note: {drops} drop/preempt event(s) under SLO pressure")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", default="",
                    help="request-trace JSONL (serve_graph/slo_replay "
                         "--trace output)")
    ap.add_argument("--flight", default="",
                    help="flight-record JSONL (--flight-record output)")
    args = ap.parse_args(argv)
    if not args.trace and not args.flight:
        ap.error("give at least one of --trace / --flight")
    if args.trace:
        report_trace(_load_jsonl(args.trace))
    if args.flight:
        report_flight(_load_jsonl(args.flight))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
