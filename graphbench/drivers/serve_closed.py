"""Closed loop of `clients` callers against one `repro_torch.serving.
GraphServer`: each caller submits its next query when its reply arrives.
Queries take the mix's algorithms in turn; a source is one of a seeded hot
set with probability `hot_frac`, else any vertex of nonzero degree (the
request-stream arithmetic of `chip_smoke.py::serve_stream`, drawn here from
the benchmark's seed). The window is `seconds` long: no query is submitted
after it closes, and those still out are served to the end (a minute at
most), so each query of the window has a latency.

A request is timed from `submit` to the return of the `pump` round that
harvested it (a cache hit: to the return of its `submit`).

Mix parameters: `algos`, `slots` (lanes a pool), `cache` (result cache
entries), `queue_cap`, `clients`, `hot_set`, `hot_frac`, `stream` (length of
the seeded request list), `check_rate` (the share of requests, at seeded
indices, whose answers are kept: a host copy of 4 n bytes each),
`check_requests` (how many kept answers are compared, drawn from the seed
after the window, an equal share of each algorithm) and `check_hits` (the
first cache hits of each algorithm, compared as well).
"""

from __future__ import annotations

import random
import time

from graphbench import gen
from graphbench.harness import Window
from graphbench.programs import pick, program

#: seconds past the window's close in which the last queries may finish
DRAIN_S = 60.0


def requests(ctx) -> list:
    """The seeded (algo, source) stream."""
    t = ctx.traffic
    hot = gen.sources(ctx.edges, t["hot_set"], ctx.seed, salt=3)
    rest = gen.sources(ctx.edges, t["stream"], ctx.seed, salt=5)
    rng = random.Random(ctx.seed * 31 + 3)
    algos = t["algos"]
    return [(algos[i % len(algos)],
             rng.choice(hot) if rng.random() < t["hot_frac"] else rest[i])
            for i in range(t["stream"])]


def server(ctx, st):
    from repro_torch.serving import GraphServer

    t = ctx.traffic
    return GraphServer(ctx.graph, ctx.pack, st["progs"], slots=t["slots"], cfg=st["cfg"],
                       queue_cap=t["queue_cap"], cache_capacity=t["cache"])


def warm(ctx):
    """One full round of every pool on a server of the window's shape, with
    sources outside the window's stream; the window's server starts cold."""
    from repro_torch.serving import default_config

    t = ctx.traffic
    st = {"cfg": default_config(ctx.graph),
          "progs": {a: program(t, a) for a in t["algos"]},
          "stream": requests(ctx)}
    srv = server(ctx, st)
    warm_src = gen.sources(ctx.edges, t["slots"], ctx.seed, salt=4)
    for a in t["algos"]:
        for s in warm_src:
            if srv.submit(a, s) is None:
                raise RuntimeError("the warm-up met backpressure")
    srv.drain()
    return st


def drive(ctx, st, seconds):
    t = ctx.traffic
    srv = server(ctx, st)
    stream = st["stream"]
    keep = kept_indices(ctx)
    hits_kept = {a: 0 for a in t["algos"]}
    items, sent, outputs, pump_s = [], {}, {}, []

    def submit(now):
        i = len(items)
        algo, src = stream[i % len(stream)]
        item = {"algo": algo, "source": src, "t_submit": now, "t_done": None,
                "ok": False, "from_cache": False}
        items.append(item)
        rid = srv.submit(algo, src)
        if rid is None:
            item["t_done"] = now                 # refused: counts as failed
        else:
            sent[rid] = i

    def settle(now, open_):
        """Take every completion the server holds; each frees its caller,
        who submits again while the window is open."""
        while srv.completions:
            comps = list(srv.completions)
            srv.completions.clear()
            for c in comps:
                i = sent.pop(c.rid)
                item = items[i]
                item.update(t_done=now, ok=c.result is not None and not c.dropped,
                            from_cache=c.from_cache)
                kept = i in keep
                if not kept and c.from_cache and hits_kept[c.algo] < t["check_hits"]:
                    hits_kept[c.algo] += 1
                    kept = True
                if kept and c.result is not None:
                    outputs[i] = (c.algo, c.source, c.result)
                if open_:
                    submit(time.perf_counter())
                    now = items[-1]["t_submit"]

    t0 = time.perf_counter()
    close = t0 + seconds
    for _ in range(t["clients"]):
        submit(time.perf_counter())
    settle(time.perf_counter(), True)
    while sent:
        now = time.perf_counter()
        if now >= close + DRAIN_S:
            break
        with ctx.span("pump"):
            srv.pump()
        done = time.perf_counter()
        pump_s.append(done - now)
        settle(done, done < close)
    stats = srv.stats()
    for item in items:
        if item["t_done"] is None:
            item["t_done"] = float("inf")
    missing = sum(1 for i in keep if i < len(items) and i not in outputs)
    done_in = [it for it in items if it["t_done"] <= close]
    notes = {"rounds": len(pump_s), "pump_ms": 1e3 * sum(pump_s) / max(1, len(pump_s)),
             "hits": sum(it["from_cache"] for it in done_in),
             "done": {a: sum(it["algo"] == a for it in done_in) for a in t["algos"]},
             "steps": {a: stats["pools"][a]["steps"] for a in t["algos"]}}
    return Window(seconds=seconds, items=items, spans={"pump": pump_s},
                  counters={"t0": t0, "cache": stats["cache"]}, notes=notes,
                  outputs=[(i, *outputs[i]) for i in sorted(outputs)], missing=missing)


def kept_indices(ctx) -> set:
    t = ctx.traffic
    rng = random.Random(ctx.seed * 31 + 5)
    return {i for i in range(t["stream"]) if rng.random() < t["check_rate"]}


def sample(ctx, indexed: list) -> list:
    """The compared answers: of the (index, algo, ...) kept at the seeded
    indices, `check_requests` drawn from the seed, an equal share of each
    algorithm; the kept cache hits besides."""
    t = ctx.traffic
    keep = kept_indices(ctx)
    share = t["check_requests"] // len(t["algos"])
    out = [x for x in indexed if x[0] not in keep]
    for k, algo in enumerate(t["algos"]):
        out += pick(ctx.seed, 10 + k, [x for x in indexed if x[0] in keep and x[1] == algo],
                    share)
    return sorted(out)


def finish(ctx, st, win):
    win.outputs = [x[1:] for x in sample(ctx, win.outputs)]


def control_sources(ctx) -> list:
    """(algo, source) of as many requests as a run compares, drawn as a run
    draws them from the kept indices, for the control."""
    stream = requests(ctx)
    indexed = [(i, *stream[i]) for i in sorted(kept_indices(ctx))]
    return [x[1:] for x in sample(ctx, indexed)]
