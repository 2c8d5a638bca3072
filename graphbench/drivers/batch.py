"""Closed loop of batches: `batch` sources at a time through
`repro_torch.serving.batch_engine.run_batch` (the vertex-major batched
engine), one batch after another. The engine config is the serving default
(`serving.default_config`).

The configuration's pool of `batches` batches is fixed, grouping and all:
the seed orders the batches and the lanes within each. A batch runs until
its slowest lane converges, so a grouping that the seed drew would change
the work (3.4 % between seeds, PERF.md). The window ends with the pass over
the pool that ends after `seconds`, so every run does whole passes.

Mix parameters: `program`, `batch`, `batches`, `check_queries` (answers
compared; one seeded lane of every batch is kept, and that many of them
drawn after the window).
"""

from __future__ import annotations

import random
import time

from graphbench import gen
from graphbench.harness import Window
from graphbench.programs import pick, program, result_field


def warm(ctx):
    from repro_torch.serving import batch_engine as B
    from repro_torch.serving import default_config

    t, g = ctx.traffic, ctx.graph
    cfg = default_config(g)
    prog = program(t, t["program"])
    q = t["batch"]
    B.run_batch(prog, g, ctx.pack, cfg,                    # the batch's shapes
                gen.sources(ctx.edges, q, ctx.seed, salt=8))
    return {"cfg": cfg, "prog": prog, "batches": batches(ctx)}


def batches(ctx) -> list:
    """The pool's fixed batches, in the seed's order, lanes shuffled."""
    t = ctx.traffic
    q = t["batch"]
    fixed = gen.pool(ctx.edges, q * t["batches"], salt=2)
    groups = [fixed[i * q:(i + 1) * q] for i in range(t["batches"])]
    rng = random.Random(ctx.seed * 1_000_003 + 2)
    rng.shuffle(groups)
    for grp in groups:
        rng.shuffle(grp)
    return groups


def drive(ctx, st, seconds):
    from repro_torch.serving import batch_engine as B

    g, pack, cfg, prog = ctx.graph, ctx.pack, st["cfg"], st["prog"]
    q, pool, field = ctx.traffic["batch"], st["batches"], result_field(prog)
    rng = random.Random(ctx.seed)
    items, steps, kept = [], [], []
    t0 = now = time.perf_counter()
    b = 0
    while now - t0 < seconds or b % len(pool):
        batch = pool[b % len(pool)]
        b += 1
        a = time.perf_counter()
        with ctx.span("batch"):
            m, stats = B.run_batch(prog, g, pack, cfg, batch)
            lane = rng.randrange(q)
            kept.append((batch[lane], m[field][:-1, lane].clone()))
            ctx.sync()
        now = time.perf_counter()
        items += [{"algo": prog.name, "source": s, "t_submit": a, "t_done": now, "ok": True}
                  for s in batch]
        steps.append(stats["iterations"])
        del m, stats
    return Window(seconds=now - t0, items=items, counters={"steps": steps},
                  outputs=kept)


def finish(ctx, st, win):
    steps = [int(s) for s in win.counters["steps"]]
    win.counters["steps"] = sum(steps)
    win.notes = {"batches": len(steps), "steps": steps}
    name = st["prog"].name
    win.outputs = [(name, s, r) for s, r in
                   pick(ctx.seed, 2, win.outputs, ctx.traffic["check_queries"])]


def control_sources(ctx) -> list:
    """(algo, source) of as many answers as a run compares, for the control:
    the first `check_queries` sources of the window's list."""
    t = ctx.traffic
    lanes = [s for grp in batches(ctx) for s in grp]
    return [(t["program"], s) for s in lanes[:t["check_queries"]]]
