"""Closed loop, one client: for each root of the pool, each of the mix's
programs in turn through `repro_torch.core.engine.run` to its fixpoint
(Graph500's trial: kernel 2, BFS, then kernel 3, SSSP), one search after
another until the window has passed; the window ends with the trial that
crosses it, so every window holds as many searches of each program.

Mix parameters: `programs`, `engine` (EngineConfig fields besides the caps,
which are the whole graph: frontier_cap = n, edge_cap = m), `roots` (the
configuration's pool of search keys, cycled in the configuration's order:
every seed runs the same searches under its own vertex ids, since a window
covers only some of the keys and the work of a search turns on its key),
`check_roots` (roots whose answers are compared, drawn from the seed).
"""

from __future__ import annotations

import time

from graphbench import gen, reference
from graphbench.harness import Window
from graphbench.programs import pick, program, result_field


def warm(ctx):
    from repro_torch.core import engine as E

    t, g = ctx.traffic, ctx.graph
    cfg = E.EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges, **t["engine"])
    progs = [(name, program(t, name)) for name in t["programs"]]
    root = gen.sources(ctx.edges, 1, ctx.seed, salt=9)[0]
    for _, prog in progs:                       # every program's shapes, one root
        E.run(prog, g, ctx.pack, cfg, source=root)
    return {"cfg": cfg, "progs": progs,
            "roots": gen.pool(ctx.edges, t["roots"], salt=1)}


def drive(ctx, st, seconds):
    from repro_torch.core import engine as E
    from repro_torch.kernels import ops

    g, pack, cfg = ctx.graph, ctx.pack, st["cfg"]
    items = []
    launches = ops.launch_counts()
    t0 = now = time.perf_counter()
    k = 0
    while now - t0 < seconds:
        root = st["roots"][k % len(st["roots"])]
        k += 1
        for name, prog in st["progs"]:
            a = time.perf_counter()
            with ctx.span("search"):
                m, stats = E.run(prog, g, pack, cfg, source=root)
                ctx.sync()
            now = time.perf_counter()
            items.append({"algo": name, "source": root, "t_submit": a, "t_done": now,
                          "ok": True, "result": m[result_field(prog)],
                          "iters": stats["iterations"]})
    after = ops.launch_counts()
    return Window(seconds=now - t0, items=items,
                  counters={"launches": {k: after[k] - launches[k] for k in after}})


def finish(ctx, st, win):
    """After the window: each search's Graph500 edge count (input edges,
    self loops aside, inside the component it reached), its iterations, and
    the answers of `check_roots` seeded roots kept for the comparison."""
    e, n = ctx.edges, ctx.edges.n
    src = e.src[e.src != e.dst]
    for it in win.items:
        reached = it["result"][:n] < reference.UNREACHED
        it["edges"] = int(reached[src].sum())
        it["iters"] = int(it["iters"])
    roots = sorted({it["source"] for it in win.items})
    keep = set(pick(ctx.seed, 1, roots, ctx.traffic["check_roots"]))
    win.outputs = [(it["algo"], it["source"], it["result"][:n])
                   for it in win.items if it["source"] in keep]
    for it in win.items:
        del it["result"]
    win.notes = {a: {"searches": sum(it["algo"] == a for it in win.items),
                     "iterations": sum(it["iters"] for it in win.items if it["algo"] == a),
                     "seconds": sum(it["t_done"] - it["t_submit"] for it in win.items
                                    if it["algo"] == a)} for a in ctx.traffic["programs"]}


def control_sources(ctx) -> list:
    """(algo, source) of the answers a run compares, for the control: every
    program from `check_roots` roots of the pool, drawn from the seed."""
    t = ctx.traffic
    roots = pick(ctx.seed, 1, gen.pool(ctx.edges, t["roots"], salt=1), t["check_roots"])
    return [(name, r) for r in roots for name in t["programs"]]
