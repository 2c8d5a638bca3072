"""The control of `correct`: the plain reference put in the program's place
for the answers a run of the cell compares, its values held in the dtype the
cell's mix names under `control` (bfloat16, one precision below the
configuration's float32), and judged by the run's own comparison
(`harness.check`). One of the numbers it prints beside its limit must fail;
run on the card at the cell's own size, on three seeds or more:

    python3 graphbench/control.py --workload <name> --seeds <n> [<n> ...]

Prints one JSON line a seed: {"seed", "kind", "checks": {name: [value,
limit]}, "fails": [...]}.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(workload: str, seed: int, device, kind=None, root: Path = ROOT) -> dict:
    """name -> (value, limit) of the cell's comparison with the control's
    answers in the program's place (`kind`: the mix's `control` if None)."""
    import torch

    from graphbench import gen, harness
    from graphbench.reference import RefGraph

    bench = harness.load_benchmark(root)
    cell = harness.cell_of(bench, workload)
    ctx = harness.Ctx(device=torch.device(device), seed=int(seed),
                      config=harness.config_of(root, bench, cell["config"]),
                      traffic=harness.traffic_of(root, cell["traffic"]), traced=False)
    ctx.edges = gen.draw(ctx.config, ctx.seed, ctx.device)
    wanted = harness.module(root, "drivers", ctx.traffic["driver"]).control_sources(ctx)
    ref = RefGraph(ctx.edges)
    outputs = []
    for algo in sorted({algo for algo, _ in wanted}):
        sources = [s for a, s in wanted if a == algo]
        answers = harness.module(root, "checks", algo).control(
            ref, sources, ctx.traffic.get("params", {}).get(algo, {}),
            kind or ctx.traffic["control"])
        outputs += [(algo, s, ans) for s, ans in zip(sources, answers)]
    del ref
    return harness.check(root, ctx, harness.Window(seconds=0.0, items=[], outputs=outputs))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kind", default=None, help="a dtype name (default: the mix's)")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    from graphbench import harness

    bench = harness.load_benchmark(ROOT)
    traffic = harness.traffic_of(ROOT, harness.cell_of(bench, args.workload)["traffic"])
    kind = args.kind or traffic["control"]
    for seed in args.seeds:
        checks = control(args.workload, seed, args.device, kind)
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                          "checks": checks, "fails": harness.fails(checks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
