"""Run one cell of `BENCHMARK.json` on the card and print its result line.

    python3 graphbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` also `breakdown`, and last
`checks`: each number compared with its limit); the last lines of standard
error repeat the checks. With `--trace 0` the metrics are the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics. The run fails, printing no
result, without a CUDA device, with fewer devices than the cell asks for, or
if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse(argv)
    # kernel caches at fixed paths inside the checkout, so only a cell's
    # first run there builds (the port's nvcc output goes to build/kernels)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from graphbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 2
    cell = harness.cell_of(harness.load_benchmark(ROOT), args.workload)
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda:0", T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules that may not be loaded are: {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
