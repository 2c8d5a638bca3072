#!/usr/bin/env python3
"""Seconds a step of the port's pipelines at chip_smoke phase 15 (a)'s
shapes, on one NVIDIA GPU.

    python3 scripts/port_pipeline_time.py [--root DIR] [--label NAME]

granite-3-8b at its published width in bf16, 8 layers, 4 micros of (1,
1,024) tokens, seeded weights and tokens; `pipeline_tp` on (4, 1), (2, 2),
(1, 2), (3, 1) and `pipeline` on (4, 1), every mesh of cuda:0. Each runs
one warm step and three timed ones (host clock, synchronized); the median
of the three is printed with all four. `--root` imports `repro_torch` from
another checkout (its kernels are built into its own `build/kernels/`), so
two trees can be compared in one call: run them as parent, change, change,
parent, since a single step on the shared host varies by ~20 %.
"""

import argparse
import dataclasses
import statistics
import sys
import time
from pathlib import Path

RUNS = (("pipeline_tp", (4, 1)), ("pipeline_tp", (2, 2)), ("pipeline_tp", (1, 2)),
        ("pipeline", (4, 1)), ("pipeline_tp", (3, 1)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default="", help="prefix of every printed line")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch import configs
    from repro_torch import mesh as M
    from repro_torch.distributed import pipeline as pp
    from repro_torch.distributed import pipeline_tp as pptp
    from repro_torch.models import transformer as tfm

    if not Path(pp.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {pp.__file__}, not from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("this script times the pipelines on a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("granite-3-8b").make_config(), n_layers=8)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    toks, lbls = (torch.randint(0, cfg.vocab, (4, 1, 1024), device=dev, generator=gen,
                                dtype=torch.int32) for _ in range(2))
    fns = {"pipeline": pp.pipeline_loss_and_grads,
           "pipeline_tp": pptp.pipeline_tp_loss_and_grads}
    for name, shape in RUNS:
        mesh = M.make_mesh(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))
        pc = pp.plan(cfg, shape[0], 4)
        pparams = dict(params, layers=pp.pad_layer_stack(params["layers"], cfg, pc))
        ts = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = fns[name](pparams, toks, lbls, cfg, pc, mesh)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
            del loss, grads
        print(f"{args.label} {name} {shape}: median {statistics.median(ts[1:]):.4f} s of "
              f"{[round(t, 4) for t in ts]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
