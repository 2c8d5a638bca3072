"""Training launcher of the port (runnable on the CPU at tiny size).

Port of `repro.launch.train`: the config registry, the `TokenStream`,
AdamW, the checkpoint manager (atomic, async, keep-N, auto-resume), the
preemption guard, the heartbeat and the straggler watchdog, wired in the
reference's order with its flags and defaults, plus `--device` (default
cuda; the tests pass cpu). It trains on one device, as the reference's
launcher does on its (1, 1) mesh; the pipelines over a mesh are `distributed.pipeline` and
`distributed.pipeline_tp`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --preset tiny --steps 200 --ckpt-dir /tmp/ckpt

`train_step` is a plain function: `loss_fn`, autograd, `adamw.update` in
place. Each step's loss is read once through `obs.device_fetch`, so the
watchdog times whole steps and the log lines need no other read. The JSON
summary line ends with `launches`: the kernel launches of the run, by
kernel (empty on the CPU, where every op takes its plain version).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from repro_torch import configs, obs
from repro_torch import tree as T
from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenStream
from repro_torch.distributed.fault import Heartbeat, PreemptionGuard, StepWatchdog
from repro_torch.kernels import ops
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw


def tiny_config(base: tfm.TransformerConfig, d_model=256, n_layers=4,
                vocab=2048) -> tfm.TransformerConfig:
    """Scale an assigned config down for CPU execution, preserving family
    (GQA ratio, MoE-ness)."""
    moe = base.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=min(moe.n_experts, 8),
                                  top_k=min(moe.top_k, 2))
    return dataclasses.replace(
        base, d_model=d_model, n_layers=n_layers,
        n_heads=max(4, d_model // 64), n_kv=max(2, d_model // 128),
        head_dim=64, d_ff=d_model * 4 if moe is None else d_model,
        vocab=vocab, moe=moe, dtype="float32",
    )


def preset_config(arch: str, preset: str) -> tfm.TransformerConfig:
    """The config `main` trains for `--arch` and `--preset`."""
    spec = configs.get(arch)
    assert spec.family == "lm", ("train.py drives LM archs; for DeepFM see "
                                 "examples/torch/train_recsys.py, for the GNNs the "
                                 "models' loss_fn")
    base = spec.make_config()
    if preset == "tiny":
        return tiny_config(base)
    if preset == "100m":
        return tiny_config(base, d_model=768, n_layers=12, vocab=8192)
    return base


def train_step(params: dict, opt_state: dict, tokens: torch.Tensor, labels: torch.Tensor,
               cfg: tfm.TransformerConfig, opt_cfg: adamw.AdamWConfig) -> dict:
    """One step in place: the loss, its gradients (every leaf of `params`
    requires a gradient), and `adamw.update`. Returns the metrics, float32
    scalars on the device: loss, grad_norm, lr."""
    loss = tfm.loss_fn(params, tokens, labels, cfg)
    grads = torch.autograd.grad(loss, T.leaves(params), allow_unused=True,
                                materialize_grads=True)
    _, _, metrics = adamw.update(T.unflatten(params, grads), opt_state, params, opt_cfg)
    metrics["loss"] = loss.detach()
    return metrics


def trainable(params: dict) -> dict:
    """Mark every leaf of `params` as requiring a gradient; returns it."""
    for p in T.leaves(params):
        p.requires_grad_(True)
    return params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset)
    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, total_steps=args.steps, warmup_steps=max(10, args.steps // 20),
        weight_decay=0.01,
    )
    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=args.seed)
    mgr = CheckpointManager(args.ckpt_dir, keep_n=3)
    guard = PreemptionGuard().install()
    try:
        return _loop(args, dev, cfg, opt_cfg, stream, mgr, guard)
    finally:
        mgr.wait()
        guard.uninstall()


def _loop(args, dev, cfg, opt_cfg, stream, mgr, guard) -> int:
    wd = StepWatchdog()
    before = ops.launch_counts()
    hb = Heartbeat(args.heartbeat, 5.0) if args.heartbeat else None

    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    opt_state = adamw.init(params, opt_cfg)
    start_step = 0

    # ---- auto-resume -----------------------------------------------------
    restored, manifest = mgr.restore_latest({"p": params, "o": opt_state})
    if restored is not None:
        params, opt_state = restored["p"], restored["o"]
        start_step = manifest["step"]
        if "data" in manifest.get("extra", {}):
            stream.restore(manifest["extra"]["data"])
        print(f"[resume] from step {start_step}")
    params = trainable(params)

    nparams = sum(x.numel() for x in T.leaves(params))
    print(f"[train] arch={args.arch} preset={args.preset} params={nparams/1e6:.1f}M")

    t_start = time.time()
    loss = None
    for step in range(start_step, args.steps):
        if guard.preempted:
            print("[preempt] SIGTERM received -> checkpoint + exit")
            mgr.save(step, {"p": params, "o": opt_state},
                     extra={"data": stream.state()}, block=True)
            return 1
        wd.start()
        x, y = next(stream)
        m = train_step(params, opt_state, torch.from_numpy(x).to(dev),
                       torch.from_numpy(y).to(dev), cfg, opt_cfg)
        loss, gnorm, lr = (float(v) for v in obs.device_fetch(
            torch.stack([m["loss"], m["grad_norm"], m["lr"]])))
        if wd.stop():
            print(f"[straggler] step {step} above {wd.factor}x EMA")
        if hb:
            hb.beat(step)
        if (step + 1) % args.log_every == 0:
            print(
                f"step {step+1} loss {loss:.4f} "
                f"gnorm {gnorm:.3f} lr {lr:.2e} "
                f"({(time.time()-t_start)/(step-start_step+1):.2f}s/step)"
            )
        if (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"p": params, "o": opt_state},
                     extra={"data": stream.state()})
    mgr.save(args.steps, {"p": params, "o": opt_state},
             extra={"data": stream.state()}, block=True)
    launches = {k: n - before[k] for k, n in ops.launch_counts().items() if n > before[k]}
    print(json.dumps({"final_loss": loss, **wd.summary(), "launches": launches}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
