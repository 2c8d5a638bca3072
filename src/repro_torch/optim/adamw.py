"""AdamW with float32, bfloat16 or blockwise int8 moments.

Port of `repro.optim.adamw`. The state is the reference's: {'step': an
int32 scalar tensor, 'm': ..., 'v': ...} with `m` and `v` shaped like the
parameters, each moment leaf a float32 or bfloat16 tensor, or for int8 a
dict {'q': (nb, 256) int8, 's': (nb, 1) float32} of the flattened leaf cut
into blocks of BLOCK = 256 values (zero-padded), each scaled by its absmax
/ 127 + 1e-12 and rounded half to even, as `jnp.round` rounds.

`update` works in place under `torch.no_grad()`: each parameter and moment
leaf is overwritten, and the call returns the same objects with the
metrics. The arithmetic is the reference's, leaf by leaf in float32: global
norm clip, linear warmup then cosine decay, bias-corrected moments, and
weight decay on leaves with ndim >= 2 only. The port's stacked (L, ...)
layer leaves have the reference's shapes, so the (L, d) norm gains take
decay in both packages.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import tree as T

BLOCK = 256
MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % BLOCK))
    blocks = flat.view(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"     # 'float32' | 'bfloat16' | 'int8'
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to min_lr_frac; float32 scalar."""
    step = step.float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _zeros_like_moment(p: torch.Tensor, dtype: str):
    if dtype == "int8":
        nb = -(-p.numel() // BLOCK)
        return {"q": torch.zeros((nb, BLOCK), dtype=torch.int8, device=p.device),
                "s": torch.zeros((nb, 1), dtype=torch.float32, device=p.device)}
    return torch.zeros(p.shape, dtype=MOMENT_DTYPES[dtype], device=p.device)


def _read_moment(m, p: torch.Tensor, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _dq8(m["q"], m["s"], p.shape)
    return m.float()


def _write_moment(m, val: torch.Tensor, dtype: str) -> None:
    if dtype == "int8":
        q, s = _q8(val)
        m["q"].copy_(q)
        m["s"].copy_(s)
    else:
        m.copy_(val)


def init(params, cfg: AdamWConfig) -> dict:
    leaves = T.leaves(params)
    dev = leaves[0].device if leaves else None
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": T.map_leaves(lambda p: _zeros_like_moment(p, cfg.moment_dtype), params),
            "v": T.map_leaves(lambda p: _zeros_like_moment(p, cfg.moment_dtype), params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaves summed
    in the reference's order."""
    total = 0.0
    for x in T.leaves(tree):
        total = total + x.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def update(grads, state: dict, params, cfg: AdamWConfig):
    """One AdamW step in place: `params` and `state` are overwritten.
    Returns (params, state, {'grad_norm', 'lr'}), the metrics float32 scalar
    tensors on the device."""
    step = state["step"] + 1
    gn = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / (gn + 1e-9), 1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)
    for _, p, g, m, v in T.walk(params, grads, state["m"], state["v"]):
        g = g.float() * clip
        mf = cfg.b1 * _read_moment(m, p, cfg.moment_dtype) + (1 - cfg.b1) * g
        vf = cfg.b2 * _read_moment(v, p, cfg.moment_dtype) + (1 - cfg.b2) * g.square()
        step_dir = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0   # no decay on norms and biases
        pf = p.float()
        p.copy_(pf - lr * (step_dir + wd * pf))
        _write_moment(m, mf, cfg.moment_dtype)
        _write_moment(v, vf, cfg.moment_dtype)
    state["step"] = step
    return params, state, {"grad_norm": gn, "lr": lr}
