"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """Return `device` as a `torch.device`; raise if it names CUDA and no GPU
    is present (the port never carries on silently on the CPU). `meta`
    (shapes and dtypes, no data) is taken only where the caller names it:
    the dry-run builds its inputs there (`launch.steps`) and the kernels'
    meta routes count their work (`launch.cost`)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
