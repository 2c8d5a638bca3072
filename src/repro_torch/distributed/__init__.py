"""Distributed training support. This slice holds only the fault guards
(`fault`); the mesh, sharding, collectives and pipelines are still to port."""

from repro_torch.distributed.fault import (
    Heartbeat,
    PreemptionGuard,
    SkippableIterator,
    StepWatchdog,
)

__all__ = ["Heartbeat", "PreemptionGuard", "SkippableIterator", "StepWatchdog"]
