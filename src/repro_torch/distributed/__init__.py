"""Distributed support on the single-controller mesh (`repro_torch.mesh`):
logical-axis sharding (`sharding`), gradient-compression all-reduces
(`collectives`), GPipe pipelines with automatic and manual tensor
parallelism (`pipeline`, `pipeline_tp`), and the training fault guards
(`fault`)."""

from repro_torch.distributed.fault import (
    Heartbeat,
    PreemptionGuard,
    SkippableIterator,
    StepWatchdog,
)

__all__ = ["Heartbeat", "PreemptionGuard", "SkippableIterator", "StepWatchdog"]
