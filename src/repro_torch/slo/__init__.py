"""`repro_torch.slo` — SLO-grade serving: open-loop load + deadline policy.

Port of `repro.slo` (without `benchmarks/slo_bench.py`).

Two halves (DESIGN.md §13):

  workload.py -- seeded open-loop arrival specs: Poisson / bursty (MMPP)
                 clocks, multi-tenant algorithm mixes with per-class
                 deadlines and source skew, interleaved streaming update
                 batches; `generate` expands a spec deterministically.
  harness.py  -- `replay`: fire the arrival list at a `GraphServer` on the
                 wall clock WITHOUT closing the loop on completions, then
                 report goodput, shed/drop/degrade/preempt counts, and
                 p50/p95/p99 latency.

The enforcement half lives inside the serving stack (`repro_torch.serving.slo`,
re-exported here): `SLOPolicy` drives admission-time drops, degraded
shadow pools, and lane preemption/resume; consensus cohorts
(`GraphServer(cohorts=...)`) give tail isolation; `launch/slo_replay.py`
ties both halves together.
"""

from repro_torch.serving.slo import SLOPolicy, degraded_variant  # noqa: F401
from repro_torch.slo.harness import (  # noqa: F401
    ReplayReport,
    percentiles,
    replay,
    warmup,
)
from repro_torch.slo.workload import (  # noqa: F401
    Arrival,
    TenantClass,
    Workload,
    describe,
    generate,
)

__all__ = [
    "SLOPolicy",
    "degraded_variant",
    "Workload",
    "TenantClass",
    "Arrival",
    "generate",
    "describe",
    "replay",
    "warmup",
    "ReplayReport",
    "percentiles",
]
