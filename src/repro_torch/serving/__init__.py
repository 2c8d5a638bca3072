"""Batched multi-query graph serving, port of `repro.serving`.

  batch_engine.py -- Q stacked point queries, one push-pull loop
                     (vertex-major layout, union-frontier push, the Q-wide
                     `ell_combine_batched` pull, consensus JIT controller,
                     per-query done-masking)
  scheduler.py    -- slot pools + weighted request queues with
                     backpressure; continuous batching with mid-flight lane
                     recycling, cohorts, SLO actions, telemetry
  cache.py        -- graph-version-keyed LRU so hot queries short-circuit
  sharded.py      -- the batched loop on a ('data', 'model') mesh of
                     devices: query-sharded replicas or 1-D edge partitions,
                     with a global consensus controller (DESIGN.md §9)
  placement.py    -- pool placement layer: sharded pools behind GraphServer
  slo.py          -- deadline-aware policy: admission drop, degraded shadow
                     pools, lane preemption/resume (DESIGN.md §13; the load
                     harness lives in `repro_torch.slo`)

Entry points: `GraphServer` for request streams (pass `mesh`/`placements`
for sharded pools), `run_batch` / `run_sharded` for one fixed batch,
`launch/serve_graph.py --mesh DxS` for the CLI driver.
"""

from repro_torch.serving.batch_engine import (
    BatchState,
    GraphDims,
    init_batch,
    make_batched_step,
    query_result,
    run_batch,
    run_sequential,
    run_state,
)
from repro_torch.serving.cache import ResultCache, make_key
from repro_torch.serving.scheduler import (
    AlgoPool,
    Completion,
    GraphServer,
    QueueFull,
    Request,
    default_config,
)
from repro_torch.serving.slo import SLOPolicy, degraded_variant
from repro_torch.serving.placement import (
    Placement,
    ShardedAlgoPool,
    make_serving_mesh,
)
from repro_torch.serving.sharded import (
    ShardedBatchEngine,
    run_sharded,
    shard_sources,
)

__all__ = [
    "Placement",
    "ShardedAlgoPool",
    "ShardedBatchEngine",
    "make_serving_mesh",
    "run_sharded",
    "shard_sources",
    "BatchState",
    "GraphDims",
    "init_batch",
    "make_batched_step",
    "query_result",
    "run_batch",
    "run_sequential",
    "run_state",
    "ResultCache",
    "make_key",
    "AlgoPool",
    "Completion",
    "GraphServer",
    "QueueFull",
    "Request",
    "default_config",
    "SLOPolicy",
    "degraded_variant",
]
