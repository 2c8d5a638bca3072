"""Batched multi-query graph serving, port of `repro.serving`.

  batch_engine.py -- Q stacked point queries, one push-pull loop
                     (vertex-major layout, union-frontier push, the Q-wide
                     `ell_combine_batched` pull, consensus JIT controller,
                     per-query done-masking)
  scheduler.py    -- slot pools + weighted request queues with
                     backpressure; continuous batching with mid-flight lane
                     recycling, cohorts, SLO actions, telemetry
  cache.py        -- graph-version-keyed LRU so hot queries short-circuit
  slo.py          -- deadline-aware policy: admission drop, degraded shadow
                     pools, lane preemption/resume (DESIGN.md §13)

Entry points: `GraphServer` for request streams, `run_batch` for one fixed
batch, `launch/serve_graph.py` for the CLI driver. Sharded pools
(`sharded.py`, `placement.py`) are ROADMAP queue 1 item 8.
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

__all__ = [
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
