"""Batched multi-query graph serving, port of `repro.serving`.

  batch_engine.py -- Q stacked point queries, one push-pull loop
                     (vertex-major layout, union-frontier push, the Q-wide
                     `ell_combine_batched` pull, consensus JIT controller,
                     per-query done-masking)
  cache.py        -- graph-version-keyed LRU so hot queries short-circuit
  scheduler.py    -- so far `default_config`; slot pools and `GraphServer`
                     come with the serving slice

Entry point: `run_batch` for one fixed batch of queries.
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
from repro_torch.serving.scheduler import default_config

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
    "default_config",
]
