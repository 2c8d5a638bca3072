"""Streaming graph updates with incremental recomputation (DESIGN.md §8),
port of `repro.streaming`.

The dynamic-graph layer over the serving stack: batches of edge
insertions/deletions are absorbed into a STATIC-shape delta overlay
(neutralized CSR/ELL views + a bounded insertion buffer), and queries are
refreshed incrementally instead of from scratch:

  delta.py       -- StreamingGraph: the update log on the host, the base
                    graph and every view on the device (neutralized CSR/ELL
                    views, delta ELL slice, push COO buffer), the overflow
                    rebuild, affected-region / reverse-reachability sweeps
  incremental.py -- incremental recomputation: monotone programs converge
                    from the previous fixpoint seeded at update endpoints,
                    residual programs resume from corrected residuals,
                    non-monotone programs re-run only dirty queries

Entry points: `StreamingGraph` + `incremental_batch` for direct use,
`GraphServer.apply_updates` (repro_torch.serving) for the serving
integration, `launch/stream_graph.py` for the trace-replay driver.
"""

from repro_torch.streaming.delta import StreamingGraph, UpdateReport  # noqa: F401
from repro_torch.streaming.incremental import (  # noqa: F401
    incremental_batch,
    is_monotone,
    is_residual,
    residual_correct,
)

__all__ = [
    "StreamingGraph",
    "UpdateReport",
    "incremental_batch",
    "is_monotone",
    "is_residual",
    "residual_correct",
]
