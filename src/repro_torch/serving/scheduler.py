"""Graph serving scheduler — so far only its engine configuration.

Port of `repro.serving.scheduler`, begun with `default_config` (its lines
154-162); the slot pools, request queues and `GraphServer` come with the
serving slice.
"""

from __future__ import annotations

from repro_torch.core.engine import EngineConfig
from repro_torch.graph.csr import Graph


def default_config(g: Graph, max_iters: int = 4096) -> EngineConfig:
    """Serving-friendly engine config: full frontier cap (dense masks can't
    overflow), a modest push edge budget (the consensus controller pulls on
    heavy iterations anyway, so a lean push buffer keeps light iterations
    cheap)."""
    n, m = g.n_nodes, g.n_edges
    return EngineConfig(frontier_cap=n, edge_cap=max(1, min(m, 2 * n)),
                        max_iters=max_iters)
