"""Graph substrate: CSR structure, generators and ELL packing (torch port)."""

from repro_torch.graph.csr import (
    CSR,
    EdgeDelta,
    Graph,
    delta_from_edges,
    empty_delta,
    from_edges,
    to_undirected,
)
from repro_torch.graph.packing import (
    DEFAULT_BUCKETS,
    EllPack,
    EllSlice,
    delta_ell_slice,
    pack_ell,
    pack_ell_with_positions,
)
from repro_torch.graph import generators

__all__ = [
    "CSR",
    "EdgeDelta",
    "Graph",
    "delta_from_edges",
    "empty_delta",
    "from_edges",
    "to_undirected",
    "EllSlice",
    "EllPack",
    "delta_ell_slice",
    "pack_ell",
    "pack_ell_with_positions",
    "DEFAULT_BUCKETS",
    "generators",
]
