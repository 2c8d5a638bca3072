"""`repro_torch.obs` — the engine-telemetry part of `repro.obs`.

Port of the accumulator layout and the device->host chokepoint of
`repro.obs` (its lines 65-156), which the batched engine needs: the
`TELE_*` indices of `BatchState.tele`, the helpers that name and read it,
and `device_fetch`. The host-side registry, spans, flight recorder, health
monitor and `Observability` come with the scheduler.

A telemetry read of device state goes through :func:`device_fetch`, whose
call counter `TRANSFER_COUNT` is what an overhead guard pins: with
telemetry off the engine issues none.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# engine telemetry accumulator layout (BatchState.tele)
# ---------------------------------------------------------------------------

#: edges expanded by push iterations (union volume clamped to the edge
#: budget, plus streaming-delta COO lanes)
TELE_PUSH_EDGES = 0
#: ELL/COO slots scanned by pull / dense-shard iterations
TELE_PULL_EDGES = 1
#: edge-sharded shard-iterations served from the frontier-compacted buffer
TELE_COMPACT_HITS = 2
#: light shard-iterations whose compaction buffer overflowed -> dense scan
TELE_COMPACT_DENSE = 3
#: masked-pull slice scans forced dense (cache invalid or row-buffer
#: overflow)
TELE_MASKED_DENSE = 4
#: masked-pull ELL rows actually recomputed (hot rows, or all rows on a
#: dense fallback)
TELE_MASKED_ROWS = 5
TELE_LEN = 6

# An enabled accumulator is (TELE_LEN + n_shards,) int64 (the reference's
# int32 wraps at RMAT scale 22): the named global counters above, then the
# per-shard scan-volume plane (cumulative push + pull edges scanned by each
# shard; one slot on a single device).

TELE_FIELDS = (
    "push_edges_scanned",
    "pull_edges_scanned",
    "compact_hits",
    "compact_dense_fallbacks",
    "masked_dense_fallbacks",
    "masked_rows_recomputed",
)

#: the serving stack's SLO outcome counters (kept by the scheduler)
SLO_FIELDS = ("deadline_missed", "dropped", "degraded", "preempted")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tele_dict(tele) -> dict:
    """Name the global counters of an accumulator vector (host ints); the
    per-shard plane is read by :func:`shard_plane`, so the keys are exactly
    TELE_FIELDS."""
    if tele is None:
        return {}
    vals = [int(x) for x in _host(tele)[:TELE_LEN]]
    return dict(zip(TELE_FIELDS, vals))


def shard_plane(tele) -> np.ndarray:
    """Per-shard cumulative scanned-edge plane of an accumulator (empty for
    a (TELE_LEN,) vector)."""
    if tele is None:
        return np.zeros((0,), np.int64)
    return _host(tele)[TELE_LEN:].astype(np.int64)


def skew_ratio(plane) -> float:
    """Workload skew: max/mean of per-shard scanned edges (1.0 = balanced;
    0.0 when nothing was scanned or the plane is empty)."""
    plane = np.asarray(plane, np.float64)
    if plane.size == 0:
        return 0.0
    mean = float(plane.mean())
    return float(plane.max() / mean) if mean > 0 else 0.0


# ---------------------------------------------------------------------------
# the device->host chokepoint
# ---------------------------------------------------------------------------

#: telemetry-initiated device->host transfers since import
TRANSFER_COUNT = 0


def device_fetch(x) -> np.ndarray:
    """Fetch one tensor to the host as a numpy array, counting the
    transfer."""
    global TRANSFER_COUNT
    TRANSFER_COUNT += 1
    return _host(x)
