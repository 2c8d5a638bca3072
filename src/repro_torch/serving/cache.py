"""LRU result cache for the graph serving layer (host only).

Port of `repro.serving.cache`, unchanged: it holds host values and touches
no device.

Point queries are heavily skewed in serving traffic (hot sources, repeated
per-user PPR) — a small LRU in front of the batched engine short-circuits
repeats without touching a slot. Keys bind the GRAPH VERSION so a graph swap
(rebuild, streaming update) invalidates every cached result implicitly:
bump `GraphServer.graph_version` and old keys simply never match again.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable, NamedTuple, Optional, Tuple


class CachedEntry(NamedTuple):
    """A cache value carrying resumable state beyond the served result.

    Residual-push pools (`ppr_delta`) store `(rank, {resid: ...})` so a
    DIRTY cached entry can refresh incrementally across a streaming update
    (Maiter-correct the residuals, resume the fixpoint) instead of dropping
    — a bare (n,) rank is not resumable (ROADMAP streaming 3(e), DESIGN.md
    §11). `result` is what a cache hit serves; `extras` maps extra metadata
    field names to their (n,) planes."""

    result: Any
    extras: dict


def served_result(value):
    """The (n,) result a cache hit serves, whatever the stored shape."""
    return value.result if isinstance(value, CachedEntry) else value


def make_key(graph_version: int, algo: str, source: int,
             params: Tuple = ()) -> Tuple:
    """Canonical cache key: (graph version, algorithm, source, extra params).

    `params` must be hashable; `GraphServer` passes each pool's
    `cache_params` — () for single-device and replicated pools (their
    results are the bitwise reference), and (('placement', 'edge_sharded'),)
    for edge-partitioned pools of sum-combiner programs, whose results
    differ from the reference by one cross-shard reassociation (DESIGN.md
    §9) and must never be served under the bit-exact key. Callers serving
    several parameterizations of one algorithm (e.g. two PPR dampings as
    separate pools) put the distinguishing (name, value) pairs here too.
    """
    return (int(graph_version), str(algo), int(source), tuple(params))


class ResultCache:
    """Bounded LRU: `get` refreshes recency, `put` evicts the stalest entry.

    Values are whatever the caller stores (host numpy result arrays here —
    keeping cached results off-device frees HBM for in-flight queries).
    """

    def __init__(self, capacity: int = 1024):
        assert capacity >= 0
        self.capacity = capacity
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        #: entries lost to STALENESS rather than capacity: explicit
        #: `invalidate` hits, plus the take_version entries a streaming
        #: update could not retain/refresh (the caller reports those via
        #: `note_invalidated` — the cache cannot see which taken entries
        #: come back). The unified stats surface reads this (DESIGN.md §12).
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def get(self, key: Hashable) -> Optional[Any]:
        if key in self._entries:
            self._entries.move_to_end(key)
            self.hits += 1
            return self._entries[key]
        self.misses += 1
        return None

    def put(self, key: Hashable, value: Any) -> None:
        if self.capacity == 0:
            return
        if key in self._entries:
            self._entries.move_to_end(key)
        self._entries[key] = value
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def pop(self, key: Hashable) -> Optional[Any]:
        """Remove and return an entry WITHOUT touching hit/miss/invalidation
        accounting. This is for internal scheduler bookkeeping traffic —
        e.g. reclaiming a preempted query's parked partial state at
        re-admission (DESIGN.md §13) — which is not request-serving activity
        and must not skew the cache's observable hit rate."""
        return self._entries.pop(key, None)

    def invalidate(self, key: Hashable) -> bool:
        hit = self._entries.pop(key, None) is not None
        if hit:
            self.invalidations += 1
        return hit

    def note_invalidated(self, n: int) -> None:
        """Record `n` entries dropped by a streaming update's selective
        invalidation pass (`take_version` entries never re-`put`)."""
        self.invalidations += int(n)

    def take_version(self, graph_version: int) -> list:
        """Remove and return every entry keyed to `graph_version`, in recency
        order (stalest first), as (key, value) pairs.

        This is the mechanism under SELECTIVE invalidation on a streaming
        graph update (DESIGN.md §8): the caller re-`put`s the entries whose
        source survives the affected-region test under the new version
        (preserving relative recency), refreshes or drops the rest — instead
        of the wholesale version-bump invalidation."""
        keys = [k for k in self._entries
                if isinstance(k, tuple) and k and k[0] == graph_version]
        return [(k, self._entries.pop(k)) for k in keys]

    def clear(self) -> None:
        self._entries.clear()

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "size": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "hit_rate": self.hits / total if total else 0.0,
        }
