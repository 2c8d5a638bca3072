"""The port's telemetry helpers (`repro_torch.obs`) and result cache
(`repro_torch.serving.cache`) against the reference's `repro.obs` and
`repro.serving.cache`."""

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.serving import cache as jcache
from repro_torch import obs as tobs
from repro_torch.serving import cache as tcache


def test_layout_matches_the_reference():
    for k in ("TELE_PUSH_EDGES", "TELE_PULL_EDGES", "TELE_COMPACT_HITS", "TELE_COMPACT_DENSE",
              "TELE_MASKED_DENSE", "TELE_MASKED_ROWS", "TELE_LEN", "TELE_FIELDS", "SLO_FIELDS"):
        assert getattr(tobs, k) == getattr(jobs, k), k


@pytest.mark.parametrize("tele", [None, np.arange(6, dtype=np.int32),
                                  np.array([5, 7, 0, 0, 1, 9, 3, 8, 1], np.int32),
                                  np.array([0, 0, 0, 0, 0, 0, 0, 0], np.int32)])
def test_tele_helpers_match_the_reference(tele):
    as_tensor = None if tele is None else torch.from_numpy(tele)
    assert tobs.tele_dict(as_tensor) == jobs.tele_dict(tele)
    plane = tobs.shard_plane(as_tensor)
    assert np.array_equal(plane, jobs.shard_plane(tele)) and plane.dtype == np.int64
    assert tobs.skew_ratio(plane) == jobs.skew_ratio(jobs.shard_plane(tele))


def test_device_fetch_counts_each_transfer():
    before = tobs.TRANSFER_COUNT
    out = tobs.device_fetch(torch.arange(4, dtype=torch.int32))
    out2 = tobs.device_fetch(np.ones(2))
    assert isinstance(out, np.ndarray) and out.tolist() == [0, 1, 2, 3]
    assert out2.tolist() == [1.0, 1.0]
    assert tobs.TRANSFER_COUNT == before + 2


def _replay(mod, ops):
    c = mod.ResultCache(capacity=3)
    log = []
    for op, *args in ops:
        if op == "put":
            c.put(mod.make_key(*args[:3]), args[3])
        elif op == "get":
            log.append(c.get(mod.make_key(*args)))
        elif op == "pop":
            log.append(c.pop(mod.make_key(*args)))
        elif op == "invalidate":
            log.append(c.invalidate(mod.make_key(*args)))
        elif op == "take":
            log.append([(k, mod.served_result(v)) for k, v in c.take_version(args[0])])
        elif op == "note":
            c.note_invalidated(args[0])
    return log, c.stats(), len(c)


def test_result_cache_lru_and_versions_match_the_reference():
    """The same sequence of puts, gets, evictions, pops, invalidations and
    version takes gives the same answers and stats in both packages."""
    rng = np.random.default_rng(0)
    ops = []
    for i in range(60):
        ver, src = int(rng.integers(0, 2)), int(rng.integers(0, 6))
        kind = rng.choice(["put", "get", "get", "pop", "invalidate"])
        if kind == "put":
            ops.append(("put", ver, "bfs", src, f"r{i}"))
        else:
            ops.append((kind, ver, "bfs", src))
    ops += [("take", 1), ("note", 2), ("put", 2, "ppr", 3, "x"), ("get", 2, "ppr", 3),
            ("take", 0)]
    assert _replay(tcache, ops) == _replay(jcache, ops)


def test_cached_entry_and_keys():
    e = tcache.CachedEntry(result=np.ones(3), extras={"resid": np.zeros(3)})
    assert tcache.served_result(e) is e.result and tcache.served_result(5) == 5
    assert tcache.make_key(3, "ppr", 7, (("placement", "edge_sharded"),)) == \
        jcache.make_key(3, "ppr", 7, (("placement", "edge_sharded"),))
    c = tcache.ResultCache(capacity=0)
    c.put(("k",), 1)
    assert len(c) == 0 and c.get(("k",)) is None
