"""The port's filters (`repro_torch.core.frontier`) against the JAX reference:
every (ids, count, overflow) triple and mask is bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as JF
from repro_torch.core import frontier as TF


def same(a, b):
    a, b = np.asarray(a), b.numpy()
    return a.shape == b.shape and np.array_equal(a, b)


def same_triple(j, t):
    assert t[0].dtype == torch.int32 and t[1].dtype == torch.int32
    assert t[2].dtype == torch.bool
    for a, b in zip(j, t):
        assert same(a, b)


CASES = [(1, 0.0, 1), (100, 0.3, 100), (100, 0.3, 10), (1000, 0.95, 1000),
         (1000, 0.0, 5), (3001, 0.5, 2000), (4096, 0.5, 0), (7, 1.0, 3)]


@pytest.mark.parametrize("n,density,cap", CASES)
def test_compact_mask_and_ballot_filter(n, density, cap):
    rng = np.random.default_rng(n + cap)
    mask = rng.random(n) < density
    same_triple(JF.compact_mask(jnp.asarray(mask), cap, n),
                TF.compact_mask(torch.from_numpy(mask), cap, n))
    changed = np.concatenate([mask, [False]])
    same_triple(JF.ballot_filter(jnp.asarray(changed), cap, n),
                TF.ballot_filter(torch.from_numpy(changed), cap, n))


@pytest.mark.parametrize("e,cap", [(50, 50), (200, 20), (1, 1)])
def test_online_filter_dedupe_and_select(e, cap):
    rng = np.random.default_rng(e)
    n = 30
    changed = rng.random(e) < 0.6
    dst = rng.integers(0, n + 1, e).astype(np.int32)
    jc, tc = jnp.asarray(changed), torch.from_numpy(changed)
    jd, td = jnp.asarray(dst), torch.from_numpy(dst)
    assert same(JF.dedupe_winners(jc, jd, n), TF.dedupe_winners(tc, td, n))
    same_triple(JF.online_filter(jc, jd, cap, n), TF.online_filter(tc, td, cap, n))
    same_triple(JF.compact_values(jc, jd, cap, n), TF.compact_values(tc, td, cap, n))
    for a, b in zip(JF.select_edges(jc, cap), TF.select_edges(tc, cap)):
        assert same(a, b)
    old = rng.random(n + 1).astype(np.float32)
    upd = rng.random(e).astype(np.float32)
    same_triple(JF.batch_filter(jnp.asarray(upd), jd, jnp.asarray(old), cap, n,
                                lambda u, o: u < o),
                TF.batch_filter(torch.from_numpy(upd), td, torch.from_numpy(old), cap, n,
                                lambda u, o: u < o))


def test_batched_variants_equal_reference():
    rng = np.random.default_rng(5)
    n, e, cap = 40, 60, 25
    mask = rng.random((3, 2, n)) < 0.5
    same_triple(JF.compact_mask_batched(jnp.asarray(mask), cap, n),
                TF.compact_mask_batched(torch.from_numpy(mask), cap, n))
    changed = rng.random((3, e)) < 0.5
    dst = rng.integers(0, n + 1, (3, e)).astype(np.int32)
    jc, tc = jnp.asarray(changed), torch.from_numpy(changed)
    jd, td = jnp.asarray(dst), torch.from_numpy(dst)
    same_triple(JF.online_filter_batched(jc, jd, cap, n),
                TF.online_filter_batched(tc, td, cap, n))
    assert same(JF.dedupe_winners_batched(jc, jd, n), TF.dedupe_winners_batched(tc, td, n))
    cv = np.concatenate([mask[0], np.zeros((2, 1), bool)], -1)
    same_triple(JF.ballot_filter_batched(jnp.asarray(cv), cap, n),
                TF.ballot_filter_batched(torch.from_numpy(cv), cap, n))


def test_mask_from_ids_and_histogram():
    ids = np.asarray([3, 0, 9, 10, 3, 42], np.int32)    # 10 = scratch, 42 drops
    for q in (0, 3):
        assert same(JF.mask_from_ids(jnp.asarray(ids), 10, q),
                    TF.mask_from_ids(torch.from_numpy(ids), 10, q))
    deg = np.asarray([1, 5, 40, 300, 2, 0], np.int32)
    fid = np.asarray([0, 1, 2, 3, 4, 6], np.int32)
    assert same(JF.frontier_degree_histogram(jnp.asarray(fid), jnp.int32(4), jnp.asarray(deg)),
                TF.frontier_degree_histogram(torch.from_numpy(fid), torch.tensor(4),
                                             torch.from_numpy(deg)))
