"""The port's graph layer (`repro_torch.graph`) against the JAX reference:
generators, CSR arrays and ELL slices are array-equal for the same seed."""

import numpy as np
import pytest
import torch

from repro.graph import csr as jcsr
from repro.graph import generators as JG
from repro.graph import packing as jpacking
from repro_torch import interop
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as TG
from repro_torch.graph import packing as tpacking

CPU = "cpu"

GENERATORS = {
    "rmat": (lambda: JG.rmat(9, 8, seed=3),
             lambda: TG.rmat(9, 8, seed=3, device=CPU)),
    "rmat_directed": (lambda: JG.rmat(8, 8, seed=1, directed=True),
                      lambda: TG.rmat(8, 8, seed=1, directed=True, device=CPU)),
    "rmat_unweighted": (lambda: JG.rmat(7, 4, seed=2, weighted=False),
                        lambda: TG.rmat(7, 4, seed=2, weighted=False, device=CPU)),
    "grid2d": (lambda: JG.grid2d(24, seed=5), lambda: TG.grid2d(24, seed=5, device=CPU)),
    "chain": (lambda: JG.chain(300, seed=2), lambda: TG.chain(300, seed=2, device=CPU)),
    "star": (lambda: JG.star(700, seed=4), lambda: TG.star(700, seed=4, device=CPU)),
    "uniform": (lambda: JG.uniform_random(400, 3000, seed=7),
                lambda: TG.uniform_random(400, 3000, seed=7, device=CPU)),
    "uniform_directed": (lambda: JG.uniform_random(300, 2000, seed=8, directed=True),
                         lambda: TG.uniform_random(300, 2000, seed=8, directed=True,
                                                   device=CPU)),
    "molecules": (lambda: JG.batched_molecules(6, 20, 40, seed=9),
                  lambda: TG.batched_molecules(6, 20, 40, seed=9, device=CPU)),
}


def assert_csr_equal(j, t):
    for k in interop.CSR_FIELDS:
        a = np.asarray(getattr(j, k))
        b = getattr(t, k).numpy()
        assert a.dtype == b.dtype, k
        assert np.array_equal(a, b), k


def assert_slices_equal(jp, tp):
    assert jp.n_nodes == tp.n_nodes
    assert len(jp.slices) == len(tp.slices)
    for s, r in zip(jp.slices, tp.slices):
        for k in interop.SLICE_FIELDS:
            a, b = np.asarray(getattr(s, k)), getattr(r, k).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_give_equal_csr_and_ell(name):
    jf, tf = GENERATORS[name]
    j, t = jf(), tf()
    assert (j.n_nodes, j.n_edges) == (t.n_nodes, t.n_edges)
    assert_csr_equal(j.out, t.out)
    assert_csr_equal(j.inc, t.inc)
    assert (t.inc is t.out) == (j.inc is j.out)
    assert_slices_equal(jpacking.pack_ell(j.inc), tpacking.pack_ell(t.inc))


@pytest.mark.parametrize("name", ["rmat_s", "uniform_s", "road_s"])
def test_suite_entries_equal(name):
    assert_csr_equal(JG.SUITE[name]().out, TG.SUITE[name](device=CPU).out)


@pytest.mark.parametrize("buckets,split,min_rows", [((4, 32, 256), 256, 8),
                                                     ((2, 8), 16, 4)])
def test_pack_with_positions_and_stats_equal(buckets, split, min_rows):
    j = JG.rmat(9, 8, seed=3)
    t = TG.rmat(9, 8, seed=3, device=CPU)
    jp, jpos = jpacking.pack_ell_with_positions(j.inc, buckets, split, min_rows)
    tp, tpos = tpacking.pack_ell_with_positions(t.inc, buckets, split, min_rows)
    assert_slices_equal(jp, tp)
    assert tpos.dtype == np.int64 and np.array_equal(jpos, tpos)
    assert jpacking.pack_stats(jp) == tpacking.pack_stats(tp)
    assert_slices_equal(jpacking.pack_ell(j.inc, buckets, split, min_rows),
                        tpacking.pack_ell(t.inc, buckets, split, min_rows))


def test_delta_structures_and_live_degrees_equal():
    j = JG.rmat(8, 8, seed=1, directed=True)
    t = TG.rmat(8, 8, seed=1, directed=True, device=CPU)
    n = j.n_nodes
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, 5)
    dst = rng.integers(0, n, 5)
    w = rng.integers(1, 9, 5).astype(np.float32)
    jd = jcsr.delta_from_edges(src, dst, w, n, 8)
    td = tcsr.delta_from_edges(src, dst, w, n, 8, device=CPU)
    for k in ("src", "dst", "w"):
        assert np.array_equal(np.asarray(getattr(jd, k)), getattr(td, k).numpy())
    je, te = jcsr.empty_delta(n, 4), tcsr.empty_delta(n, 4, device=CPU)
    for k in ("src", "dst", "w"):
        assert np.array_equal(np.asarray(getattr(je, k)), getattr(te, k).numpy())
    for delta in (None, (jd, td)):
        a = jcsr.live_degrees(j.out, None if delta is None else delta[0])
        b = tcsr.live_degrees(t.out, None if delta is None else delta[1])
        assert b.dtype == torch.int32 and np.array_equal(np.asarray(a), b.numpy())
    js = jpacking.delta_ell_slice(dst, src, w, n, 8)
    ts = tpacking.delta_ell_slice(dst, src, w, n, 8, device=CPU)
    for k in interop.SLICE_FIELDS:
        assert np.array_equal(np.asarray(getattr(js, k)), getattr(ts, k).numpy())


def test_to_undirected_and_host_degrees_equal():
    j = JG.rmat(8, 8, seed=1, directed=True)
    t = TG.rmat(8, 8, seed=1, directed=True, device=CPU)
    assert_csr_equal(jcsr.to_undirected(j).out, tcsr.to_undirected(t).out)
    assert np.array_equal(jcsr.host_degrees(j), tcsr.host_degrees(t))


def test_interop_carries_graph_and_pack():
    j = JG.rmat(8, 8, seed=1, directed=True)
    jp = jpacking.pack_ell(j.inc)
    g = interop.graph_from_numpy(interop.csr_arrays(j.out), interop.csr_arrays(j.inc),
                                 device=CPU)
    assert_csr_equal(j.out, g.out)
    assert_csr_equal(j.inc, g.inc)
    p = interop.pack_from_numpy(
        [{k: np.asarray(getattr(s, k)) for k in interop.SLICE_FIELDS} for s in jp.slices],
        jp.n_nodes, device=CPU)
    assert_slices_equal(jp, p)
    meta = interop.meta_from_numpy({"x": np.arange(3, dtype=np.float32)}, device=CPU)
    assert meta["x"].dtype == torch.float32


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the request is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        TG.chain(10)
    with pytest.raises(RuntimeError, match="cuda"):
        tcsr.empty_delta(4, 2)
