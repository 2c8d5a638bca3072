"""The port's ACC model (`repro_torch.core.acc`) against the JAX reference:
the halving tree is bit-equal, empty segments are +-inf as in JAX, the
combiner monoid probes (ACC-C401..C403) hold, and the catalog's metadata and
kernel Compute ops agree with the reference programs."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acc as jacc
from repro.core import algorithms as JA
from repro_torch.core import acc as tacc
from repro_torch.core import algorithms as TA
from repro_torch.kernels.ell_spmv import compute_op

COMBS = ["MIN_VOTE", "MIN_AGG", "SUM_AGG", "MAX_VOTE"]
#: dyadic-rational samples (analysis/combiner_check.py): every monoid law
#: holds bit-exactly on them, sum included
SAMPLES = np.asarray([-2.5, -0.375, 0.0, 0.125, 1.0, 3.75], np.float32)


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name", COMBS)
@pytest.mark.parametrize("width", [1, 3, 4, 32, 256])
def test_reduce_axis_tree_bit_equal(name, width):
    rng = np.random.default_rng(width)
    x = (rng.standard_normal((7, width, 3)) * 100).astype(np.float32)
    j, t = getattr(jacc, name), getattr(tacc, name)
    for axis in (1, 0, -1):
        a = j.reduce_axis_tree(jnp.asarray(x), axis)
        b = t.reduce_axis_tree(torch.from_numpy(x), axis)
        assert np.array_equal(bits(a), bits(b.numpy())), axis


@pytest.mark.parametrize("name", COMBS)
def test_segment_matches_jax_with_inf_empties(name):
    rng = np.random.default_rng(1)
    vals = rng.random(40).astype(np.float32)
    ids = rng.integers(-2, 12, 40).astype(np.int32)     # unsorted, some out of range
    j, t = getattr(jacc, name), getattr(tacc, name)
    a = np.asarray(j.segment(jnp.asarray(vals), jnp.asarray(ids), 15))
    b = t.segment(torch.from_numpy(vals), torch.from_numpy(ids), 15).numpy()
    if j.name == "sum":
        np.testing.assert_allclose(a, b, rtol=1e-6)
    else:
        assert np.array_equal(a, b)
        assert np.isinf(b[12:]).all()                   # empty: +-inf, as in JAX
    vq = rng.random((3, 20)).astype(np.float32)
    iq = rng.integers(0, 6, (3, 20)).astype(np.int32)
    a = np.asarray(j.segment_stacked(jnp.asarray(vq), jnp.asarray(iq), 6))
    b = t.segment_stacked(torch.from_numpy(vq), torch.from_numpy(iq), 6).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_empty_segment_fills_match_jax():
    a = jacc.MIN_VOTE.segment(jnp.asarray([1.0, 2.0]), jnp.asarray([0, 0]), 3)
    b = tacc.MIN_VOTE.segment(torch.tensor([1.0, 2.0]), torch.tensor([0, 0]), 3)
    assert np.array_equal(np.asarray(a), b.numpy())
    assert b.tolist() == [1.0, float("inf"), float("inf")]
    c = tacc.MAX_VOTE.segment(torch.tensor([1.0]), torch.tensor([2]), 3)
    assert c.tolist() == [float("-inf"), float("-inf"), 1.0]


@pytest.mark.parametrize("name", COMBS)
def test_combiner_probes_c401_c403(name):
    """The ACC-C401..C403 probes of repro.analysis.combiner_check, on the
    port's Combiner."""
    comb = getattr(tacc, name)
    eq = torch.equal
    ident = comb.identity(torch.float32)
    assert eq(ident, getattr(jacc, name).identity(jnp.float32).item() * torch.ones(()))
    xs = [torch.tensor(v) for v in SAMPLES]
    # C401: identity, associativity, commutativity
    for x in xs:
        assert eq(comb.pair(ident, x), x) and eq(comb.pair(x, ident), x)
    for a, b, c in itertools.product(xs, repeat=3):
        assert eq(comb.pair(comb.pair(a, b), c), comb.pair(a, comb.pair(b, c)))
    for a, b in itertools.product(xs, repeat=2):
        assert eq(comb.pair(a, b), comb.pair(b, a))
    # C402: idempotency as declared
    idem = all(eq(comb.pair(x, x), x) for x in xs)
    assert idem == comb.idempotent
    if comb.kind == "vote":
        assert idem
    # C403: segment == sequential lane-order fold; stacked rows; tree layout
    rng = np.random.default_rng(7)
    e, n, q = 23, 5, 3
    vals = torch.from_numpy(rng.choice(SAMPLES, size=(e,)))
    ids = torch.from_numpy(rng.integers(0, n, size=(e,)).astype(np.int32))
    seg = comb.segment(vals, ids, n)
    ref = torch.full((n,), float(ident))
    for i in range(e):
        ref[ids[i]] = comb.pair(ref[ids[i]], vals[i])
    hit = torch.bincount(ids.long(), minlength=n) > 0
    assert eq(seg[hit], ref[hit])
    vq = torch.from_numpy(rng.choice(SAMPLES, size=(q, e)))
    iq = torch.from_numpy(rng.integers(0, n, size=(q, e)).astype(np.int32))
    rows = torch.stack([comb.segment(vq[r], iq[r], n) for r in range(q)])
    assert eq(comb.segment_stacked(vq, iq, n), rows)
    stack = torch.from_numpy(rng.choice(SAMPLES, size=(6, n, q)))
    cols = torch.stack([comb.reduce_axis_tree(stack[:, :, c], 0) for c in range(q)], -1)
    assert eq(comb.reduce_axis_tree(stack, 0), cols)


def _program(mod, name):
    return mod.ALL[name](0) if name in ("bfs", "sssp") else mod.ALL[name]()


@pytest.mark.parametrize("name", sorted(JA.ALL))
def test_catalog_metadata_identical(name):
    j, t = _program(JA, name), _program(TA, name)
    assert (j.name, j.primary, j.modes, j.fixed_iters, j.params) == \
        (t.name, t.primary, t.modes, t.fixed_iters, t.params)
    assert (j.combiner.name, j.combiner.kind) == (t.combiner.name, t.combiner.kind)
    assert (j.with_tol is None) == (t.with_tol is None)
    if j.with_tol is not None:
        assert j.with_tol(1e-3).params == t.with_tol(1e-3).params


@pytest.mark.parametrize("name", sorted(JA.ALL))
def test_kernel_compute_op_equals_program_compute(name):
    """The named op that stamps the CUDA template computes what the
    program's Compute does from the sender's primary field and the weight."""
    t = _program(TA, name)
    rng = np.random.default_rng(3)
    v = rng.random(64).astype(np.float32) * 50
    v[::7] = TA.BIG
    v = torch.from_numpy(v)
    w = torch.from_numpy(rng.integers(1, 65, 64).astype(np.float32))
    sender = {t.primary: v}
    a = t.compute(sender, w, {t.primary: v})
    b = compute_op(t.kernel_compute, v, w)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_run_apply_keeps_scratch_slot_and_gather_meta():
    p = TA.sssp(0)
    m = {"dist": torch.tensor([0.0, 5.0, TA.BIG])}
    out = p.run_apply(m, torch.tensor([1.0, 2.0, -7.0]), torch.tensor(0))
    assert out["dist"].tolist() == [0.0, 2.0, TA.BIG]
    g = tacc.gather_meta(m, torch.tensor([[2, 0]]))
    assert g["dist"].shape == (1, 2)
