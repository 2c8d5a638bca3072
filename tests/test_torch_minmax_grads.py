"""The min/max backwards of `kernels.ops.segment_reduce` and
`kernels.ops.embedding_bag` against `jax.grad` of the reference's
`repro/kernels/ref.py` on the CPU: ties split the cotangent equally, empty
segments and dropped ids take nothing, a bag that names one row several
times sends each naming's share to it. The port follows JAX's formulas
(the scatter-extremal rule multiplies by 1 / count, the reduce-max rule
divides by count), so the gradients are held bit for bit where each
table row receives one share, and within rtol 1e-6 where a row sums
several (the deterministic scatter adds them in another association than
XLA's scatter). One case differs by design and is pinned: members beyond
the kernel's identity (f32max / 4; -inf among them) get no gradient, where
JAX counts its -inf initial value as one more tie."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops

SEGMENT_CASES = {
    # (E, num, id range): ids drawn from [lo, hi), sorted ascending
    "ties": (40, 6, (0, 6)),
    "empty_segments": (12, 9, (2, 5)),
    "out_of_range": (30, 5, (-2, 8)),
}


def _segment_inputs(case, d, seed):
    e, num, (lo, hi) = SEGMENT_CASES[case]
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(lo, hi, e)).astype(np.int32)
    shape = (e,) if d == 1 else (e, d)
    vals = rng.integers(0, 3, shape).astype(np.float32)      # small ints: many ties
    w = rng.standard_normal((num,) if d == 1 else (num, d)).astype(np.float32)
    return vals, ids, num, w


def _port_segment_grad(vals, ids, num, combine, w):
    v = torch.from_numpy(vals).requires_grad_()
    out = ops.segment_reduce(v, torch.from_numpy(ids), num, combine)
    (out * torch.from_numpy(w)).sum().backward()
    return v.grad


def _jax_segment_grad(vals, ids, num, combine, w):
    def f(v):
        out = jref.segment_reduce_ref(v, jnp.asarray(ids), num, combine)
        # empty segments are -+inf in JAX: keep the loss finite
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * w)
    return np.asarray(jax.grad(f)(jnp.asarray(vals)))


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("combine", ["min", "max"])
def test_segment_min_max_backward_matches_jax(combine, d, case):
    vals, ids, num, w = _segment_inputs(case, d, seed=d * 7 + len(case))
    got = _port_segment_grad(vals, ids, num, combine, w)
    want = _jax_segment_grad(vals, ids, num, combine, w)
    np.testing.assert_array_equal(got.numpy(), want)
    # shares of a tie are 1 / count of the segment's cotangent: some split
    if case == "ties":
        assert bool(((got != 0) & (got.abs() < torch.from_numpy(np.abs(w)).max())).any())


def test_segment_max_tie_shares_follow_jax():
    """Members (1, 1, 0) of one segment with cotangent 1: 0.5, 0.5, 0."""
    v = torch.tensor([1.0, 1.0, 0.0], requires_grad=True)
    ops.segment_reduce(v, torch.zeros(3, dtype=torch.int32), 1, "max").sum().backward()
    assert v.grad.tolist() == [0.5, 0.5, 0.0]
    want = jax.grad(lambda x: jref.segment_reduce_ref(x, jnp.zeros(3, jnp.int32), 1,
                                                      "max").sum())(jnp.asarray([1.0, 1.0, 0.0]))
    assert np.asarray(want).tolist() == [0.5, 0.5, 0.0]


@pytest.mark.parametrize("combine,beyond", [("max", -np.inf), ("max", -1e38),
                                            ("min", np.inf)])
def test_members_beyond_the_identity_get_no_gradient(combine, beyond):
    """The port's pinned difference from JAX: two members beyond the
    kernel's identity (-f32max/4 for max) in one segment get 0 each; JAX's
    scatter-extremal rule counts its initial -inf as a third tie (g/3 each
    for two -inf members). Members of other segments are unaffected."""
    vals = np.array([beyond, beyond, 2.0, 3.0, 3.0], np.float32)
    ids = np.array([0, 0, 1, 1, 1], np.int32)
    got = _port_segment_grad(vals, ids, 2, combine, np.ones(2, np.float32))
    want = np.asarray(jax.grad(lambda v: jref.segment_reduce_ref(
        v, jnp.asarray(ids), 2, combine).sum())(jnp.asarray(vals)))
    assert got[:2].tolist() == [0.0, 0.0]
    if np.isinf(beyond):
        np.testing.assert_allclose(want[:2], [1 / 3, 1 / 3], rtol=1e-6)
    else:
        assert want[:2].tolist() == [0.5, 0.5]
    keep = [1.0, 0.0, 0.0] if combine == "min" else [0.0, 0.5, 0.5]
    assert got[2:].tolist() == want[2:].tolist() == keep


def test_segment_min_max_backward_repeats_bit_equal():
    vals, ids, num, w = _segment_inputs("ties", 4, seed=3)
    a = _port_segment_grad(vals, ids, num, "max", w)
    b = _port_segment_grad(vals, ids, num, "max", w)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


BAG_CASES = {
    # (V, D, B, K, id range)
    "ties_in_a_bag": (6, 3, 5, 4, (0, 6)),
    "repeated_ids": (4, 5, 6, 6, (0, 2)),
    "negative_ids": (9, 2, 7, 3, (-9, 9)),
    "out_of_range_ids": (7, 4, 8, 5, (-10, 10)),
}


@pytest.mark.parametrize("case", sorted(BAG_CASES))
def test_embedding_bag_max_backward_matches_jax(case):
    v, d, b, k, (lo, hi) = BAG_CASES[case]
    rng = np.random.default_rng(len(case))
    table = rng.integers(0, 3, (v, d)).astype(np.float32)
    idx = rng.integers(lo, hi, (b, k)).astype(np.int32)
    w = rng.standard_normal((b, d)).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(
        jref.embedding_bag_ref(t, jnp.asarray(idx), "max") * w))(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    (ops.embedding_bag(t, torch.from_numpy(idx), "max") * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6, atol=1e-7)
    again = torch.from_numpy(table).requires_grad_()
    (ops.embedding_bag(again, torch.from_numpy(idx), "max")
     * torch.from_numpy(w)).sum().backward()
    assert torch.equal(t.grad.view(torch.int32), again.grad.view(torch.int32))


def test_embedding_bag_max_row_named_three_times():
    """A bag that names one row three times sends 3 x (g / 3) to it."""
    t = torch.tensor([[1.0, 5.0], [2.0, 0.0]], requires_grad=True)
    idx = torch.tensor([[1, 1, 1]], dtype=torch.int32)
    g = torch.tensor([[3.0, 6.0]])
    (ops.embedding_bag(t, idx, "max") * g).sum().backward()
    want = jax.grad(lambda x: jnp.sum(jref.embedding_bag_ref(x, jnp.asarray(idx.numpy()),
                                                             "max") * g.numpy()))(
        jnp.asarray(t.detach().numpy()))
    assert t.grad.tolist() == np.asarray(want).tolist() == [[0.0, 0.0], [3.0, 6.0]]
