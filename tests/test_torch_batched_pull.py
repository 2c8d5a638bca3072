"""The Q-wide pull kernel's fold orders (`csrc/ell_combine_batched.cu`), on
the CPU: each route's order, written out by `ell_combine_slot_lanes_model`
and `ell_combine_column_lanes_model`, is the halving tree of
`ell_combine_batched_plain` and of the reference's
`Combiner.reduce_axis_tree`, bit for bit, for sums too, on the same
numpy-made inputs (sentinels anywhere in a row, values of both signs
over two decades, so that another association order of a sum shows; `BIG`
among them for min and max)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acc as jacc
from repro_torch.kernels import ell_spmv as tell

WIDTHS = [1, 2, 3, 4, 5, 8, 32, 33, 256]
Q = 5


def _case(w: int, combine: str):
    """nbr, wgt, vals as tensors and the per-slot values (R, W, Q) the tree
    folds, for every Compute op: Compute on the gathered row, the identity
    on sentinel slots."""
    rng = np.random.default_rng(w * 7 + len(combine))
    r, n = 23, 90
    nb = rng.integers(0, n, (r, w)).astype(np.int32)
    nb[rng.random((r, w)) < 0.3] = n                          # sentinels anywhere
    wg = rng.random((r, w)).astype(np.float32)
    v = rng.standard_normal((n + 1, Q)) * 10 ** rng.uniform(-1, 1, (n + 1, Q))
    v = v.astype(np.float32)
    if combine != "sum":                                      # BIG would swamp a sum
        v[rng.random((n + 1, Q)) < 0.2] = tell.BIG
    nbr, wgt, vals = torch.from_numpy(nb), torch.from_numpy(wg), torch.from_numpy(v)
    upd = {}
    for op in tell.COMPUTE_OPS:
        x = tell.compute_op(op, vals[nbr.long()], wgt[:, :, None])
        upd[op] = torch.where((nbr == n)[:, :, None], tell.identity(combine), x)
    return nbr, wgt, vals, upd


def _reference_tree(upd: torch.Tensor, combine: str) -> np.ndarray:
    return np.asarray(jacc.Combiner(combine, "vote").reduce_axis_tree(jnp.asarray(upd.numpy()), 1))


def _same_bits(a: torch.Tensor, b) -> bool:
    b = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.array(b))
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("combine", ["sum", "min", "max"])
def test_slot_lanes_model_is_the_halving_tree(w, combine):
    """Every lane count the kernel may take (p / 8 <= L <= min(p, 32)): lane
    l holds slots l, l + L, ...; in-lane chunks, then the shuffles;
    bit-equal to the plain version and to the reference."""
    nbr, wgt, vals, upd = _case(w, combine)
    p = 1 << max(w - 1, 0).bit_length()
    for op, x in upd.items():
        want = tell.ell_combine_batched_plain(nbr, wgt, vals, op, combine)
        ref = _reference_tree(x, combine)
        lanes = max(p // 8, 1)
        while lanes <= min(p, 32):
            got = tell.ell_combine_slot_lanes_model(x, combine, lanes)
            assert _same_bits(got, want), (op, lanes)
            assert _same_bits(got, ref), (op, lanes)
            lanes *= 2


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("combine", ["sum", "min", "max"])
def test_column_lanes_model_is_the_halving_tree(w, combine):
    """Every slot-group count the kernel may take (S <= min(p, 32)): each
    group's bit-reversed counter, then the shuffles over groups."""
    nbr, wgt, vals, upd = _case(w, combine)
    p = 1 << max(w - 1, 0).bit_length()
    for op, x in upd.items():
        want = tell.ell_combine_batched_plain(nbr, wgt, vals, op, combine)
        ref = _reference_tree(x, combine)
        s = 1
        while s <= min(p, 32):
            got = tell.ell_combine_column_lanes_model(x, combine, s)
            assert _same_bits(got, want), (op, s)
            assert _same_bits(got, ref), (op, s)
            s *= 2


def test_models_refuse_layouts_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tell.ell_combine_column_lanes_model(torch.zeros(3, 4, 2), "sum", 8)
    with pytest.raises(ValueError):
        tell.ell_combine_slot_lanes_model(torch.zeros(3, 256, 2), "sum", 16)


@pytest.mark.parametrize("w,lanes", [(1, 1), (2, 2), (3, 2), (4, 2), (5, 2), (8, 2), (16, 4),
                                     (32, 8), (33, 16), (128, 32), (256, 32)])
def test_slot_lanes_are_about_four_slots_a_lane(w, lanes):
    assert tell.slot_lanes(w) == lanes


@pytest.mark.parametrize("q", [1, 2, 3, 4, 8, 16, 64, 65, 130])
def test_each_layout_the_wrapper_picks_folds_in_tree_order(q):
    """The layout `batched_layout` gives each Q, on the RMAT slice widths,
    names a route whose model equals the plain version."""
    rng = np.random.default_rng(q)
    for w in (4, 32, 256):
        x = rng.standard_normal((7, w, q)).astype(np.float32) * 10 ** rng.uniform(-3, 3, (7, w, q))
        upd = torch.from_numpy(x.astype(np.float32))
        lay = tell.batched_layout(q, w, 0, 0)
        if lay.route == "slots":
            got = tell.ell_combine_slot_lanes_model(upd, "sum", lay.slot_groups)
        else:
            got = tell.ell_combine_column_lanes_model(upd, "sum", lay.slot_groups)
        assert lay.column_lanes * lay.slot_groups <= 32
        assert _same_bits(got, tell.halving_tree(upd, 1, "sum")), (w, lay)
