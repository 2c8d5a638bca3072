"""The frozen byte counts behind the roofline shares, from slices whose
work is known by hand."""

from __future__ import annotations

import pytest
import torch

from graphbench import roofline


def slice_(rows, n):
    """An ELL slice from neighbour lists, padded with the sentinel n."""
    w = max(len(r) for r in rows)
    return torch.tensor([r + [n] * (w - len(r)) for r in rows], dtype=torch.int32)


def test_live_slots_rows_and_distinct_neighbours():
    n = 10
    nbr = slice_([[1, 2, 3], [2], [], [9, 9]], n)
    assert roofline.slice_work(nbr, n) == roofline.SliceWork(slots=6, rows=3, distinct=4)


@pytest.mark.parametrize("compute,lanes,want", [
    ("hop", 1, 4 * 6 + 4 * (4 + 3)),
    ("copy", 1, 4 * 6 + 4 * (4 + 3)),
    ("add_w", 1, 8 * 6 + 4 * (4 + 3)),
    ("copy", 64, 4 * 6 + 4 * 64 * (4 + 3)),
])
def test_bytes_count_each_input_once_and_no_padding(compute, lanes, want):
    work = roofline.SliceWork(slots=6, rows=3, distinct=4)
    nbytes, ops = roofline.ell_combine_cost(work, compute, lanes)
    assert nbytes == want and ops == 2 * lanes * 6


def test_a_padded_slice_costs_what_its_live_part_costs():
    n = 100
    tight = slice_([[1, 2], [3, 4]], n)
    padded = torch.cat([slice_([[1, 2, n, n], [3, 4, n, n]], n),
                        torch.full((6, 4), n, dtype=torch.int32)])
    assert roofline.slice_work(tight, n) == roofline.slice_work(padded, n)


def test_bound_takes_the_larger_term():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 134e12) == pytest.approx(2.0)
