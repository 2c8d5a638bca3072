"""Arithmetic the metric readers share."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank `q`-th percentile (q in (0, 100]) of all `values`."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]


def idle_share(run):
    """% of the traced window in which no operation ran on the device."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def ell_record(args, kwargs):
    """What a traced run keeps of an `ell_combine`/`ell_combine_batched`
    call: the slice's neighbour ids (the pack's own tensor), the shape of
    the values and the Compute op. The values themselves are not kept."""
    return args[0], tuple(args[2].shape), args[3]


def roofline_share(run, op: str, kernels):
    """% of the roofline reached by the calls into `ops.<op>` in the traced
    window (recorded by `ell_record`): the least time their bytes and
    operations need over the device time of the kernels named `kernels`.
    None where no call or no kernel time was recorded."""
    from graphbench import roofline

    if run.trace is None:
        return None
    calls = run.trace.calls.get(op, [])
    seconds = run.trace.kernel_s(kernels)
    if not calls or seconds <= 0:
        return None
    works, bound = {}, 0.0
    for nbr, vals_shape, compute in calls:
        key = (nbr.data_ptr(), tuple(nbr.shape))
        if key not in works:
            works[key] = roofline.slice_work(nbr, vals_shape[0] - 1)
        lanes = vals_shape[1] if len(vals_shape) > 1 else 1
        nbytes, ops = roofline.ell_combine_cost(works[key], compute, lanes)
        bound += roofline.bound_s(nbytes, ops)
    return 100.0 * bound / seconds
