"""% of its roofline reached by the batched pull kernel
(`csrc/ell_combine_batched.cu`), counted as `ell_combine_roofline` with
Q lanes of values and partials."""

from graphbench.readers import ell_record, roofline_share

WRAP = {"ell_combine_batched": ell_record}
KERNELS = ("slot_lanes", "column_lanes")


def read(run):
    return roofline_share(run, "ell_combine_batched", KERNELS)
