"""% of its roofline reached by the solo pull kernel (`csrc/ell_combine.cu`):
the bytes its calls need (live slots, each distinct neighbour's value once,
a partial a live row) over 3.35 TB/s, divided by its device time."""

from graphbench.readers import ell_record, roofline_share

WRAP = {"ell_combine": ell_record}
KERNELS = ("ell_scalar", "ell_vector")


def read(run):
    return roofline_share(run, "ell_combine", KERNELS)
