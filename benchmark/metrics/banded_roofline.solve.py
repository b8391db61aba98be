"""Share of the roofline of the banded kernels (``csrc/banded_spmv.cu``,
products and transposed products): the function bytes of the operators
they applied over 3.35 TB/s, over their device time in the traced
segment."""

from harness.readers import roofline_share


def read(run):
    return roofline_share(run, "banded", "banded_spmv")
