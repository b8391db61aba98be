"""Device kernels in the traced segment over its PCG iterations."""

from harness.readers import launches_per_iter


def read(run):
    return launches_per_iter(run)
