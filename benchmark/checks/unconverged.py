"""Calls of the window whose solve says it did not converge."""


def read(j):
    return sum(not c["converged"] for c in j.calls) if j.calls else None
