"""The most Krylov iterations any call of the window took: the whole
cycle's strength, held on every call (a cycle that does less work
converges in more iterations)."""


def read(j):
    return max(c["iterations"] for c in j.calls) if j.calls else None
