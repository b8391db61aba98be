"""The window's time over the solves completed in it (host clock)."""


def read(run):
    return run.per_call_ms
