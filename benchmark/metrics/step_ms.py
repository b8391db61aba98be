"""The window's time over the re-setup-and-solve steps completed in it
(host clock)."""


def read(run):
    return run.per_call_ms
