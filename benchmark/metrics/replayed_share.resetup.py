"""Share of the window's setups that the device setup built by replaying
a recorded ladder (``AMGHierarchy.replayed``)."""

from harness.readers import share_of


def read(run):
    return share_of(run, "replayed")
