"""Share of the traced segment in which no operation ran on the device."""

from harness.readers import idle_share


def read(run):
    return idle_share(run)
