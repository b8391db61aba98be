"""BoomerAMG setup time a step, mean over the window's steps (host clock,
each setup's end synchronized)."""

from harness.readers import mean_of


def read(run):
    return mean_of(run, "setup_ms")
