"""PCG iterations a step, mean over the window's steps."""

from harness.readers import mean_of


def read(run):
    return mean_of(run, "iterations")
