"""PCG iterations a solve, mean over the window's solves
(``ConvergenceInfo.iterations``)."""

from harness.readers import mean_of


def read(run):
    return mean_of(run, "iterations")
