"""Algebraic multigrid: strength, PMIS, interpolation, smoothers, hierarchy."""
