"""The largest ||b - A x|| / ||b|| (float64) over the sampled calls, A the
reference's operator of that call (L + sigma I)."""

from reference.solve import rel_residual


def read(j):
    if not j.samples:
        return None
    return max(rel_residual(s.x, j.rhs[s.rhs_row], j.problem, s.sigma)
               for s in j.samples)
