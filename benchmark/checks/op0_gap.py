"""||A0 v - A v|| / ||A v|| for a probe v, the largest over the judged
hierarchies: A0 the fine operator a setup built, A the reference's
operator of that call."""

from harness.check import rel
from harness.traffic import probe_vector
from reference import sparse


def read(j):
    gaps = []
    for h in j.hierarchies:
        vals, cols, n = h.levels[0][0]
        v = probe_vector(n, j.seed, 2 * h.k, vals.device)
        gaps.append(rel(sparse.matvec(vals, cols, n, v),
                        j.problem.apply(v, h.sigma)))
    return max(gaps) if gaps else None
