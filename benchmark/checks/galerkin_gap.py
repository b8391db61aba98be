"""How far each coarse operator of the judged hierarchies lies from the
Galerkin product of the one above it, the largest over every level:
||A_{l+1} w - P_l^T A_l P_l w|| / ||P_l^T A_l P_l w|| for a probe w,
with A_0 the reference's own operator, so that the chain of operators is
tied to the reference; at the coarsest level, whose operator the program
keeps only as its inverse, ||C P^T A P w - w|| / ||w|| with C that
inverse."""

import torch
from harness.check import rel
from harness.traffic import probe_vector
from reference import sparse


def read(j):
    gaps = []
    for h in j.hierarchies:
        for l, ((av, ac, n), (pv, pc, nc)) in enumerate(h.levels):
            w = probe_vector(nc, j.seed, 64 * h.k + 2 * l + 1, pv.device)
            pw = sparse.matvec(pv, pc, nc, w)
            apw = j.problem.apply(pw, h.sigma) if l == 0 else \
                sparse.matvec(av, ac, n, pw)
            ref = sparse.rmatvec(pv, pc, nc, apw)
            if l + 1 < len(h.levels):
                cv, cc, _ = h.levels[l + 1][0]
                gaps.append(rel(sparse.matvec(cv, cc, nc, w), ref))
            else:
                gaps.append(rel(h.coarse_inv.to(torch.float64) @ ref, w))
    return max(gaps) if gaps else None
