"""||z - z_ref|| / ||z_ref||: the program's preconditioner z = M f on one
vector, once the window has closed, against the reference's plain V-cycle
(``reference/cycle.py``) on the same hierarchy's level operators. Every
smoothing sweep, transfer, level product and the coarse solve of the
cycle shows in it; the hierarchy itself is held by ``op0_gap`` and
``galerkin_gap``."""

import torch
from harness.check import rel
from reference.cycle import VCycle, sweeps_of


def read(j):
    p = j.probe
    if p is None:
        return None
    ref = VCycle(p.hierarchy.levels, sweeps_of(j.config["ij_flags"]),
                 torch.float64)
    return rel(p.z.to(torch.float64), ref(p.f))
