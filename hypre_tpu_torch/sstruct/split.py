"""Split solver — block-diagonal per-part struct solves.

Counterpart of ``hypre_tpu/sstruct/split.py`` (HYPRE_SStructSplit*,
``sstruct_ls/HYPRE_sstruct_split.c:261``): each iteration solves every
part's structured system independently (SMG or PFMG as the per-part
sub-solver), treating the U couplings with the current iterate — block
Jacobi over parts. Used standalone or as a Krylov preconditioner. The
reference's ``lax.while_loop`` is a host loop with one read per
iteration (``struct/jacobi.py::stationary_solve``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hypre_tpu_torch.core.config import ConvergenceInfo
from hypre_tpu_torch.sstruct.matrix import SStructMatrix
from hypre_tpu_torch.struct.jacobi import stationary_solve
from hypre_tpu_torch.struct.pfmg import PFMG
from hypre_tpu_torch.struct.smg import SMG


@dataclasses.dataclass
class SplitSolver:
    solver: str = "pfmg"  # 'pfmg' | 'smg' (hypre HYPRE_SSTRUCT_SOLVER_*)
    max_iter: int = 100
    sub_cycles: int = 1  # V-cycles per part per outer iteration

    A: Optional[SStructMatrix] = dataclasses.field(default=None, repr=False)
    subs: Optional[list] = dataclasses.field(default=None, repr=False)

    def setup(self, A: SStructMatrix) -> "SplitSolver":
        """Set up one sub-solver per part, on A's device."""
        self.A = A
        mk = PFMG if self.solver == "pfmg" else SMG
        self.subs = [mk().setup(P) for P in A.parts]
        return self

    def _sweep(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One outer iteration: per-part MG cycles on the part residual
        systems (U couplings lagged, hypre's split iteration)."""
        A = self.A
        r = b - A.mv(x)
        out = []
        for sub, rp, xp in zip(self.subs, A.grid.split(r), A.grid.split(x)):
            e = rp * 0.0
            for _ in range(self.sub_cycles):
                e = sub.cycle(rp, e)
            out.append((xp + e).reshape(-1))
        return torch.cat(out)

    def precond(self):
        assert self.A is not None, "call setup(A) first"
        zero = torch.zeros(self.A.n_rows, dtype=self.A.dtype,
                           device=self.A.device)
        return lambda r: self._sweep(zero, r)

    def solve(
        self,
        b: torch.Tensor,
        x0: Optional[torch.Tensor] = None,
        rtol: float = 1e-6,
        maxiter: Optional[int] = None,
    ) -> tuple[torch.Tensor, ConvergenceInfo]:
        assert self.A is not None, "call setup(A) first"
        return stationary_solve(lambda x: self._sweep(x, b), self.A, b, x0,
                                rtol, maxiter or self.max_iter)
