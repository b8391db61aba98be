"""Struct Hybrid solver (``struct_ls/hybrid.c``; HYPRE_StructHybrid*).

Counterpart of ``hypre_tpu/struct/hybrid.py``. Same escalation strategy as
the ParCSR hybrid driver, on structured grids: run cheap diagonally scaled
Krylov while monitoring the convergence factor; if it stalls past
``cf_tol`` (hypre's DSCG cutoff), set up PFMG or SMG and finish with
multigrid-preconditioned Krylov from the current iterate. Both phases
apply A through its DIA view, on A's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hypre_tpu_torch.core.config import ConvergenceInfo
from hypre_tpu_torch.krylov import bicgstab, gmres, pcg
from hypre_tpu_torch.struct.matrix import StructMatrix
from hypre_tpu_torch.struct.relax import diag_inverse


@dataclasses.dataclass
class StructHybrid:
    """HYPRE_StructHybridCreate/SetConvergenceTol/SetSolverType protocol."""

    solver_type: str = "pcg"  # 'pcg' | 'gmres' | 'bicgstab'
    precond_type: str = "pfmg"  # 'pfmg' | 'smg'
    cf_tol: float = 0.9
    dscg_max_iter: int = 1000
    krylov_max_iter: int = 200
    precond_knobs: Optional[dict] = None

    A: Optional[StructMatrix] = dataclasses.field(default=None, repr=False)
    dscg_iterations: int = 0
    mg_iterations: int = 0

    def setup(self, A: StructMatrix) -> "StructHybrid":
        self.A = A
        return self

    def _krylov(self, b, x0, M, rtol, atol, maxiter, **kw):
        solver = {"pcg": pcg, "gmres": gmres}.get(self.solver_type, bicgstab)
        if self.solver_type != "pcg":
            kw = {}
        return solver(self.A.mv, b, x0=x0, M=M, rtol=rtol, atol=atol,
                      maxiter=maxiter, device=self.A.device, **kw)

    def solve(
        self,
        b: torch.Tensor,
        x0: Optional[torch.Tensor] = None,
        rtol: float = 1e-8,
        atol: float = 0.0,
    ) -> tuple[torch.Tensor, ConvergenceInfo]:
        A = self.A
        assert A is not None, "call setup(A) first"
        shape = A.shape
        dinv = diag_inverse(A).reshape(-1)
        bflat = b.reshape(-1)
        x0f = None if x0 is None else x0.reshape(-1)
        x, info = self._krylov(bflat, x0f, lambda r: dinv * r, rtol, atol,
                               self.dscg_max_iter, cf_tol=self.cf_tol)
        self.dscg_iterations = int(info.iterations)
        self.mg_iterations = 0
        if bool(info.converged):
            return x.reshape(shape), info

        knobs = self.precond_knobs or {}
        if self.precond_type == "smg":
            from hypre_tpu_torch.struct.smg import SMG

            mg = SMG(**knobs).setup(A)
        else:
            from hypre_tpu_torch.struct.pfmg import PFMG

            mg = PFMG(**knobs).setup(A)
        x, info2 = self._krylov(bflat, x, mg.precond(), rtol, atol,
                                self.krylov_max_iter)
        self.mg_iterations = int(info2.iterations)
        return x.reshape(shape), info2
