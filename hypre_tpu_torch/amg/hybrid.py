"""Hybrid solver — diagonally scaled Krylov with escalation to AMG.

Counterpart of ``hypre_tpu/amg/hybrid.py``, hypre's ParCSR Hybrid
(``parcsr_ls/amg_hybrid.c:1692-2202``): first run cheap diagonally scaled
PCG/GMRES/BiCGSTAB while watching the convergence factor; if it stalls
(PCG's cf > cf_tol, hypre's DSCG cutoff), set BoomerAMG up and finish with
AMG-preconditioned Krylov from the current x. Two solves with host
orchestration between them, as hypre's two solver objects in one driver.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hypre_tpu_torch.amg.boomeramg import BoomerAMG
from hypre_tpu_torch.core.config import (
    ConvergenceInfo, make_convergence_info, resolve_device,
)
from hypre_tpu_torch.krylov import bicgstab, gmres, pcg
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.fastmv import optimize_operator


@dataclasses.dataclass
class HybridSolver:
    """HYPRE_ParCSRHybrid* object protocol (HYPRE_parcsr_ls.h:3097)."""

    solver_type: str = "pcg"  # 'pcg' | 'gmres' | 'bicgstab'
    cf_tol: float = 0.9  # DSCG convergence-factor cutoff (hypre default 0.9)
    dscg_max_iter: int = 1000
    pcg_max_iter: int = 200
    amg: Optional[BoomerAMG] = None  # pre-configured AMG, or defaults

    A: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    dscg_iterations: int = 0
    amg_iterations: int = 0
    # the operator both phases apply: A, or its kernel format on the card
    _op: object = dataclasses.field(default=None, init=False, repr=False)
    _optimize: bool = dataclasses.field(default=False, init=False,
                                        repr=False)

    def setup(self, A: EllMatrix, optimize="auto",
              device=None) -> "HybridSolver":
        """Keep A on ``device`` (CUDA unless the caller names another).
        optimize: apply A, and the AMG hierarchy of the second phase,
        through the kernel formats (DIA or banded); 'auto' = when the
        device is CUDA."""
        target = resolve_device(device)
        self.A = A.to(target)
        if optimize == "auto":
            optimize = target.type == "cuda"
        self._optimize = bool(optimize)
        self._op = optimize_operator(self.A) if optimize else self.A
        return self

    def _krylov(self, M, b, x0, rtol, atol, maxiter, **kw):
        solver = {"pcg": pcg, "gmres": gmres}.get(self.solver_type, bicgstab)
        return solver(self._op.mv, b, x0=x0, M=M, rtol=rtol, atol=atol,
                      maxiter=maxiter, device=self.A.device, **kw)

    def solve(
        self,
        b: torch.Tensor,
        x0: Optional[torch.Tensor] = None,
        rtol: float = 1e-8,
        atol: float = 0.0,
    ) -> tuple[torch.Tensor, ConvergenceInfo]:
        A = self.A
        if A is None:
            raise RuntimeError("call setup(A) first")
        diag = A.diagonal()
        nz = diag != 0
        dinv = torch.where(nz, 1.0 / torch.where(nz, diag,
                                                 torch.ones_like(diag)),
                           torch.ones_like(diag))

        # phase 1: diagonally scaled Krylov with the slow-convergence cutoff
        # (PCG only, as in the reference)
        cut = dict(cf_tol=self.cf_tol) if self.solver_type == "pcg" else {}
        x, info = self._krylov(lambda r: dinv * r, b, x0, rtol, atol,
                               self.dscg_max_iter, **cut)
        self.dscg_iterations = int(info.iterations)
        self.amg_iterations = 0
        if bool(info.converged):
            return x, info

        # phase 2: escalate to AMG-preconditioned Krylov from the current x
        amg = self.amg or BoomerAMG()
        amg.setup(A, optimize=self._optimize, device=A.device)
        x, info2 = self._krylov(amg.precond(), b, x, rtol, atol,
                                self.pcg_max_iter)
        self.amg_iterations = int(info2.iterations)
        total = make_convergence_info(
            self.dscg_iterations + self.amg_iterations,
            info2.relative_residual, info2.converged)
        return x, total
