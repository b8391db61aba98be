"""Struct Jacobi solver (struct_ls/jacobi.c — driver solver id 8).

Counterpart of ``hypre_tpu/struct/jacobi.py``; the reference's
``lax.while_loop`` is a host loop with one read per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hypre_tpu_torch.core.config import ConvergenceInfo, make_convergence_info
from hypre_tpu_torch.struct.matrix import StructMatrix
from hypre_tpu_torch.struct.relax import diag_inverse, weighted_jacobi


def stationary_solve(step, A: StructMatrix, b: torch.Tensor,
                     x0: Optional[torch.Tensor], rtol: float,
                     maxiter: int) -> tuple[torch.Tensor, ConvergenceInfo]:
    """x <- step(x) until ||b - A x|| <= rtol ||b||, maxiter steps or a
    non-finite residual: the loop of every struct solver's ``solve``
    (the reference's while_loop), one read of the residual per step."""
    x = torch.zeros_like(b) if x0 is None else x0
    b2 = torch.sum(b * b)
    eps = rtol * rtol * b2
    r = b - A.mv(x)
    r2 = torch.sum(r * r)
    it = 0
    while it < maxiter and bool((r2 > eps) & torch.isfinite(r2)):
        x = step(x)
        r = b - A.mv(x)
        r2 = torch.sum(r * r)
        it += 1
    safe_b2 = torch.where(b2 > 0, b2, torch.ones_like(b2))
    rel = torch.sqrt(torch.clamp(r2, min=0.0) / safe_b2)
    return x, make_convergence_info(it, rel, (r2 <= eps) | (b2 == 0))


@dataclasses.dataclass
class StructJacobi:
    weight: float = 1.0
    max_iter: int = 1000

    A: Optional[StructMatrix] = dataclasses.field(default=None, repr=False)
    dinv: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)

    def setup(self, A: StructMatrix) -> "StructJacobi":
        self.A = A
        self.dinv = diag_inverse(A)
        return self

    def solve(
        self,
        b: torch.Tensor,
        x0: Optional[torch.Tensor] = None,
        rtol: float = 1e-6,
        maxiter: Optional[int] = None,
    ) -> tuple[torch.Tensor, ConvergenceInfo]:
        A, dinv = self.A, self.dinv
        maxiter = self.max_iter if maxiter is None else maxiter
        return stationary_solve(
            lambda x: weighted_jacobi(A, dinv, x, b, self.weight), A, b, x0,
            rtol, maxiter)
