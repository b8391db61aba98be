"""Least-squares polynomial preconditioner.

Counterpart of ``hypre_tpu/precond/poly.py``, the analogue of hypre's LSI
polynomial preconditioner (``FEI_mv/fei-hypre/HYPRE_LSI_poly.c``):
M^{-1} = p(A) with p of degree d chosen so that lambda p(lambda) ~ 1 in
the least-squares sense over [0, lambda_max]. With
p(lambda) = sum_j c_j lambda^j the normal equations are the shifted
Hilbert system sum_j c_j L^{i+j+3}/(i+j+3) = L^{i+2}/(i+2), solved once on
the host in float64 (the reference solves the same moment system,
polySetup). lambda_max is the largest absolute row sum (Gershgorin).

The apply is d products with A and axpys (Horner). On the card ``setup``
keeps A in its kernel format (``optimize_operator``: DIA for a stencil
operator), so Horner's products run the DIA kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.fastmv import optimize_operator


def ls_poly_coefficients(lmax: float, degree: int) -> np.ndarray:
    """Coefficients c_0..c_d of the LS polynomial on [0, lmax], in float64
    on the host with diagonal scaling (the raw moment matrix is
    Hilbert-conditioned, which is also why useful degrees stop near 8, as
    the reference's cap)."""
    d = degree
    i, j = np.indices((d + 1, d + 1))
    # G_ij = L^{i+j+3} / (i+j+3), from the integral of lambda^{i+1} lambda^{j+1}
    G = lmax ** (i + j + 3) / (i + j + 3)
    b = lmax ** (i[:, 0] + 2) / (i[:, 0] + 2)
    # scale rows and columns by powers of L: c_j' = c_j L^j
    s = lmax ** np.arange(d + 1)
    cs = np.linalg.solve(G / s[:, None] / s[None, :], b / s)
    return cs / s


@dataclasses.dataclass
class PolyPrecond:
    """HYPRE_LSI_poly object protocol: SetOrder -> Setup -> Solve."""

    order: int = 4

    coeffs: Optional[np.ndarray] = None
    A: object = dataclasses.field(default=None, repr=False)

    def setup(self, A: EllMatrix, optimize="auto",
              device=None) -> "PolyPrecond":
        """Coefficients from A's Gershgorin bound; A is kept on ``device``
        (CUDA unless the caller names another), in its kernel format when
        ``optimize`` ('auto' = on CUDA)."""
        target = resolve_device(device)
        A = A.to(target)
        if optimize == "auto":
            optimize = target.type == "cuda"
        lmax = float(A.vals.abs().sum(dim=1).max())
        self.coeffs = ls_poly_coefficients(lmax, self.order)
        self.A = optimize_operator(A) if optimize else A
        return self

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """p(A) r by Horner's rule: d products with A."""
        cs = self.coeffs
        z = float(cs[-1]) * r
        for c in reversed(cs[:-1]):
            z = self.A.mv(z) + float(c) * r
        return z

    def precond(self):
        return self.apply
