"""LOBPCG — locally optimal block preconditioned conjugate gradients.

Counterpart of ``hypre_tpu/krylov/lobpcg.py`` (hypre's ``krylov/lobpcg.c``)
for the smallest eigenpairs of A x = lambda B x. A multivector is an
(n, m) tensor; the projected (3m x 3m) generalized eigenproblem is solved
with ``torch.linalg.eigh`` after B-whitening with a spectral cutoff, which
also absorbs the rank deficiency of the zero P block on the first
iteration. One host read per iteration (the residual test).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from hypre_tpu_torch.krylov.base import LinearOp


def _whiten(Mb: torch.Tensor, cutoff: float):
    """Mb^{-1/2} by eigh with a relative spectral cutoff: dropped
    directions get zero columns; ``keep`` marks the retained ones. The
    cutoff never falls below 50 eps of the working precision."""
    w, V = torch.linalg.eigh(Mb)
    wmax = torch.clamp(w.max(), min=1e-300)
    cutoff = max(cutoff, 50 * torch.finfo(Mb.dtype).eps)
    keep = w > cutoff * wmax
    inv_sqrt = torch.where(
        keep, 1.0 / torch.sqrt(torch.where(keep, w, torch.ones_like(w))),
        torch.zeros_like(w))
    return V * inv_sqrt[None, :], keep


def lobpcg(
    A: LinearOp,
    X0: torch.Tensor,
    B: Optional[LinearOp] = None,
    T: Optional[LinearOp] = None,
    tol: float = 1e-6,
    maxiter: int = 100,
    cutoff: float = 1e-10,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The m smallest eigenpairs from the (n, m) initial block ``X0``
    (on the device the operators run on). A, B and T act column-wise on
    (n, m) multivectors (lift single-vector operators with ``block_op``).
    Returns (eigenvalues (m,), eigenvectors (n, m), residual norms
    (m,))."""
    Bop = B or (lambda V: V)
    Top = T or (lambda V: V)
    n, m = X0.shape

    def rayleigh_ritz(S):
        """Project, whiten, solve the small eigenproblem: (theta, C)."""
        G = S.T @ A(S)
        Mb = S.T @ Bop(S)
        G = 0.5 * (G + G.T)
        Mb = 0.5 * (Mb + Mb.T)
        W, keep = _whiten(Mb, cutoff)
        Gw = W.T @ G @ W
        # dropped directions leave zero rows and columns whose spurious
        # zero eigenvalues would sort below the spectrum: move them up
        big = 2.0 * Gw.abs().max() + 1.0
        Gw = Gw + torch.diag(torch.where(keep, torch.zeros_like(big), big))
        theta, Y = torch.linalg.eigh(0.5 * (Gw + Gw.T))
        return theta, W @ Y

    def residual(X, lam):
        return A(X) - Bop(X) * lam[None, :]

    theta, C = rayleigh_ritz(X0)
    X, lam = X0 @ C[:, :m], theta[:m]
    rn = torch.linalg.vector_norm(residual(X, lam), dim=0)
    P = torch.zeros_like(X)
    it = 0
    while it < maxiter and bool(
            (rn > tol * torch.clamp(lam.abs(), min=1.0)).any()):
        S = torch.cat([X, Top(residual(X, lam)), P], dim=1)
        theta, C = rayleigh_ritz(S)
        Cm = C[:, :m]
        X = S @ Cm
        # the W and P parts of the update become the next P
        Cp = Cm.clone()
        Cp[:m] = 0.0
        P = S @ Cp
        pn = torch.linalg.vector_norm(P, dim=0)
        P = P / torch.where(pn > 0, pn, torch.ones_like(pn))[None, :]
        lam = theta[:m]
        rn = torch.linalg.vector_norm(residual(X, lam), dim=0)
        it += 1
    return lam, X, rn


def block_op(op: LinearOp) -> Callable[[torch.Tensor], torch.Tensor]:
    """Lift a single-vector operator to (n, m) multivectors, column by
    column (the reference's vmap)."""
    return lambda V: torch.stack(
        [op(V[:, i].contiguous()) for i in range(V.shape[1])], dim=1)
