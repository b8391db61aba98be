"""Smoothers (hypre_BoomerAMGRelax dispatch, parcsr_ls/par_relax.c:23).

Counterpart of ``hypre_tpu/amg/relax.py`` for the pointwise-parallel
smoothers hypre prefers on devices: weighted Jacobi, ℓ1-Jacobi (relax 18)
and Chebyshev (par_cheby.c) with its eigenvalue estimates. Each smoother is
a plain function (A, vectors) -> u over any operator with ``mv``.
"""

from __future__ import annotations

import torch

from hypre_tpu_torch.core.config import hash_rand01


def jacobi(A, dinv: torch.Tensor, u: torch.Tensor, f: torch.Tensor,
           weight: float = 1.0) -> torch.Tensor:
    return u + weight * dinv * (f - A.mv(u))


def l1_norms(A) -> torch.Tensor:
    """ℓ1 row norms d_i = sum_j |a_ij| (hypre relax-18 l1_norms array)."""
    d = A.abs_row_sums()
    return torch.where(d > 0, d, torch.ones_like(d))


def l1_jacobi(A, l1inv: torch.Tensor, u: torch.Tensor,
              f: torch.Tensor) -> torch.Tensor:
    return u + l1inv * (f - A.mv(u))


def _start_vector(A) -> torch.Tensor:
    n = A.vec_len_rows
    idx = torch.arange(n, dtype=torch.int64, device=A.device)
    return hash_rand01(idx).to(A.dtype) - 0.5


def max_eig_estimate(A, dinv: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Power-method estimate of lambda_max(D^-1 A) with hypre's 10% safety
    margin (hypre_ParCSRMaxEigEstimate, par_relax_more.c:136)."""
    x = _start_vector(A)
    x = x / torch.linalg.vector_norm(x)
    for _ in range(iters):
        y = dinv * A.mv(x)
        x = y / torch.linalg.vector_norm(y)
    y = dinv * A.mv(x)
    return 1.1 * torch.dot(x, y) / torch.dot(x, x)


def max_eig_estimate_cg(
    A, dinv: torch.Tensor, iters: int = 10
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lanczos estimate of the extreme eigenvalues of D^{-1}A
    (hypre_ParCSRMaxEigEstimateCG, par_relax_more.c:173), run on the
    symmetrized B = D^{-1/2} A D^{-1/2}; returns (lambda_max, lambda_min)."""
    n = A.vec_len_rows
    iters = min(iters, n)
    s = torch.sqrt(dinv.abs())
    v = _start_vector(A)
    v = v / torch.linalg.vector_norm(v)
    alphas = torch.zeros(iters, dtype=A.dtype, device=A.device)
    betas = torch.zeros(iters, dtype=A.dtype, device=A.device)
    v_prev, v_cur = torch.zeros_like(v), v
    for j in range(iters):
        w = s * A.mv(s * v_cur)
        alpha = torch.dot(v_cur, w)
        w = w - alpha * v_cur
        if j > 0:
            w = w - betas[j - 1] * v_prev
        beta = torch.linalg.vector_norm(w)
        w = torch.where(beta > 0, w / torch.where(beta > 0, beta, 1.0), w)
        alphas[j] = alpha
        betas[j] = beta
        v_prev, v_cur = v_cur, w
    T = (torch.diag(alphas) + torch.diag(betas[: iters - 1], 1)
         + torch.diag(betas[: iters - 1], -1))
    eigs = torch.linalg.eigvalsh(T)
    return eigs[-1], eigs[0].clamp(min=0.0)


def chebyshev(
    A,
    dinv: torch.Tensor,
    lmax: torch.Tensor,
    u: torch.Tensor,
    f: torch.Tensor,
    order: int = 2,
    eig_ratio: float = 0.3,
) -> torch.Tensor:
    """Chebyshev smoothing of order ``order`` on D^{-1}A over
    [eig_ratio*lmax, lmax] (hypre cheby_fraction default 0.3), in the
    three-term residual-correction form: SpMV and axpy only."""
    lmin = eig_ratio * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    r = dinv * (f - A.mv(u))
    rho = 1.0 / sigma
    d = r / theta
    u = u + d
    for _ in range(order - 1):
        r = dinv * (f - A.mv(u))
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        u = u + d
        rho = rho_new
    return u
