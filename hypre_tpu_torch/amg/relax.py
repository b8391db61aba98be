"""Smoothers (hypre_BoomerAMGRelax dispatch, parcsr_ls/par_relax.c:23).

Counterpart of ``hypre_tpu/amg/relax.py``: the pointwise-parallel
smoothers hypre prefers on devices — weighted Jacobi, its CF-ordered form,
ℓ1-Jacobi (relax 18), Chebyshev (par_cheby.c) with its eigenvalue
estimates, two-stage Gauss-Seidel (relax 11/12) and simultaneous Kaczmarz
(relax 20). Each smoother is a plain function (A, vectors) -> u over any
level operator: ``mv`` for all, the strict-triangle products
``lower_apply``/``upper_apply`` for the Gauss-Seidel forms and ``mv_t``
for Kaczmarz, which every format (``EllMatrix``, ``DiaMatrix``,
``BandedEll`` without its ELL payload) provides.
"""

from __future__ import annotations

import torch

from hypre_tpu_torch.core.config import fold_sum, hash_rand01


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


def cf_jacobi(A, dinv: torch.Tensor, u: torch.Tensor, f: torch.Tensor,
              cf: torch.Tensor, weight=1.0) -> torch.Tensor:
    """CF-ordered (relax_order=1) Jacobi: the C points first, then the F
    points against the updated C values (hypre's relax_points sweep). cf:
    +1 C, -1 F; rows marked 0 (padding) never change. Takes dinv- or
    l1inv-style scalings."""
    uc = u + weight * dinv * (f - A.mv(u))
    u = torch.where(cf > 0, uc, u)
    uf = u + weight * dinv * (f - A.mv(u))
    return torch.where(cf < 0, uf, u)


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


# ---------------------------------------------------------------------------
# Two-stage Gauss-Seidel (relax 11/12) and Kaczmarz (relax 20)
# ---------------------------------------------------------------------------


def two_stage_gs(A, dinv: torch.Tensor, u: torch.Tensor,
                 f: torch.Tensor) -> torch.Tensor:
    """Forward two-stage GS (relax 11): (D+L)^{-1} approximated by its
    first two Neumann terms, z = D^{-1} r - D^{-1} L D^{-1} r
    (par_relax.c:125-131)."""
    z0 = dinv * (f - A.mv(u))
    return u + z0 - dinv * A.lower_apply(z0)


def sym_two_stage_gs(A, dinv: torch.Tensor, u: torch.Tensor,
                     f: torch.Tensor) -> torch.Tensor:
    """Symmetric variant (relax 12): the forward sweep, then the backward
    one."""
    u = two_stage_gs(A, dinv, u, f)
    z0 = dinv * (f - A.mv(u))
    return u + z0 - dinv * A.upper_apply(z0)


def kaczmarz(A, row_norm_inv: torch.Tensor, u: torch.Tensor,
             f: torch.Tensor, weight=1.0) -> torch.Tensor:
    """Simultaneous Kaczmarz / Cimmino sweep (relax 20):
    u += w A^T diag(1/||a_i||^2) (f - A u); Richardson on the normal
    equations, convergent for any nonsingular A."""
    return u + weight * A.mv_t(row_norm_inv * (f - A.mv(u)))


def row_norms_sq_inv(A) -> torch.Tensor:
    """1 / ||a_i||^2 per row (1 for an empty row), summed in slot order
    from whatever payload the format keeps: DIA planes, the banded
    slot-major copy, or the ELL slab."""
    if hasattr(A, "dvals"):
        s = fold_sum(A.dvals * A.dvals, dim=0)
    elif hasattr(A, "vals_t"):
        s = fold_sum(A.vals_t * A.vals_t, dim=0)[: A.n_rows]
    else:
        s = fold_sum(A.vals * A.vals)
    return 1.0 / torch.where(s > 0, s, torch.ones_like(s))
