"""LGMRES — GMRES augmented with earlier restarts' corrections.

Counterpart of ``hypre_tpu/krylov/lgmres.py`` (hypre's ``krylov/lgmres.c``,
Baker/Jessup/Manteuffel): each restart runs ``k_dim`` Arnoldi steps from
the current residual and then up to ``aug_dim`` more whose operator inputs
are the unit corrections of the last restarts. The update runs through the
inputs (V rows, then the stored corrections), and the new correction
x_new - x_old, normalized, joins the store at its front. Host reads as in
``gmres.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from hypre_tpu_torch.core.config import (
    ConvergenceInfo, make_convergence_info, resolve_device,
)
from hypre_tpu_torch.krylov.base import LinearOp, identity_precond, zero_rhs
from hypre_tpu_torch.krylov.gmres import (
    arnoldi_rotate, cgs_project, ls_update, safe_div,
)
from hypre_tpu_torch.seq.vector import norm2


def lgmres(
    A: LinearOp,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[LinearOp] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
    k_dim: int = 20,
    aug_dim: int = 2,
    device=None,
) -> tuple[torch.Tensor, ConvergenceInfo]:
    """Solve A x = b; the stopping semantics of ``gmres``."""
    device = resolve_device(device)
    b = b.to(device)
    done = zero_rhs(b)
    if done is not None:
        return done
    M = M or identity_precond
    x = torch.zeros_like(b) if x0 is None else x0.to(device)
    n, dtype = b.shape[0], b.dtype
    total = k_dim + aug_dim

    den = norm2(M(b))
    tol = torch.clamp(rtol * den, min=atol)
    aug = []  # unit corrections, newest first, at most aug_dim
    z = M(b - A(x))
    r_norm = norm2(z)
    it = 0
    while it < maxiter and bool((r_norm > tol) & torch.isfinite(r_norm)):
        V = torch.zeros((total + 1, n), dtype=dtype, device=device)
        V[0] = safe_div(z, r_norm)
        R = torch.zeros((total + 1, total), dtype=dtype, device=device)
        cs = torch.zeros(total, dtype=dtype, device=device)
        sn = torch.zeros(total, dtype=dtype, device=device)
        g = torch.zeros(total + 1, dtype=dtype, device=device)
        g[0] = r_norm
        m = 0
        # the steps past the stored corrections would be inert; none runs
        # past maxiter (hypre's krylov/lgmres.c)
        for j in range(min(k_dim + len(aug), maxiter - it)):
            u = V[j] if j < k_dim else aug[j - k_dim]
            w, h = cgs_project(V[: j + 1], M(A(u)), 2)
            h_next = norm2(w)
            V[j + 1] = safe_div(w, h_next)
            R[:, j], res_est = arnoldi_rotate(h, h_next, cs, sn, g, j,
                                              total + 1)
            m = j + 1
            if not bool((res_est > tol) & (h_next > 0)):
                break
        y = ls_update(R, g, m)
        mk = min(m, k_dim)
        dx = y[:mk] @ V[:mk]
        if m > k_dim:
            dx = dx + y[k_dim:] @ torch.stack(aug[: m - k_dim])
        x = x + dx
        if aug_dim > 0:
            aug = [safe_div(dx, norm2(dx))] + aug[: aug_dim - 1]
        z = M(b - A(x))
        r_norm = norm2(z)
        it += m

    rel = r_norm / torch.where(den > 0, den, torch.ones_like(den))
    return x, make_convergence_info(it, rel, (r_norm <= tol) | (den == 0))
