"""FlexGMRES — GMRES with a variable (flexible) preconditioner.

Counterpart of ``hypre_tpu/krylov/flexgmres.py`` (hypre's
``krylov/flexgmres.c``): right-preconditioned, storing Z[j] = M(V[j]) so
the preconditioner may change between steps; the update runs through Z.
Orthogonalization is CGS2, and the residual is the unpreconditioned
two-norm. Host reads as in ``gmres.py``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from hypre_tpu_torch.core.config import (
    ConvergenceInfo, make_convergence_info, resolve_device,
)
from hypre_tpu_torch.krylov.base import LinearOp, identity_precond, zero_rhs
from hypre_tpu_torch.krylov.gmres import (
    arnoldi_rotate, cgs_project, ls_update, safe_div,
)
from hypre_tpu_torch.seq.vector import norm2 as vnorm2


def flexgmres(
    A: LinearOp,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[LinearOp] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
    k_dim: int = 30,
    device=None,
    mesh=None,
) -> tuple[torch.Tensor, ConvergenceInfo]:
    """Solve A x = b to ||b - A x|| <= max(rtol * ||b||, atol). mesh: the
    ``dist`` mesh the vectors are split over (global inner products)."""
    device = resolve_device(device)
    b = b.to(device)
    norm2 = functools.partial(vnorm2, mesh=mesh)
    done = zero_rhs(b, mesh=mesh)
    if done is not None:
        return done
    M = M or identity_precond
    x = torch.zeros_like(b) if x0 is None else x0.to(device)
    n, dtype = b.shape[0], b.dtype

    den = norm2(b)
    tol = torch.clamp(rtol * den, min=atol)
    r = b - A(x)
    r_norm = norm2(r)
    it = 0
    while it < maxiter and bool((r_norm > tol) & torch.isfinite(r_norm)):
        V = torch.zeros((k_dim + 1, n), dtype=dtype, device=device)
        V[0] = safe_div(r, r_norm)
        Z = torch.zeros((k_dim, n), dtype=dtype, device=device)
        R = torch.zeros((k_dim + 1, k_dim), dtype=dtype, device=device)
        cs = torch.zeros(k_dim, dtype=dtype, device=device)
        sn = torch.zeros(k_dim, dtype=dtype, device=device)
        g = torch.zeros(k_dim + 1, dtype=dtype, device=device)
        g[0] = r_norm
        m = 0
        for j in range(min(k_dim, maxiter - it)):  # stop at maxiter
            Z[j] = M(V[j])
            w, h = cgs_project(V[: j + 1], A(Z[j]), 2, mesh)
            h_next = norm2(w)
            V[j + 1] = safe_div(w, h_next)
            R[:, j], res_est = arnoldi_rotate(h, h_next, cs, sn, g, j,
                                              k_dim + 1)
            m = j + 1
            if not bool((res_est > tol) & (h_next > 0)):
                break
        # the flexible update runs through the stored Z basis
        x = x + ls_update(R, g, m) @ Z[:m]
        r = b - A(x)
        r_norm = norm2(r)
        it += m

    rel = r_norm / torch.where(den > 0, den, torch.ones_like(den))
    return x, make_convergence_info(it, rel, (r_norm <= tol) | (den == 0))
