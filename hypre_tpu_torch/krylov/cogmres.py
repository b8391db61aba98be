"""COGMRES — communication-optimal GMRES (hypre krylov/cogmres.c).

Counterpart of ``hypre_tpu/krylov/cogmres.py``. Each Arnoldi step takes
the projections ``V w`` and ``w . w`` together and gets the norm of the
orthogonalized vector from the Pythagorean identity

    ||w - V^T h||^2 = ||w||^2 - ||h||^2

instead of a second reduction (hypre's gs_option 1); ``gs_passes=2`` adds
the delayed reorthogonalization pass, whose coefficients are taken off the
same identity. Restarts, stopping test and host reads are those of
``gmres.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from hypre_tpu_torch.core.config import (
    ConvergenceInfo, make_convergence_info, resolve_device,
)
from hypre_tpu_torch.krylov.base import LinearOp, identity_precond, zero_rhs
from hypre_tpu_torch.krylov.gmres import arnoldi_rotate, ls_update, safe_div
from hypre_tpu_torch.seq.vector import norm2


def cogmres(
    A: LinearOp,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[LinearOp] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
    k_dim: int = 30,
    gs_passes: int = 2,
    logging: int = 0,
    device=None,
) -> tuple[torch.Tensor, ConvergenceInfo]:
    """Restarted COGMRES; the stopping semantics of ``gmres``. ``logging``
    is accepted for signature parity and records nothing, as in the
    reference."""
    device = resolve_device(device)
    b = b.to(device)
    done = zero_rhs(b)
    if done is not None:
        return done
    M = M or identity_precond
    x = torch.zeros_like(b) if x0 is None else x0.to(device)
    n, dtype = b.shape[0], b.dtype

    den = norm2(M(b))
    tol = torch.clamp(rtol * den, min=atol)
    z = M(b - A(x))
    r_norm = norm2(z)
    it = 0
    while it < maxiter and bool((r_norm > tol) & torch.isfinite(r_norm)):
        V = torch.zeros((k_dim + 1, n), dtype=dtype, device=device)
        V[0] = safe_div(z, r_norm)
        R = torch.zeros((k_dim + 1, k_dim), dtype=dtype, device=device)
        cs = torch.zeros(k_dim, dtype=dtype, device=device)
        sn = torch.zeros(k_dim, dtype=dtype, device=device)
        g = torch.zeros(k_dim + 1, dtype=dtype, device=device)
        g[0] = r_norm
        m = 0
        for j in range(min(k_dim, maxiter - it)):  # stop at maxiter
            Vj = V[: j + 1]
            w = M(A(V[j]))
            # one fused reduction, [V w ; w . w]
            h = Vj @ w
            ww = torch.dot(w, w)
            w1 = w - h @ Vj
            wperp2 = torch.clamp(ww - torch.dot(h, h), min=0.0)
            if gs_passes >= 2:
                # delayed reorthogonalization (gs_option 2+)
                h2 = Vj @ w1
                w1 = w1 - h2 @ Vj
                h = h + h2
                wperp2 = torch.clamp(wperp2 - torch.dot(h2, h2), min=0.0)
            h_next = torch.sqrt(wperp2)
            V[j + 1] = safe_div(w1, h_next)
            R[:, j], res_est = arnoldi_rotate(h, h_next, cs, sn, g, j,
                                              k_dim + 1)
            m = j + 1
            if not bool((res_est > tol) & (h_next > 0)):
                break
        x = x + ls_update(R, g, m) @ V[:m]
        z = M(b - A(x))
        r_norm = norm2(z)
        it += m

    rel = r_norm / torch.where(den > 0, den, torch.ones_like(den))
    return x, make_convergence_info(it, rel, (r_norm <= tol) | (den == 0))
