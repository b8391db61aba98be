"""CGNR — conjugate gradients on the normal equations (hypre krylov/cgnr.c).

Counterpart of ``hypre_tpu/krylov/cgnr.py``: CG on A^T A x = A^T b for a
square nonsymmetric or a rectangular A, with the textbook CGLS start
p0 = M(A^T r) (hypre's cgnr.c starts from p0 = r and takes more
iterations; ROADMAP Queue 3) and hypre's <r, r> stopping rule. The
optional preconditioner M acts on the normal-equation residual. One host
read per iteration.
"""

from __future__ import annotations

from typing import Optional

import torch

from hypre_tpu_torch.core.config import (
    ConvergenceInfo, make_convergence_info, resolve_device,
)
from hypre_tpu_torch.krylov.base import LinearOp, identity_precond, zero_rhs
from hypre_tpu_torch.seq.vector import dot


def cgnr(
    A: LinearOp,
    At: LinearOp,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[LinearOp] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
    device=None,
) -> tuple[torch.Tensor, ConvergenceInfo]:
    """Minimize ||b - A x||; ``At`` applies A^T."""
    device = resolve_device(device)
    b = b.to(device)
    done = zero_rhs(b)
    if done is not None:
        return done
    M = M or identity_precond
    x = torch.zeros_like(b) if x0 is None else x0.to(device)

    r = b - A(x)
    q = At(r)
    z = M(q)
    gamma = dot(q, z)
    p = z
    b_prod = dot(b, b)
    eps = torch.clamp(rtol * rtol * b_prod, min=atol * atol)
    i_prod = dot(r, r)
    ok = torch.tensor(True, device=device)
    it = 0
    while it < maxiter and bool((i_prod > eps) & ok):
        w = A(p)
        wdotw = dot(w, w)
        alpha = gamma / torch.where(wdotw > 0, wdotw, torch.ones_like(wdotw))
        x = x + alpha * p
        r = r - alpha * w
        q = At(r)
        z = M(q)
        gamma_new = dot(q, z)
        i_prod = dot(r, r)
        ok = torch.isfinite(i_prod) & (wdotw > 0)
        beta = gamma_new / torch.where(gamma != 0, gamma,
                                       torch.ones_like(gamma))
        p = z + beta * p
        gamma = gamma_new
        it += 1

    safe_b = torch.where(b_prod > 0, b_prod, torch.ones_like(b_prod))
    rel = torch.sqrt(torch.clamp(i_prod, min=0.0) / safe_b)
    converged = ((i_prod <= eps) & ok) | (b_prod == 0)
    return x, make_convergence_info(it, rel, converged)
