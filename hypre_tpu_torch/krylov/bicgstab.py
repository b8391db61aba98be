"""BiCGSTAB — stabilized bi-conjugate gradients (hypre krylov/bicgstab.c).

Counterpart of ``hypre_tpu/krylov/bicgstab.py``: right-preconditioned van
der Vorst BiCGSTAB with hypre's stopping rule (two-norm of the residual
relative to ||b||) and breakdown guards on rho, <rhat, v> and <t, t>. The
reference's ``lax.while_loop`` is a Python loop that reads the stopping
test back once per iteration (twice on the iterations where
``recompute_residual`` has to decide whether to recompute).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from hypre_tpu_torch.core.config import (
    ConvergenceInfo, make_convergence_info, resolve_device,
)
from hypre_tpu_torch.krylov.base import LinearOp, identity_precond, zero_rhs
from hypre_tpu_torch.seq.vector import dot as vdot


def bicgstab(
    A: LinearOp,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[LinearOp] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
    logging: int = 0,
    recompute_residual: bool = False,
    residual_fn: Optional[LinearOp] = None,
    final_residual: bool = True,
    device=None,
    mesh=None,
) -> tuple[torch.Tensor, ConvergenceInfo]:
    """Solve A x = b on ``device`` (CUDA unless the caller names another).

    recompute_residual: on a tentative convergence, recompute r = b - A x,
    redo the test and go on with the fresh r if it fails; three failing
    recomputes in a row without a 10% drop stop the solve with
    stagnated=True. final_residual (default on): report the relative
    residual of a recomputed r = b - A x. residual_fn: optional exact
    residual evaluator x -> b - A x. logging > 0 records ||r|| per
    iteration in ``info.res_history``. mesh: the ``dist`` mesh the
    vectors are split over (global inner products, as ``pcg``)."""
    device = resolve_device(device)
    b = b.to(device)
    dot = functools.partial(vdot, mesh=mesh)
    done = zero_rhs(b, maxiter + 1 if logging > 0 else None,
                    False if recompute_residual else None, mesh=mesh)
    if done is not None:
        return done
    M = M or identity_precond
    x = torch.zeros_like(b) if x0 is None else x0.to(device)
    res_fn = residual_fn if residual_fn is not None else (lambda xv: b - A(xv))

    r = b - A(x)
    rhat = r
    b_prod = dot(b, b)
    eps = torch.clamp(rtol * rtol * b_prod, min=atol * atol)
    v = torch.zeros_like(b)
    p = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=device)
    i_prod = dot(r, r)
    ok = torch.tensor(True, device=device)
    last_recomp = torch.tensor(math.inf, dtype=i_prod.dtype, device=device)
    stall = torch.zeros((), dtype=torch.int32, device=device)
    norms = None
    if logging > 0:
        norms = torch.full((maxiter + 1,), -1.0, dtype=b.dtype, device=device)
        norms[0] = torch.sqrt(torch.clamp(i_prod, min=0.0))
    it = 0
    while it < maxiter and bool((i_prod > eps) & ok):
        rho_new = dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        ph = M(p)
        v = A(ph)
        rv = dot(rhat, v)
        alpha = rho_new / rv
        s = r - alpha * v
        sh = M(s)
        t = A(sh)
        tt = dot(t, t)
        omega = dot(t, s) / torch.where(tt > 0, tt, torch.ones_like(tt))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        i_prod = dot(r, r)
        tentative = False
        if recompute_residual:
            tentative = bool(i_prod <= eps)
            if tentative:
                r = res_fn(x)
                i_prod = dot(r, r)
        ok = torch.isfinite(i_prod) & (rho_new != 0) & (rv != 0) & (tt > 0)
        if recompute_residual:
            if tentative and bool(i_prod > eps):
                # a failing recompute counts a stall unless it dropped 10%
                improved = bool(i_prod <= 0.9 * last_recomp)
                stall = torch.zeros_like(stall) if improved else stall + 1
                last_recomp = i_prod
            ok = ok & (stall < 3)
        rho = rho_new
        it += 1
        if norms is not None:
            norms[it] = torch.sqrt(torch.clamp(i_prod, min=0.0))

    safe_b = torch.where(b_prod > 0, b_prod, torch.ones_like(b_prod))
    if final_residual:
        rf = res_fn(x)
        i_rep = dot(rf, rf)
    else:
        i_rep = i_prod
    rel = torch.sqrt(torch.clamp(i_rep, min=0.0) / safe_b)
    converged = ((i_prod <= eps) & ok) | (b_prod == 0)
    return x, make_convergence_info(
        it, rel, converged, res_history=norms,
        stagnated=(stall >= 3) if recompute_residual else None)
