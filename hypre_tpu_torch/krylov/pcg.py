"""Preconditioned conjugate gradients.

Counterpart of ``hypre_tpu/krylov/pcg.py`` (hypre's ``krylov/pcg.c``,
solve loop at ``pcg.c:283``) with the same stopping semantics:

- ``two_norm=False`` (hypre default): convergence in the preconditioner
  energy norm <r, C r> relative to <b, C b>;
- ``two_norm=True``: plain <r, r> relative to <b, b>;
- absolute tolerance ``atol`` combined as max(rtol*||b||, atol);
- zero-rhs short-circuit; NaN/Inf divergence guard (``pcg.c:391``).

The reference's ``lax.while_loop`` is a Python loop here that reads the
stopping test back to the host once per iteration.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from hypre_tpu_torch.core.config import (
    ConvergenceInfo, make_convergence_info, resolve_device,
)
from hypre_tpu_torch.core.timing import annotate
from hypre_tpu_torch.krylov.base import LinearOp, identity_precond, zero_rhs
from hypre_tpu_torch.seq.vector import dot as vdot


def pcg(
    A: LinearOp,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[LinearOp] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
    two_norm: bool = True,
    cf_tol: float = 0.0,
    logging: int = 0,
    recompute_residual: bool = False,
    recompute_residual_p: int = 0,
    residual_fn: Optional[LinearOp] = None,
    final_residual: bool = True,
    device=None,
    mesh=None,
) -> tuple[torch.Tensor, ConvergenceInfo]:
    """Solve A x = b. ``b`` and ``x0`` are moved to ``device`` (CUDA
    unless the caller names another); ``A`` and ``M`` must run there.

    logging > 0 records per-iteration residual norms into
    ``info.res_history`` (hypre's SetLogging norms array).

    cf_tol > 0 enables hypre's slow-convergence cutoff (pcg.c:727-749):
    stop when the damped running average convergence factor exceeds it.

    recompute_residual: on a tentative convergence, recompute r = b - A x,
    redo the test and go on with the fresh r if it fails
    (HYPRE_PCGSetRecomputeResidual); three failing true-residual tests in a
    row without a 10% drop stop the solve with stagnated=True.
    recompute_residual_p: every p iterations replace the recurrence update
    with the true residual.
    final_residual (default on): after the loop, recompute r = b - A x
    once and report that as the relative residual.
    residual_fn: optional exact-residual evaluator x -> b - A x.
    mesh: the ``dist`` mesh the vectors are split over (each process
    holds its rows): the inner products become global sums. None, or a
    ``local`` mesh, computes what it always did.

    Under a recording profiler the call is the span ``pcg.solve`` and
    each iteration's body ``pcg.iter``; the stopping test's read lies
    between two iterations.
    """
    with annotate("pcg.solve"):
        device = resolve_device(device)
        b = b.to(device)
        dot = functools.partial(vdot, mesh=mesh)
        done = zero_rhs(b, maxiter + 1 if logging > 0 else None,
                        False if recompute_residual else None, mesh=mesh)
        if done is not None:
            return done
        M = M or identity_precond
        x = torch.zeros_like(b) if x0 is None else x0.to(device)
        res_fn = (residual_fn if residual_fn is not None
                  else (lambda xv: b - A(xv)))

        r = b - A(x)
        z = M(r)
        gamma = dot(r, z)
        bi_prod = dot(b, b) if two_norm else dot(b, M(b))
        eps = torch.clamp(rtol * rtol * bi_prod, min=atol * atol)
        i_prod = dot(r, r) if two_norm else gamma
        i_prod0 = i_prod
        p = z
        it = 0
        ok = torch.tensor(True, device=device)
        cf_ave = torch.zeros((), dtype=i_prod.dtype, device=device)
        last_recomp = torch.tensor(math.inf, dtype=i_prod.dtype,
                                   device=device)
        stall = torch.zeros((), dtype=torch.int32, device=device)
        if logging > 0:
            norms = torch.full((maxiter + 1,), -1.0, dtype=i_prod.dtype,
                               device=device)
            norms[0] = torch.sqrt(torch.clamp(i_prod, min=0.0))
        else:
            norms = None

        while it < maxiter and bool((i_prod > eps) & ok):
            with annotate("pcg.iter"):
                s = A(p)
                sdotp = dot(s, p)
                alpha = gamma / sdotp
                x = x + alpha * p
                restart = (recompute_residual_p > 0
                           and (it + 1) % recompute_residual_p == 0)
                r = res_fn(x) if restart else r - alpha * s
                z = M(r)
                gamma_new = dot(r, z)
                i_prod = dot(r, r) if two_norm else gamma_new
                true_event = restart
                if recompute_residual:
                    # tentative pass -> recompute r from scratch and redo
                    # the test (the fresh r is kept either way, as
                    # pcg.c:672-690 does)
                    tentative = bool(i_prod <= eps)
                    if tentative:
                        r = res_fn(x)
                        z = M(r)
                        gamma_new = dot(r, z)
                        i_prod = dot(r, r) if two_norm else gamma_new
                    true_event = true_event or tentative
                ok = torch.isfinite(i_prod) & (sdotp != 0)
                if recompute_residual:
                    # stagnation exit: a failing true-residual test that
                    # has not dropped by 10% since the previous failing
                    # one counts a stall; three in a row stop the solve
                    # (converged=False, stagnated)
                    if true_event and bool(i_prod > eps):
                        improved = bool(i_prod <= 0.9 * last_recomp)
                        stall = (torch.zeros_like(stall) if improved
                                 else stall + 1)
                        last_recomp = i_prod
                    ok = ok & (stall < 3)
                if cf_tol > 0.0:
                    # hypre pcg.c:727-749: average convergence factor over
                    # all iterations, weighted down while the estimate is
                    # still moving
                    safe0 = torch.where(i_prod0 > 0, i_prod0,
                                        torch.ones_like(i_prod0))
                    cf_new = torch.pow(torch.clamp(i_prod / safe0, min=0.0),
                                       1.0 / (2.0 * (it + 1)))
                    denom = torch.clamp(torch.maximum(cf_new, cf_ave),
                                        min=1e-300)
                    weight = 1.0 - (cf_new - cf_ave).abs() / denom
                    ok = ok & (weight * cf_new <= cf_tol)
                    cf_ave = cf_new
                beta = gamma_new / gamma
                p = z + beta * p
                gamma = gamma_new
                it += 1
                if norms is not None:
                    norms[it] = torch.sqrt(torch.clamp(i_prod, min=0.0))

        safe_bi = torch.where(bi_prod > 0, bi_prod,
                              torch.ones_like(bi_prod))
        if final_residual:
            rf = res_fn(x)
            i_rep = dot(rf, rf) if two_norm else dot(rf, M(rf))
        else:
            i_rep = i_prod
        rel_res = torch.sqrt(torch.clamp(i_rep, min=0.0) / safe_bi)
        converged = ((i_prod <= eps) & ok) | (bi_prod == 0)
        return x, make_convergence_info(
            it, rel_res, converged,
            res_history=norms,
            stagnated=(stall >= 3) if recompute_residual else None,
        )
