"""The residual that judges a solve, and a plain Jacobi-preconditioned
conjugate gradient in any floating dtype: the reference put in the
program's place, used as the control of the output check (run in the
precision below the configuration's). ``problem`` is a reference problem
(``reference/problems/``)."""

from __future__ import annotations

import torch


def rel_residual(x: torch.Tensor, b: torch.Tensor, problem,
                 shift: float = 0.0) -> float:
    """||b - A x|| / ||b|| in float64."""
    b64 = b.to(torch.float64)
    r = b64 - problem.apply(x.to(torch.float64), shift)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def pcg_jacobi(b: torch.Tensor, problem, shift: float = 0.0,
               dtype=torch.float64, rtol: float = 1e-6,
               maxiter: int = 400) -> tuple[torch.Tensor, int, bool]:
    """Solve (L + shift I) x = b with every vector and product held in
    ``dtype``; stops when the recursive residual falls under rtol ||b||
    or after ``maxiter`` steps. Returns (x, iterations, converged)."""
    b = b.to(dtype)
    dinv = 1.0 / problem.diagonal(shift, dtype, b.device)
    x = torch.zeros_like(b)
    r = b.clone()
    z = dinv * r
    p = z.clone()
    gamma = (r * z).sum()
    eps = rtol * float(torch.linalg.vector_norm(b.to(torch.float64)))
    it = 0
    while it < maxiter:
        s = problem.apply(p, shift)
        alpha = gamma / (s * p).sum()
        x = x + alpha * p
        r = r - alpha * s
        it += 1
        if float(torch.linalg.vector_norm(r.to(torch.float64))) <= eps:
            return x, it, True
        z = dinv * r
        gamma_new = (r * z).sum()
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
    return x, it, False
