"""Restarted GMRES with CGS2 orthogonalization.

Counterpart of ``hypre_tpu/krylov/gmres.py`` (hypre's ``krylov/gmres.c``):
left-preconditioned (w = M(A v)), restart length ``k_dim``, Givens-rotation
least-squares update, and a restart that recomputes the residual from
scratch, so that convergence is decided on a true (preconditioned)
residual. Orthogonalization is classical Gram-Schmidt applied twice
(``gs_passes=2``; 1 gives one pass).

The reference's ``lax.while_loop``/``fori_loop`` pair is two Python loops
here. The Hessenberg column, the rotations and the right-hand side ``g``
stay small tensors on the solve's device; the host reads back one flag per
Arnoldi step (the basis stops growing once the residual estimate passes
the tolerance or the step breaks down) and one per restart (the true
residual test). ``arnoldi_rotate`` and ``ls_update`` are shared with the
other GMRES variants.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from hypre_tpu_torch.core.config import (
    ConvergenceInfo, make_convergence_info, resolve_device,
)
from hypre_tpu_torch.krylov.base import LinearOp, identity_precond, zero_rhs
from hypre_tpu_torch.seq.vector import global_sum
from hypre_tpu_torch.seq.vector import norm2 as vnorm2


def safe_div(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """x / d where d > 0, else 0 (a broken-down basis vector)."""
    pos = d > 0
    return torch.where(pos, x / torch.where(pos, d, torch.ones_like(d)),
                       torch.zeros_like(x))


def arnoldi_rotate(h: torch.Tensor, h_next: torch.Tensor, cs: torch.Tensor,
                   sn: torch.Tensor, g: torch.Tensor, j: int, rows: int):
    """Append Arnoldi column j: apply the j earlier Givens rotations to the
    projections ``h`` (length j+1) and ``h_next``, make the rotation that
    zeroes the subdiagonal, store it in ``cs``/``sn`` and rotate ``g``.
    Returns (the rotated column of length ``rows``, |g[j+1]|, the new
    residual estimate)."""
    hcol = torch.zeros(rows, dtype=h.dtype, device=h.device)
    hcol[: j + 1] = h
    hcol[j + 1] = h_next
    for i in range(j):
        hi, hi1 = hcol[i], hcol[i + 1]
        a = cs[i] * hi + sn[i] * hi1
        b = -sn[i] * hi + cs[i] * hi1
        hcol[i], hcol[i + 1] = a, b
    hj, hj1 = hcol[j], hcol[j + 1]
    denom = torch.sqrt(hj * hj + hj1 * hj1)
    pos = denom > 0
    safe = torch.where(pos, denom, torch.ones_like(denom))
    c = torch.where(pos, hj / safe, torch.ones_like(hj))
    s = torch.where(pos, hj1 / safe, torch.zeros_like(hj1))
    hcol[j] = c * hj + s * hj1
    hcol[j + 1] = 0.0
    cs[j], sn[j] = c, s
    gj = g[j].clone()
    g[j] = c * gj
    g[j + 1] = -s * gj
    return hcol, g[j + 1].abs()


def ls_update(R: torch.Tensor, g: torch.Tensor, m: int) -> torch.Tensor:
    """y solving the m x m upper-triangular system R[:m, :m] y = g[:m]."""
    return torch.linalg.solve_triangular(
        R[:m, :m], g[:m, None], upper=True)[:, 0]


def cgs_project(V: torch.Tensor, w: torch.Tensor, passes: int, mesh=None):
    """w minus its projection on the rows of V, by classical Gram-Schmidt
    ``passes`` times; returns (w, the summed coefficients). On a ``dist``
    mesh each pass's coefficients are one global sum."""
    h = global_sum(V @ w, mesh)
    w = w - h @ V
    for _ in range(passes - 1):
        h2 = global_sum(V @ w, mesh)
        w = w - h2 @ V
        h = h + h2
    return w, h


def gmres(
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
    mesh=None,
) -> tuple[torch.Tensor, ConvergenceInfo]:
    """Solve A x = b. ``b`` and ``x0`` are moved to ``device`` (CUDA
    unless the caller names another); ``A`` and ``M`` must run there.

    Convergence: ||M(b - A x)|| <= max(rtol * ||M b||, atol), tested on
    the true residual at every restart. logging > 0 records the Givens
    residual estimates of every step in ``info.res_history`` (hypre's
    gmres.c norms array). mesh: the ``dist`` mesh the vectors are split
    over (global inner products and projections)."""
    device = resolve_device(device)
    b = b.to(device)
    norm2 = functools.partial(vnorm2, mesh=mesh)
    done = zero_rhs(b, maxiter + 1 if logging > 0 else None, mesh=mesh)
    if done is not None:
        return done
    M = M or identity_precond
    x = torch.zeros_like(b) if x0 is None else x0.to(device)
    n, dtype = b.shape[0], b.dtype

    den = norm2(M(b))
    tol = torch.clamp(rtol * den, min=atol)
    z = M(b - A(x))
    r_norm = norm2(z)
    norms = None
    if logging > 0:
        norms = torch.full((maxiter + k_dim + 1,), -1.0, dtype=dtype,
                           device=device)
        norms[0] = r_norm
    it = 0
    while it < maxiter and bool((r_norm > tol) & torch.isfinite(r_norm)):
        # the end of the last cycle (or the start) left z = M(b - A x)
        V = torch.zeros((k_dim + 1, n), dtype=dtype, device=device)
        V[0] = safe_div(z, r_norm)
        R = torch.zeros((k_dim + 1, k_dim), dtype=dtype, device=device)
        cs = torch.zeros(k_dim, dtype=dtype, device=device)
        sn = torch.zeros(k_dim, dtype=dtype, device=device)
        g = torch.zeros(k_dim + 1, dtype=dtype, device=device)
        g[0] = r_norm
        m = 0
        # hypre's Arnoldi loop stops at max_iter (krylov/gmres.c); the
        # reference finishes the restart cycle and overshoots
        for j in range(min(k_dim, maxiter - it)):
            w, h = cgs_project(V[: j + 1], M(A(V[j])), gs_passes, mesh)
            h_next = norm2(w)
            V[j + 1] = safe_div(w, h_next)
            R[:, j], res_est = arnoldi_rotate(h, h_next, cs, sn, g, j,
                                              k_dim + 1)
            m = j + 1
            if norms is not None:
                norms[it + m] = res_est
            if not bool((res_est > tol) & (h_next > 0)):
                break
        x = x + ls_update(R, g, m) @ V[:m]
        # the true preconditioned residual decides convergence (gmres.c
        # "check for convergence by evaluating the actual residual")
        z = M(b - A(x))
        r_norm = norm2(z)
        it += m

    rel = r_norm / torch.where(den > 0, den, torch.ones_like(den))
    return x, make_convergence_info(
        it, rel, (r_norm <= tol) | (den == 0),
        res_history=None if norms is None else norms[: maxiter + 1])
