"""Mixed-precision iterative refinement — f64 accuracy from f32 solves.

Counterpart of ``hypre_tpu/refine.py``. A float32 solve's attainable TRUE
residual is limited to ~kappa(A) eps_f32 however small its own residual
test (~2.4e-4 on the 128^3 Laplacian with b = ones). hypre runs in f64
end to end; to meet its tolerances from f32 solves, refine:

    repeat: r = b - A x   (f64, on A's device)
            d = solve_f32(r)  (the fast f32 solve)
            x = x + d         (f64)

Each pass multiplies the true residual by the f32 solve's contraction.
``make_device_refiner`` keeps x as an unevaluated f32 pair instead and
never touches f64, with two-float residuals (``seq/twofloat.py``) when
asked.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.twofloat import dia_residual_2f
from hypre_tpu_torch.seq.vector import norm2


def refine_solve(
    A: EllMatrix,
    solve_f32: Callable,
    b,
    rtol: float = 1e-6,
    max_refine: int = 4,
):
    """Returns (x_f64, true_rel_residual, inner_iteration_total).

    solve_f32(r_f32) -> (d, info) runs the fast solve. The f64 residual is
    A's own ELL product with its values cast to f64 once per call, on A's
    device (the reference takes it from its host C++ matvec); x comes back
    as an f64 tensor there."""
    A64 = dataclasses.replace(A, vals=A.vals.to(torch.float64))
    b64 = torch.as_tensor(b).to(A.device, torch.float64)
    nb = norm2(b64)
    x = torch.zeros_like(b64)
    if not bool(nb > 0):
        return x, 0.0, 0
    total_iters = 0
    rel = 1.0
    for _ in range(max_refine):
        r = b64 - A64.mv(x)
        rel = float(norm2(r) / nb)
        if rel <= rtol:
            break
        d, info = solve_f32(r.to(torch.float32))
        total_iters += int(info.iterations)
        x = x + d.to(torch.float64)
    return x, rel, total_iters


def make_device_refiner(inner_solve, passes: int = 3,
                        residual_2f: bool = False):
    """Refinement on the device in f32 only: x is an unevaluated f32 pair
    (x_hi + x_lo), so the accumulated solution carries extra digits, and
    residuals are (b - A x_hi) - A x_lo.

    residual_2f=False: plain f32 residuals, limited by the f32 product's
    own rounding (~1e-4 relative on the bench Laplacians).
    residual_2f=True (DiaMatrix operators): residuals by error-free
    transforms, ~48 significand bits, so that refinement reaches hypre's
    f64-class 1e-8 tolerances in f32 arithmetic.

    inner_solve(Af, *hier_args, r) -> (d, info) is the f32 solve. A LIST of
    them runs one per pass (a tolerance schedule: the first pass does the
    heavy reduction, later passes polish). Returns the plain function
    refined(Af, *hier_args, b) -> (x_hi, x_lo, info of the last pass); the
    reference returns it jitted."""
    solvers = (list(inner_solve) if isinstance(inner_solve, (list, tuple))
               else [inner_solve] * passes)

    def refined(Af, *args_and_b):
        *hier_args, b = args_and_b
        x_hi = torch.zeros_like(b)
        x_lo = torch.zeros_like(b)
        info = None
        for solve_p in solvers:
            if residual_2f:
                # r_lo is below the inner solve's f32 resolution
                r, _ = dia_residual_2f(Af, b, x_hi, x_lo)
            else:
                r = (b - Af.mv(x_hi)) - Af.mv(x_lo)
            d, info = solve_p(Af, *hier_args, r)
            t = x_lo + d  # Fast2Sum accumulation
            hi = x_hi + t
            x_lo = t - (hi - x_hi)
            x_hi = hi
        return x_hi, x_lo, info

    return refined
