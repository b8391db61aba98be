"""Parallel cyclic reduction — batched tridiagonal direct solver.

Counterpart of ``hypre_tpu/struct/cycred.py``. hypre's CyclicReduction
solver (``struct_ls/cyclic_reduction.c``) is a 1-D multigrid-like direct
method; SMG's line relaxation needs exact tridiagonal solves along grid
lines. Parallel cyclic reduction (PCR) takes ceil(log2 n) elimination
rounds over the whole batch of lines at once, each a handful of
elementwise passes — O(n log n) flops, no sequential recursion.

Solves along the LAST axis; arbitrary leading batch dims.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from hypre_tpu_torch.struct.matrix import StructMatrix


def _shift_last(x: torch.Tensor, o: int, fill: float) -> torch.Tensor:
    """z[..., i] = x[..., i+o], filled with ``fill`` out of range."""
    if o == 0:
        return x
    n = x.shape[-1]
    if abs(o) >= n:
        return torch.full_like(x, fill)
    if o > 0:
        return F.pad(x[..., o:], (0, o), value=fill)
    return F.pad(x[..., :n + o], (-o, 0), value=fill)


def pcr_solve(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              d: torch.Tensor) -> torch.Tensor:
    """Solve a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i] along the last
    axis. a[..., 0] and c[..., -1] are ignored (forced to 0)."""
    n = a.shape[-1]
    if n == 1:
        return d / b
    zero_first = torch.ones(n, dtype=a.dtype, device=a.device)
    zero_first[0] = 0
    zero_last = torch.ones(n, dtype=a.dtype, device=a.device)
    zero_last[-1] = 0
    a = a * zero_first
    c = c * zero_last
    steps = max(1, math.ceil(math.log2(n)))
    s = 1
    for _ in range(steps):
        b_lo = _shift_last(b, -s, 1.0)  # b[i-s]
        b_hi = _shift_last(b, +s, 1.0)  # b[i+s]
        alpha = -a / b_lo
        beta = -c / b_hi
        d = d + alpha * _shift_last(d, -s, 0.0) + beta * _shift_last(d, +s, 0.0)
        b = b + alpha * _shift_last(c, -s, 0.0) + beta * _shift_last(a, +s, 0.0)
        a = alpha * _shift_last(a, -s, 0.0)
        c = beta * _shift_last(c, +s, 0.0)
        s *= 2
    return d / b


def cyclic_reduction_solve(A: StructMatrix, b: torch.Tensor) -> torch.Tensor:
    """Direct solve of a 1-D StructMatrix system (HYPRE_CycRedSolve
    analogue). A must be 1-D with offsets within {-1, 0, +1}."""
    if A.ndim != 1:
        raise ValueError("cyclic reduction is the 1-D direct solver")
    zero = torch.zeros(A.shape, dtype=A.dtype, device=A.device)
    lo, di, hi = zero, zero, zero
    for s, off in enumerate(A.stencil.offsets):
        coeff = A.coeff(s)
        if off[0] == -1:
            lo = lo + coeff
        elif off[0] == 0:
            di = di + coeff
        elif off[0] == 1:
            hi = hi + coeff
        else:
            raise ValueError("cyclic reduction needs a tridiagonal stencil")
    return pcr_solve(lo, di, hi, b)
