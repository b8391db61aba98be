"""Structured-grid smoothers (struct_ls/point_relax.c, red_black_gs.c).

Counterpart of ``hypre_tpu/struct/relax.py``: weighted (pointwise) Jacobi
and red-black Gauss-Seidel. RB-GS uses checkerboard masks instead of
strided BoxLoops: both colors are computed as full-grid updates (one
matvec each, through the operator's DIA view) and combined with the
parity mask — the reference's design, double the flops of hypre's strided
loops.
"""

from __future__ import annotations

import torch

from hypre_tpu_torch.struct.matrix import StructMatrix


def diag_inverse(A: StructMatrix) -> torch.Tensor:
    d = A.diagonal()
    nz = d != 0
    return torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                       torch.zeros_like(d))


def weighted_jacobi(
    A: StructMatrix, dinv: torch.Tensor, u: torch.Tensor, f: torch.Tensor,
    weight: float = 2.0 / 3.0,
) -> torch.Tensor:
    """u += w * D^{-1} (f - A u)  (point_relax.c weighted Jacobi)."""
    return u + weight * dinv * (f - A.mv(u))


def parity_mask(shape: tuple[int, ...], device) -> torch.Tensor:
    """Checkerboard: True at 'red' points (coordinate sum even)."""
    idx = torch.zeros((), dtype=torch.int64, device=device)
    for d, n in enumerate(shape):
        idx = idx + torch.arange(n, device=device).reshape(
            [-1 if e == d else 1 for e in range(len(shape))])
    return (idx % 2 == 0).expand(tuple(shape))


def red_black_gs(
    A: StructMatrix,
    dinv: torch.Tensor,
    red: torch.Tensor,
    u: torch.Tensor,
    f: torch.Tensor,
) -> torch.Tensor:
    """One RB-GS sweep (red then black; struct_ls/red_black_gs.c).

    Exact Gauss-Seidel for star stencils (5-pt/7-pt), where same-color
    points never couple; hypre restricts RB-GS to those stencils too.
    """
    u = torch.where(red, u + dinv * (f - A.mv(u)), u)
    u = torch.where(red, u, u + dinv * (f - A.mv(u)))
    return u
