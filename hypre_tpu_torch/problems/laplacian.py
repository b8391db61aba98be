"""Model problem generators — hypre's test problems.

Counterpart of ``hypre_tpu/problems/laplacian.py`` (hypre's
``parcsr_ls/par_laplace.c`` 7-pt generator and the 2-D 5-pt case). A
constant stencil goes straight to the ELL layout: every row has the same
slot structure, so assembly is vectorized neighbour-index arithmetic on
the target device with no sort. Dirichlet boundaries truncate the stencil,
as hypre's generators do.
"""

from __future__ import annotations

import numpy as np
import torch

from hypre_tpu_torch.core.config import (
    PAD_COL, default_real_dtype, resolve_device,
)
from hypre_tpu_torch.seq.ell import EllMatrix


def stencil_to_ell(grid_shape, offsets, coeffs, dtype=None,
                   device=None) -> EllMatrix:
    """Assemble a constant-coefficient stencil operator on a dense grid.

    grid_shape: tuple of grid dims (row index = C-order flattening).
    offsets: (k, ndim) int array of stencil offsets.
    coeffs: (k,) stencil coefficients, aligned with offsets.
    The result carries the ``shifts`` annotation: slot s of row i holds
    column i + shifts[s] wherever it is valid.
    """
    device = resolve_device(device)
    dtype = dtype or default_real_dtype()
    grid_shape = tuple(int(g) for g in grid_shape)
    offsets = np.asarray(offsets, dtype=np.int64)
    ndim = len(grid_shape)
    n = int(np.prod(grid_shape))
    strides = [int(np.prod(grid_shape[d + 1:])) for d in range(ndim)]
    shifts = tuple(int(v) for v in (offsets * np.asarray(strides)).sum(axis=1))
    coeffs = [float(c) for c in np.asarray(coeffs, np.float64)]

    rows = torch.arange(n, dtype=torch.int32, device=device)
    coords = [(rows // strides[d]) % grid_shape[d] for d in range(ndim)]
    cols_list, vals_list = [], []
    for s in range(len(offsets)):
        inside = torch.ones(n, dtype=torch.bool, device=device)
        for d in range(ndim):
            c = coords[d] + int(offsets[s][d])
            inside &= (c >= 0) & (c < grid_shape[d])
        cols_list.append(torch.where(inside, rows + shifts[s],
                                     torch.full_like(rows, PAD_COL)))
        val = torch.full((n,), coeffs[s], dtype=dtype, device=device)
        vals_list.append(torch.where(inside, val, torch.zeros_like(val)))
    return EllMatrix(
        vals=torch.stack(vals_list, dim=1),
        cols=torch.stack(cols_list, dim=1).to(torch.int32),
        n_cols=n,
        shifts=shifts,
    )


def laplacian_2d_5pt(nx: int, ny: int, dtype=None, device=None) -> EllMatrix:
    """-Δ on an nx x ny grid, 5-point stencil (ij.c -laplacian ... -n 2D)."""
    offsets = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
    coeffs = [4.0, -1.0, -1.0, -1.0, -1.0]
    return stencil_to_ell((nx, ny), offsets, coeffs, dtype, device)


def laplacian_3d_7pt(nx: int, ny: int, nz: int, dtype=None,
                     device=None) -> EllMatrix:
    """-Δ on an nx x ny x nz grid, 7-point stencil (par_laplace.c)."""
    offsets = [(0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
               (0, 0, -1), (0, 0, 1)]
    coeffs = [6.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0]
    return stencil_to_ell((nx, ny, nz), offsets, coeffs, dtype, device)
