"""Model problem generators — hypre's driver problem suite.

Counterpart of ``hypre_tpu/problems/laplacian.py``: hypre's
``parcsr_ls/par_laplace.c`` (7-pt), ``par_laplace_9pt.c``,
``par_laplace_27pt.c``, ``par_difconv.c``, ``par_rotate_7pt.c`` and
``par_vardifconv.c``, behind the ``ij`` driver's ``-laplacian/-9pt/-27pt/
-difconv/-rotate/-vardifconv`` flags, plus the 1-D problem and a 2-D
elasticity system. A stencil goes straight to the ELL layout: every row
has the same slot structure, so assembly is vectorized neighbour-index
arithmetic on the target device with no sort, and each result carries the
``shifts`` annotation. Dirichlet boundaries truncate the stencil, as
hypre's generators do.
"""

from __future__ import annotations

import numpy as np
import torch

from hypre_tpu_torch.core.config import (
    PAD_COL, default_real_dtype, resolve_device,
)
from hypre_tpu_torch.seq.csr import HostCSR
from hypre_tpu_torch.seq.ell import EllMatrix, _np_dtype, csr_to_ell


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


def laplacian_2d_9pt(nx: int, ny: int, dtype=None, device=None) -> EllMatrix:
    """9-point Laplacian (par_laplace_9pt.c: 8 on diag, -1 on all 8
    neighbours)."""
    offsets = [(0, 0)] + [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                          if (dx, dy) != (0, 0)]
    coeffs = [8.0] + [-1.0] * 8
    return stencil_to_ell((nx, ny), offsets, coeffs, dtype, device)


def laplacian_3d_27pt(nx: int, ny: int, nz: int, dtype=None,
                      device=None) -> EllMatrix:
    """27-point Laplacian (par_laplace_27pt.c: 26 on diag, -1 on 26
    neighbours)."""
    offsets = [(0, 0, 0)] + [
        (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
        for dz in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0)]
    coeffs = [26.0] + [-1.0] * 26
    return stencil_to_ell((nx, ny, nz), offsets, coeffs, dtype, device)


def difconv_3d_7pt(
    nx: int, ny: int, nz: int, ax: float = 1.0, ay: float = 1.0,
    az: float = 1.0, cx: float = 1.0, cy: float = 0.0, cz: float = 0.0,
    dtype=None, device=None,
) -> EllMatrix:
    """Convection-diffusion -a·Δu + c·∇u, upwind first order
    (par_difconv.c): h = 1/(n+1) per direction, central diffusion and
    upwind convection, a nonsymmetric M-matrix for c != 0."""
    hx, hy, hz = 1.0 / (nx + 1), 1.0 / (ny + 1), 1.0 / (nz + 1)
    # diffusion / h^2 plus upwind convection / h (flow assumed positive)
    wdiag = (2 * ax / hx**2 + 2 * ay / hy**2 + 2 * az / hz**2
             + cx / hx + cy / hy + cz / hz)
    offsets = [(0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
               (0, 0, -1), (0, 0, 1)]
    coeffs = [
        wdiag,
        -ax / hx**2 - cx / hx,
        -ax / hx**2,
        -ay / hy**2 - cy / hy,
        -ay / hy**2,
        -az / hz**2 - cz / hz,
        -az / hz**2,
    ]
    return stencil_to_ell((nx, ny, nz), offsets, coeffs, dtype, device)


def rotated_anisotropy_2d(nx: int, ny: int, eps: float = 0.001,
                          theta_deg: float = 45.0, dtype=None,
                          device=None) -> EllMatrix:
    """Rotated anisotropic diffusion -div(K grad u), K = R(theta)
    diag(1, eps) R(theta)^T, on a 7-point 2-D stencil (par_rotate_7pt.c,
    the ij driver's ``-rotate``)."""
    th = np.deg2rad(theta_deg)
    c, s = np.cos(th), np.sin(th)
    cxx = c * c + eps * s * s
    cyy = s * s + eps * c * c
    cxy = 2 * (1.0 - eps) * c * s
    offsets = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (1, 1)]
    coeffs = [
        2 * cxx + 2 * cyy - cxy,
        -cxx + cxy / 2,
        -cxx + cxy / 2,
        -cyy + cxy / 2,
        -cyy + cxy / 2,
        -cxy / 2,
        -cxy / 2,
    ]
    return stencil_to_ell((nx, ny), offsets, coeffs, dtype, device)


def laplacian_1d(n: int, dtype=None, device=None) -> EllMatrix:
    """-u'' on n points, 3-point stencil (the 1-D driver problem)."""
    return stencil_to_ell((n,), [(0,), (-1,), (1,)], [2.0, -1.0, -1.0],
                          dtype, device)


def elasticity_2d(nx: int, ny: int, lam: float = 1.0, mu: float = 1.0,
                  dtype=None, device=None) -> EllMatrix:
    """2-D linear elasticity (Navier) FD operator, 2 dofs (u, v) per node,
    the systems test problem for nodal AMG (hypre's num_functions=2):

        -( (lam+2mu) u_xx + mu u_yy ) - (lam+mu) v_xy = f_u
        -( mu v_xx + (lam+2mu) v_yy ) - (lam+mu) u_xy = f_v

    Dirichlet truncation at the boundary; node (i, j) owns unknowns
    2*(i*ny+j) + {0, 1}. The reference assembles it in a Python double
    loop over the nodes; here each of its couplings is one vectorized
    block of the same COO entries (no entry repeats, so the CSR does not
    depend on their order). No slot has one column shift on every row
    (u and v rows reach their corners at different offsets), so the
    result carries no ``shifts``, as the reference's does not."""
    device = resolve_device(device)
    dtype = dtype or default_real_dtype()
    n = 2 * nx * ny
    a = lam + 2 * mu
    c4 = (lam + mu) / 4.0
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    nu = 2 * (ii * ny + jj)
    rows, cols, vals = [nu, nu + 1], [nu, nu + 1], [
        np.full(nu.size, 2 * a + 2 * mu), np.full(nu.size, 2 * a + 2 * mu)]
    for di, dj, cu, cv in ((-1, 0, -a, -mu), (1, 0, -a, -mu),
                           (0, -1, -mu, -a), (0, 1, -mu, -a)):
        ok = (ii + di >= 0) & (ii + di < nx) & (jj + dj >= 0) & (jj + dj < ny)
        nb = 2 * ((ii + di) * ny + jj + dj)[ok]
        rows += [nu[ok], nu[ok] + 1]
        cols += [nb, nb + 1]
        vals += [np.full(nb.size, cu), np.full(nb.size, cv)]
    # the mixed derivative couples u <-> v at the diagonal corners
    for di, dj, sgn in ((1, 1, -1.0), (1, -1, 1.0), (-1, 1, 1.0),
                        (-1, -1, -1.0)):
        ok = (ii + di >= 0) & (ii + di < nx) & (jj + dj >= 0) & (jj + dj < ny)
        nb = 2 * ((ii + di) * ny + jj + dj)[ok]
        rows += [nu[ok], nu[ok] + 1]
        cols += [nb + 1, nb]
        vals += [np.full(nb.size, sgn * c4)] * 2
    csr = HostCSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                           np.concatenate(vals).astype(_np_dtype(dtype)),
                           (n, n))
    return csr_to_ell(csr, dtype=dtype, device=device)


def _vdc_jump(x, y, z):
    """par_vardifconv.c's a/b/cfun: 0.01 in the eight corner cubes, 1000
    in the interior cube [0.1,0.9]^3, 1.0 in the remaining shell."""
    lo, hi = 0.1, 0.9
    corner = (((x < lo) | (x > hi)) & ((y < lo) | (y > hi))
              & ((z < lo) | (z > hi)))
    interior = ((x >= lo) & (x <= hi) & (y >= lo) & (y <= hi) & (z >= lo)
                & (z <= hi))
    return torch.where(corner, torch.full_like(x, 0.01), torch.where(
        interior, torch.full_like(x, 1000.0), torch.ones_like(x)))


def vardifconv_3d(nx: int, ny: int, nz: int, eps: float = 1.0,
                  dtype=None, device=None) -> EllMatrix:
    """Variable (jump-coefficient) diffusion, the ``-vardifconv`` generator
    (``parcsr_ls/par_vardifconv.c``): -eps div(a(x) grad u) on the unit
    cube, face coefficients at the face midpoints, Dirichlet truncation.
    The default convection and reaction terms are zero, so the operator is
    SPD with five orders of coefficient jump.

    The face coordinates and eps * a / h^2 are computed in float64 and
    then cast to ``dtype`` (the reference computes them in the default
    real type: float64 under x64, as its tests run, which this matches
    bit for bit)."""
    device = resolve_device(device)
    dtype = dtype or default_real_dtype()
    n = nx * ny * nz
    shape = (nx, ny, nz)
    strides = (ny * nz, nz, 1)
    hh = (1.0 / (nx + 1), 1.0 / (ny + 1), 1.0 / (nz + 1))

    rows = torch.arange(n, dtype=torch.int32, device=device)
    coords = [(rows // strides[d]) % shape[d] for d in range(3)]
    xyz = [(coords[d].to(torch.float64) + 1.0) * hh[d] for d in range(3)]

    vals_list, cols_list, shifts = [], [], []
    center = torch.zeros(n, dtype=dtype, device=device)
    for d in range(3):
        for sgn in (-1, 1):
            mid = list(xyz)
            mid[d] = xyz[d] + 0.5 * sgn * hh[d]
            cf = (eps * _vdc_jump(*mid) / hh[d] / hh[d]).to(dtype)
            center = center + cf
            inside = (coords[d] + sgn >= 0) & (coords[d] + sgn < shape[d])
            shift = sgn * strides[d]
            shifts.append(shift)
            cols_list.append(torch.where(inside, rows + shift,
                                         torch.full_like(rows, PAD_COL)))
            vals_list.append(torch.where(inside, -cf, torch.zeros_like(cf)))
    cols_list.insert(0, rows)
    vals_list.insert(0, center)
    shifts.insert(0, 0)
    return EllMatrix(
        vals=torch.stack(vals_list, dim=1),
        cols=torch.stack(cols_list, dim=1).to(torch.int32),
        n_cols=n,
        shifts=tuple(shifts),
    )
