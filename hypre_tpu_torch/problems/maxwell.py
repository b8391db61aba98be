"""Discrete de Rham complexes on rectangular grids, and the H(curl) and
H(div) problems the auxiliary-space solvers are tested on.

The reference builds these in its tests (``tests/test_mgr_ams.py``'s 2-D
curl-curl, ``tests/test_ads.py``'s 3-D hex complex) with Python loops
over the grid and dense products, which cannot reach millions of rows.
Here every incidence matrix is index arithmetic over the whole grid, with
the reference's numbering and signs, and the Gram products are ELL
SpGEMMs in float64 on the device:

- ``edge_complex_2d``: the discrete gradient G (edge x node) and curl C
  (cell x edge) of an nx x ny grid;
- ``hex_complex``: D (cell x face), C (face x edge) and G (edge x node)
  of an n^3 hex grid, with D C = 0 and C G = 0;
- ``curl_curl_2d`` / ``curl_curl_3d``: A = C^T C + beta I (edges), with G
  and the node coordinates, for AMS and AME;
- ``div_div_3d``: A = D^T diag(c) D + beta diag(m) (faces) with lognormal
  c and m, with C, G and the coordinates, for ADS.

The incidence matrices come back as host CSR; the operators as
``EllMatrix`` on ``device`` (CUDA unless the caller names another), with
explicit zeros dropped as the reference's ``ell_from_dense`` drops them.
"""

from __future__ import annotations

import numpy as np
import torch

from hypre_tpu_torch.core.config import default_real_dtype, resolve_device
from hypre_tpu_torch.seq.csr import HostCSR
from hypre_tpu_torch.seq.ell import EllMatrix, csr_to_ell
from hypre_tpu_torch.seq.spgemm import (
    ell_add, ell_filter, ell_spgemm, ell_transpose,
)


def _grid(*extents):
    """Flat index arrays of an ij-ordered grid of the given extents."""
    return [g.ravel() for g in np.meshgrid(*[np.arange(e) for e in extents],
                                           indexing="ij")]


def _incidence(rows, cols_vals, shape) -> HostCSR:
    """HostCSR with, for each (cols, sign) in ``cols_vals``, the entries
    (rows, cols) = sign."""
    r = np.concatenate([rows] * len(cols_vals))
    c = np.concatenate([cv[0] for cv in cols_vals])
    v = np.concatenate([np.full(len(rows), float(cv[1])) for cv in cols_vals])
    return HostCSR.from_coo(r, c, v, shape)


def edge_complex_2d(nx: int, ny: int):
    """(G edge x node, C cell x edge, node coords (nnode, 2)) of an
    nx x ny grid: x-edges (i, j) -> (i+1, j) first, then y-edges
    (i, j) -> (i, j+1); G[e, head] = 1, G[e, tail] = -1; a cell's curl is
    its counter-clockwise circulation."""
    nnode = (nx + 1) * (ny + 1)

    def node(i, j):
        return i * (ny + 1) + j

    nxe = nx * (ny + 1)

    def xe(i, j):
        return i * (ny + 1) + j

    def ye(i, j):
        return nxe + i * ny + j

    ne = nxe + (nx + 1) * ny
    i, j = _grid(nx, ny + 1)
    gx = (xe(i, j), node(i + 1, j), node(i, j))
    i, j = _grid(nx + 1, ny)
    gy = (ye(i, j), node(i, j + 1), node(i, j))
    G = _incidence(np.concatenate([gx[0], gy[0]]),
                   [(np.concatenate([gx[1], gy[1]]), 1.0),
                    (np.concatenate([gx[2], gy[2]]), -1.0)], (ne, nnode))
    i, j = _grid(nx, ny)
    C = _incidence(i * ny + j, [(xe(i, j), 1.0), (ye(i + 1, j), 1.0),
                                (xe(i, j + 1), -1.0), (ye(i, j), -1.0)],
                   (nx * ny, ne))
    coords = np.stack(_grid(nx + 1, ny + 1), axis=1).astype(float)
    return G, C, coords


def hex_complex(n: int):
    """(D cell x face, C face x edge, G edge x node, node coords (nn^3, 3))
    of an n^3 hex grid, nn = n + 1: x-, y-, then z-directed edges and
    x-, y-, then z-normal faces, each block ij-ordered; out-fluxes
    positive in D."""
    nn = n + 1

    def node(i, j, k):
        return (i * nn + j) * nn + k

    nex, ney = n * nn * nn, nn * n * nn
    ne = nex + ney + nn * nn * n

    def xe(i, j, k):
        return (i * nn + j) * nn + k

    def ye(i, j, k):
        return nex + (i * n + j) * nn + k

    def ze(i, j, k):
        return nex + ney + (i * nn + j) * n + k

    heads, tails, edges = [], [], []
    for (ei, di), ext in (((xe, (1, 0, 0)), (n, nn, nn)),
                          ((ye, (0, 1, 0)), (nn, n, nn)),
                          ((ze, (0, 0, 1)), (nn, nn, n))):
        i, j, k = _grid(*ext)
        edges.append(ei(i, j, k))
        heads.append(node(i + di[0], j + di[1], k + di[2]))
        tails.append(node(i, j, k))
    G = _incidence(np.concatenate(edges),
                   [(np.concatenate(heads), 1.0),
                    (np.concatenate(tails), -1.0)], (ne, nn ** 3))

    nfx, nfy = nn * n * n, n * nn * n
    nf = nfx + nfy + n * n * nn

    def xf(i, j, k):
        return (i * n + j) * n + k

    def yf(i, j, k):
        return nfx + (i * nn + j) * n + k

    def zf(i, j, k):
        return nfx + nfy + (i * n + j) * nn + k

    signs = (1.0, 1.0, -1.0, -1.0)
    blocks = []
    i, j, k = _grid(nn, n, n)  # x-faces: y and z edges around them
    blocks.append((xf(i, j, k), [ye(i, j, k), ze(i, j + 1, k),
                                 ye(i, j, k + 1), ze(i, j, k)]))
    i, j, k = _grid(n, nn, n)  # y-faces: z and x edges
    blocks.append((yf(i, j, k), [ze(i, j, k), xe(i, j, k + 1),
                                 ze(i + 1, j, k), xe(i, j, k)]))
    i, j, k = _grid(n, n, nn)  # z-faces: x and y edges
    blocks.append((zf(i, j, k), [xe(i, j, k), ye(i + 1, j, k),
                                 xe(i, j + 1, k), ye(i, j, k)]))
    C = _incidence(np.concatenate([b[0] for b in blocks]),
                   [(np.concatenate([b[1][s] for b in blocks]), signs[s])
                    for s in range(4)], (nf, ne))

    i, j, k = _grid(n, n, n)
    D = _incidence((i * n + j) * n + k,
                   [(xf(i + 1, j, k), 1.0), (xf(i, j, k), -1.0),
                    (yf(i, j + 1, k), 1.0), (yf(i, j, k), -1.0),
                    (zf(i, j, k + 1), 1.0), (zf(i, j, k), -1.0)],
                   (n ** 3, nf))
    coords = np.stack(_grid(nn, nn, nn), axis=1).astype(float)
    return D, C, G, coords


def _gram_plus_diag(M: HostCSR, w, diag, dtype, device) -> EllMatrix:
    """M^T diag(w) M + diag(diag), formed in float64 on ``device`` (w None
    = 1), explicit zeros dropped, cast to ``dtype``."""
    Me = csr_to_ell(M, dtype=torch.float64, device=device)
    Mt = ell_transpose(Me)
    if w is not None:
        Me = Me.scale_rows(torch.from_numpy(np.asarray(w, np.float64))
                           .to(device))
    n = M.shape[1]
    d = EllMatrix(vals=torch.from_numpy(np.asarray(diag, np.float64))
                  .to(device)[:, None],
                  cols=torch.arange(n, dtype=torch.int32, device=device)[:,
                                                                         None],
                  n_cols=n)
    K = ell_add(1.0, ell_spgemm(Mt, Me), 1.0, d)
    K = ell_filter(K, K.vals != 0)
    width = max(int(K.structural_mask().sum(dim=1).max()), 1)
    return EllMatrix(vals=K.vals[:, :width].to(dtype).contiguous(),
                     cols=K.cols[:, :width].contiguous(), n_cols=n)


def curl_curl_2d(nx: int = 10, ny: int = 10, beta: float = 0.01, dtype=None,
                 device=None):
    """(A = C^T C + beta I, G, coords) on an nx x ny grid (the reference
    tests' ``_curl_curl_2d``, ex15-style)."""
    device = resolve_device(device)
    dtype = dtype or default_real_dtype()
    G, C, coords = edge_complex_2d(nx, ny)
    A = _gram_plus_diag(C, None, np.full(C.shape[1], beta), dtype, device)
    return A, csr_to_ell(G, dtype=dtype, device=device), coords


def curl_curl_3d(n: int, beta: float = 0.01, dtype=None, device=None):
    """(A = C^T C + beta I on the edges, G, coords) of the n^3 hex
    complex."""
    device = resolve_device(device)
    dtype = dtype or default_real_dtype()
    _, C, G, coords = hex_complex(n)
    A = _gram_plus_diag(C, None, np.full(C.shape[1], beta), dtype, device)
    return A, csr_to_ell(G, dtype=dtype, device=device), coords


def div_div_3d(n: int, beta: float = 0.01, sigma: float = 2.0, seed: int = 0,
               dtype=None, device=None):
    """(A = D^T diag(c) D + beta diag(m) on the faces, C, G, coords) of the
    n^3 hex complex, c = exp(sigma N(0,1)) per cell and then m per face
    from ``default_rng(seed)`` (``tests/test_ads.py``'s rough
    coefficients)."""
    device = resolve_device(device)
    dtype = dtype or default_real_dtype()
    D, C, G, coords = hex_complex(n)
    rng = np.random.default_rng(seed)
    cc = np.exp(rng.standard_normal(D.shape[0]) * sigma)
    mm = np.exp(rng.standard_normal(D.shape[1]) * sigma)
    A = _gram_plus_diag(D, cc, beta * mm, dtype, device)
    return (A, csr_to_ell(C, dtype=dtype, device=device),
            csr_to_ell(G, dtype=dtype, device=device), coords)
