"""Unstructured-matrix generators — the SuiteSparse-class test problems.

Counterpart of ``hypre_tpu/problems/unstructured.py``, the same numpy code
over the port's ``IJMatrix``, so that both packages assemble the same CSR
from the same seed:

- ``fem_stiffness_2d``: P1 finite-element stiffness on a jittered-grid
  Delaunay triangulation (the thermal2 class: SPD, irregular rows, ~7
  nnz a row), assembled element by element through AddToValues, the call
  sequence of hypre's ``src/examples/ex5.c``;
- ``circuit_laplacian``: an irregular weighted graph Laplacian with a
  heavy-tailed degree distribution and a grounded diagonal (the
  G3_circuit class);
- ``fem_block_2d``: the 2-dof-a-node version of the FEM problem for the
  nodal path (``seq.bsr.ell_to_bsr`` blocks it for ``amg.block_amg``).

Each returns an assembled ``IJMatrix``; ``get_object(device=...)`` puts it
on the card. scipy (``Delaunay``) is imported inside the FEM generator
only.
"""

from __future__ import annotations

import numpy as np

from hypre_tpu_torch.ij import IJMatrix


def _delaunay_mesh(m: int, seed: int):
    """Jittered-grid point cloud on the unit square + its triangulation.

    A jittered grid (rather than uniform random points) keeps triangle
    quality bounded, the way real FEM meshers do, while making every row
    pattern irregular.
    """
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    g = (np.arange(m) + 0.5) / m
    X, Y = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    pts += rng.uniform(-0.35 / m, 0.35 / m, size=pts.shape)
    # boundary ring (these nodes carry the Dirichlet condition)
    t = np.linspace(0.0, 1.0, m, endpoint=False)
    ring = np.concatenate(
        [
            np.stack([t, np.zeros_like(t)], axis=1),
            np.stack([np.ones_like(t), t], axis=1),
            np.stack([1.0 - t, np.ones_like(t)], axis=1),
            np.stack([np.zeros_like(t), 1.0 - t], axis=1),
        ]
    )
    pts = np.concatenate([pts, ring])
    tri = Delaunay(pts)
    on_boundary = np.zeros(pts.shape[0], dtype=bool)
    on_boundary[m * m :] = True
    return pts, tri.simplices, on_boundary


def fem_stiffness_2d(m: int = 24, seed: int = 0, kappa_contrast: float = 100.0):
    """P1 FEM stiffness -div(kappa grad u) on an unstructured mesh.

    kappa jumps by ``kappa_contrast`` on the lower-left quadrant (thermal
    problems have material contrast; this is what separates AMG from a
    plain Poisson run).  Dirichlet boundary nodes are eliminated
    symmetrically, as hypre's generators do, so the result is SPD.

    Returns (assembled IJMatrix over interior nodes, interior point coords).
    """
    pts, tris, on_boundary = _delaunay_mesh(m, seed)
    p = pts[tris]  # (ntri, 3, 2)
    # P1 gradients: for vertex i (cyclic j,k): b_i = y_j - y_k, c_i = x_k - x_j
    x, y = p[..., 0], p[..., 1]
    j = [1, 2, 0]
    k = [2, 0, 1]
    b = y[:, j] - y[:, k]  # (ntri, 3)
    c = x[:, k] - x[:, j]
    area2 = x[:, 0] * b[:, 0] + x[:, 1] * b[:, 1] + x[:, 2] * b[:, 2]  # 2*A
    good = np.abs(area2) > 1e-14
    tris, b, c, area2 = tris[good], b[good], c[good], area2[good]
    centroid = p[good].mean(axis=1)
    kappa = np.where(
        (centroid[:, 0] < 0.5) & (centroid[:, 1] < 0.5), kappa_contrast, 1.0
    )
    # Ke[i,j] = kappa * (b_i b_j + c_i c_j) / (4 A) = .../(2 * |2A|)
    scale = kappa / (2.0 * np.abs(area2))
    ke = (b[:, :, None] * b[:, None, :] + c[:, :, None] * c[:, None, :]) * (
        scale[:, None, None]
    )

    # eliminate Dirichlet nodes -> interior numbering
    interior = ~on_boundary
    new_id = np.cumsum(interior) - 1
    n = int(interior.sum())
    ij = IJMatrix(n, n)
    gi = tris  # (ntri, 3) global vertex ids
    keep_v = interior[gi]  # (ntri, 3)
    for a in range(3):
        for bb in range(3):
            mask = keep_v[:, a] & keep_v[:, bb]
            ij.add_to_values(
                new_id[gi[mask, a]], new_id[gi[mask, bb]], ke[mask, a, bb]
            )
    ij.assemble()
    return ij, pts[interior]


def circuit_laplacian(n: int = 20000, seed: int = 0, extra_edges: int = 2,
                      n_hubs: int = 8, ground_frac: float = 0.02):
    """Irregular conductance-matrix generator (G3_circuit class).

    Structure: a random spanning tree (every circuit is connected) + ``extra
    edges`` per node drawn with locality bias (short wires dominate) + a few
    high-degree hub nodes (power/clock nets), positive conductances spread
    over three orders of magnitude, and a grounded subset of nodes (diagonal
    shift) making the Laplacian SPD.  Returns the assembled IJMatrix.
    """
    rng = np.random.default_rng(seed)
    # spanning tree: node i>0 attaches to a random earlier node, with strong
    # locality (circuits are laid out; most nets are short)
    lo = np.maximum(0, np.arange(1, n) - 1 - rng.geometric(0.02, size=n - 1))
    u = np.arange(1, n)
    edges = [np.stack([lo, u], axis=1)]
    # extra local edges
    for _ in range(extra_edges):
        a = np.arange(n)
        off = rng.geometric(0.01, size=n)
        bnd = (a + off) % n
        edges.append(np.stack([a, bnd], axis=1))
    # hubs: each connects to ~n/200 random nodes
    hubs = rng.choice(n, size=n_hubs, replace=False)
    for h in hubs:
        tgt = rng.choice(n, size=max(4, n // 200), replace=False)
        tgt = tgt[tgt != h]
        edges.append(np.stack([np.full(tgt.size, h), tgt], axis=1))
    e = np.concatenate(edges)
    e = np.sort(e, axis=1)
    e = e[e[:, 0] != e[:, 1]]
    e = np.unique(e, axis=0)
    w = 10.0 ** rng.uniform(-1.5, 1.5, size=e.shape[0])

    ij = IJMatrix(n, n)
    ij.add_to_values(e[:, 0], e[:, 1], -w)
    ij.add_to_values(e[:, 1], e[:, 0], -w)
    ij.add_to_values(e[:, 0], e[:, 0], w)
    ij.add_to_values(e[:, 1], e[:, 1], w)
    grounded = rng.choice(n, size=max(1, int(n * ground_frac)), replace=False)
    ij.add_to_values(grounded, grounded,
                     10.0 ** rng.uniform(-1.0, 1.0, size=grounded.size))
    ij.assemble()
    return ij


def fem_block_2d(m: int = 16, seed: int = 0, coupling: float = 0.1):
    """2-dof/node vector version of the unstructured FEM problem for the
    BSR/nodal-AMG path: each scalar stiffness entry becomes a 2x2 block
    ``K * [[1, coupling], [coupling, 1]]`` (a compressible-elasticity-like
    inter-field coupling).  Returns the assembled (2n x 2n) IJMatrix with
    node-interleaved dof ordering, ready for ``ell_to_bsr(A, 2)``.
    """
    ij_s, pts = fem_stiffness_2d(m, seed)
    csr = ij_s.get_csr()
    n = csr.shape[0]
    coo_r = np.repeat(np.arange(n), np.diff(csr.indptr))
    coo_c, coo_v = csr.indices, csr.data
    blk = np.array([[1.0, coupling], [coupling, 1.0]])
    ij = IJMatrix(2 * n, 2 * n)
    for a in range(2):
        for bb in range(2):
            ij.add_to_values(2 * coo_r + a, 2 * coo_c + bb, coo_v * blk[a, bb])
    ij.assemble()
    return ij, pts
