"""ex8 analogue (src/examples/ex8.c): a THREE-part semi-structured problem
where two parts carry a 5-point stencil and one a 9-point stencil, glued
through inter-part graph entries, solved with the Split solver as a GMRES
preconditioner. The port of ``examples/ex8_sstruct_multipart.py`` on
``device`` in ``dtype``."""

import torch

from hypre_tpu_torch.krylov import gmres
from hypre_tpu_torch.problems.struct_problems import struct_laplacian
from hypre_tpu_torch.sstruct import SplitSolver, SStructGrid
from hypre_tpu_torch.sstruct.matrix import SStructGraphBuilder, sstruct_matrix
from hypre_tpu_torch.struct.matrix import struct_from_dense_coeffs


def main(n=12, device=None, dtype=None):
    lap9 = {
        (0, 0): 8.0 / 3.0,
        (-1, 0): -1.0 / 3.0, (1, 0): -1.0 / 3.0,
        (0, -1): -1.0 / 3.0, (0, 1): -1.0 / 3.0,
        (-1, -1): -1.0 / 3.0, (-1, 1): -1.0 / 3.0,
        (1, -1): -1.0 / 3.0, (1, 1): -1.0 / 3.0,
    }
    parts = [
        struct_laplacian((n, n), dtype=dtype, device=device),
        struct_laplacian((n, n), dtype=dtype, device=device),
        # the 9-pt part
        struct_from_dense_coeffs(lap9, (n, n), dtype=dtype, device=device),
    ]
    grid = SStructGrid(((n, n),) * 3)
    g = SStructGraphBuilder(grid)
    for j in range(n):
        # chain the parts left-to-right like ex8's diagram
        g.add_entry(0, (n - 1, j), 1, (0, j), -1.0)
        g.add_entry(1, (0, j), 0, (n - 1, j), -1.0)
        g.add_entry(1, (n - 1, j), 2, (0, j), -1.0)
        g.add_entry(2, (0, j), 1, (n - 1, j), -1.0)
    A = sstruct_matrix(parts, grid, g)
    b = torch.ones(A.n_rows, dtype=parts[0].dtype, device=parts[0].device)
    x, info = gmres(
        A.as_linear_op(), b, M=SplitSolver().setup(A).precond(), rtol=1e-6,
        maxiter=3000, device=parts[0].device,
    )
    assert bool(info.converged)
    print(
        f"ex8: Split-GMRES on 3 parts (5pt,5pt,9pt): "
        f"{int(info.iterations)} iterations"
    )
    return info


if __name__ == "__main__":
    main()
