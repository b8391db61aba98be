"""ex8/ex9 analogue (src/examples/ex8.c, ex9.c): a multi-part
semi-structured problem, two grids glued through graph entries, solved
with the Split solver as a preconditioned Krylov system. The port of
``examples/ex9_sstruct_split.py`` on ``device`` in ``dtype``."""

import torch

from hypre_tpu_torch.krylov import pcg
from hypre_tpu_torch.problems.struct_problems import struct_laplacian
from hypre_tpu_torch.sstruct import SplitSolver, SStructGrid
from hypre_tpu_torch.sstruct.matrix import SStructGraphBuilder, sstruct_matrix


def main(n=16, device=None, dtype=None):
    grid = SStructGrid(((n, n), (n, n)))
    parts = [struct_laplacian((n, n), dtype=dtype, device=device)
             for _ in range(2)]
    g = SStructGraphBuilder(grid)
    for j in range(n):
        g.add_entry(0, (n - 1, j), 1, (0, j), -1.0)
        g.add_entry(1, (0, j), 0, (n - 1, j), -1.0)
    A = sstruct_matrix(parts, grid, g)

    b = torch.ones(A.n_rows, dtype=A.parts[0].dtype,
                   device=A.parts[0].device)
    x, info = pcg(A.as_linear_op(), b, M=SplitSolver().setup(A).precond(),
                  rtol=1e-7, device=A.parts[0].device)
    print(f"ex9: Split-PCG on 2 glued parts: {int(info.iterations)} iterations")
    assert bool(info.converged)
    return info


if __name__ == "__main__":
    main()
