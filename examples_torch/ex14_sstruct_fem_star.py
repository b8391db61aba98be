"""ex14 analogue (src/examples/ex14.c): the ex13 star-shaped domain (six
rhombic parts meeting at an enhanced-connectivity origin) assembled through
the SEMI-STRUCTURED FEM interface (SetFEMOrdering + AddFEMValues with
shared part-boundary nodes) instead of ex13's FEI path, then AMG-PCG. The
port of ``examples/ex14_sstruct_fem_star.py`` on ``device`` in
``dtype``."""

import numpy as np


def main(n=8, nparts=6, device=None, dtype=None):
    import torch

    from hypre_tpu_torch.amg import BoomerAMG
    from hypre_tpu_torch.krylov import pcg
    from hypre_tpu_torch.sstruct.fem import SStructFEMGrid, SStructFEMMatrix

    # rhombic bilinear element stiffness + load (ex14.c computes the same
    # 4x4 for its 60-degree rhombi)
    ke = np.array([
        [ 2/3, -1/6, -1/3, -1/6],
        [-1/6,  2/3, -1/6, -1/3],
        [-1/3, -1/6,  2/3, -1/6],
        [-1/6, -1/3, -1/6,  2/3],
    ])
    fe = np.full(4, 0.25 / (n * n * nparts))

    # node grids: (n+1)x(n+1) nodes per part
    grid = SStructFEMGrid([(n + 1, n + 1)] * nparts)
    for p in range(nparts):
        # element dof ordering: the 4 corners counter-clockwise
        grid.set_fem_ordering(
            p, [0, 0, 0, 0], [(0, 0), (1, 0), (1, 1), (0, 1)]
        )
    # shared spokes: part p's i=0 edge is part (p+1)'s j=0 edge; the
    # origin is one node shared by all parts
    for p in range(nparts):
        q = (p + 1) % nparts
        for t in range(n + 1):
            grid.share_node(p, (0, t), q, (t, 0))

    kw = {} if dtype is None else {"dtype": dtype}
    M = SStructFEMMatrix(grid, device=device, **kw)
    for p in range(nparts):
        for i in range(n):
            for j in range(n):
                M.add_fem_values(p, (i, j), ke)
                M.add_fem_rhs(p, (i, j), fe)

    # Dirichlet on the outer boundary (i = n or j = n node lines)
    bc = set()
    for p in range(nparts):
        for t in range(n + 1):
            bc.add(grid.dof(p, (n, t), 0))
            bc.add(grid.dof(p, (t, n), 0))
    M.assemble(dirichlet=sorted(bc))

    A, b = M.A, M.b
    amg = BoomerAMG(max_levels=8, relax="l1-jacobi").setup(A, device=A.device)
    x, info = pcg(A.mv, b, M=lambda r: amg.cycle(r), rtol=1e-6,
                  device=A.device)
    r = b - A.mv(x)
    rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
    print(
        f"ex14: sstruct-FEM star domain ({grid.n_dofs} dofs): "
        f"{int(info.iterations)} iterations, true rel {rel:.2e}"
    )
    assert bool(info.converged) and rel < 1e-4
    return info


if __name__ == "__main__":
    main()
