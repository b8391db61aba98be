"""ex13 analogue (src/examples/ex13.c): 2-D Laplace on a star-shaped domain
of identical rhombic parts meeting at the origin (the "enhanced
connectivity" point), bilinear FEM via the FEI interface, AMG-PCG. The
port of ``examples/ex13_star_domain.py`` on ``device`` in ``dtype``."""

import numpy as np


def main(n=8, nparts=6, device=None, dtype=None):
    from hypre_tpu_torch.fei import FEISystem

    # each part is an n x n rhombic mesh; nodes are identified by
    # (part, i, j) with the shared spokes and the center merged by NAME,
    # exactly how the FEI identifies shared nodes across processors
    ke = np.array([
        [ 2/3, -1/6, -1/3, -1/6],
        [-1/6,  2/3, -1/6, -1/3],
        [-1/3, -1/6,  2/3, -1/6],
        [-1/6, -1/3, -1/6,  2/3],
    ])
    fe = np.full(4, 0.25 / (n * n * nparts))

    def node(p, i, j):
        # the center is one shared node; part p's i-axis boundary (j=0) is
        # shared with part (p-1)'s j-axis boundary (i=0)
        if i == 0 and j == 0:
            return ("center",)
        if j == 0:
            return ("spoke", p, i)
        if i == 0:
            return ("spoke", (p + 1) % nparts, j)
        return ("interior", p, i, j)

    kw = {} if dtype is None else {"dtype": dtype}
    fei = FEISystem(device=device, **kw).initFields()
    fei.initElemBlock("star", nparts * n * n, 4)
    for p in range(nparts):
        for i in range(n):
            for j in range(n):
                conn = [node(p, i, j), node(p, i + 1, j),
                        node(p, i + 1, j + 1), node(p, i, j + 1)]
                fei.sumInElemMatrix("star", (p, i, j), conn, ke)
                fei.sumInElemRHS("star", (p, i, j), conn, fe)
    # outer boundary of every part is Dirichlet
    bnd = set()
    for p in range(nparts):
        for t in range(n + 1):
            bnd.add(node(p, n, t))
            bnd.add(node(p, t, n))
    bnd = sorted(bnd)
    fei.loadNodeBCs(bnd, [0.0] * len(bnd))
    fei.loadComplete()
    x, info = fei.parameters(["solver cg", "preconditioner boomeramg"]).solve(
        rtol=1e-8
    )
    assert bool(info.converged)
    # the enhanced-connectivity point has degree nparts in the mesh graph
    print(
        f"ex13: star domain ({nparts} parts) FEI + AMG-CG: "
        f"{int(info.iterations)} iterations, {fei.n_nodes} nodes"
    )
    return info


if __name__ == "__main__":
    main()
