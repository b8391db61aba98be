"""ex10 analogue (src/examples/ex10.cxx): bilinear FEM Laplace assembly
through the FEI interface, solved with AMG-preconditioned CG. The port of
``examples/ex10_fei_fem.py`` on ``device`` in ``dtype``."""

import numpy as np


def main(n=16, device=None, dtype=None):
    from hypre_tpu_torch.fei import FEISystem

    ke = np.array([
        [ 2/3, -1/6, -1/3, -1/6],
        [-1/6,  2/3, -1/6, -1/3],
        [-1/3, -1/6,  2/3, -1/6],
        [-1/6, -1/3, -1/6,  2/3],
    ])
    fe = np.full(4, 0.25 / (n * n))
    kw = {} if dtype is None else {"dtype": dtype}
    fei = FEISystem(device=device, **kw).initFields()
    fei.initElemBlock("blk", n * n, 4)
    for i in range(n):
        for j in range(n):
            conn = [(i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)]
            fei.sumInElemMatrix("blk", (i, j), conn, ke)
            fei.sumInElemRHS("blk", (i, j), conn, fe)
    bnd = [(i, j) for i in range(n + 1) for j in range(n + 1)
           if i in (0, n) or j in (0, n)]
    fei.loadNodeBCs(bnd, [0.0] * len(bnd))
    fei.loadComplete()
    x, info = fei.parameters(["solver cg", "preconditioner boomeramg"]).solve(
        rtol=1e-8
    )
    assert bool(info.converged)
    print(f"ex10: FEI Q1 FEM + AMG-CG: {int(info.iterations)} iterations")

    # FE-data-driven smoothed aggregation (femli's mli_amgsa path): the
    # element matrices supply near-null candidates and the shared-element
    # graph supplies the aggregation: no coordinates, no assembled-matrix
    # heuristics
    from hypre_tpu_torch.amg.smoothed_agg import SmoothedAggAMG
    from hypre_tpu_torch.krylov import pcg

    Z = fei.element_null_candidates(num_vectors=2)
    sa = SmoothedAggAMG(
        null_space=Z, agg0=fei.element_graph_aggregates(),
        max_coarse_size=40,
    ).setup(fei.A, host_setup=False, optimize=False, device=fei.A.device)
    x2, info2 = pcg(fei.A.mv, fei.b, M=sa.precond(), rtol=1e-8, maxiter=200,
                    device=fei.A.device)
    assert bool(info2.converged)
    print(f"ex10: FE-data-driven SA-AMG (element graph + element null "
          f"space): {int(info2.iterations)} iterations")
    return info


if __name__ == "__main__":
    main()
