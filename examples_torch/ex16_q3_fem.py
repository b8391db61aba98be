"""ex16 analogue (src/examples/ex16.c): high-order Q3 finite element
discretization of -Laplace u = 1 on the unit square, assembled through the
FEI interface (16 nodes per element), diagonally scaled CG. The port of
``examples/ex16_q3_fem.py`` on ``device`` in ``dtype``."""

import numpy as np


def _q3_element(h):
    """Q3 stiffness (16x16) and load on an h x h square via 4-pt Gauss."""
    # 1-D cubic Lagrange nodes on [0,1] and 4-pt Gauss rule
    xn = np.array([0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0])
    gp, gw = np.polynomial.legendre.leggauss(4)
    gp = 0.5 * (gp + 1.0)
    gw = 0.5 * gw

    def lag(i, x):
        num = den = 1.0
        for m in range(4):
            if m != i:
                num = num * (x - xn[m])
                den = den * (xn[i] - xn[m])
        return num / den

    def dlag(i, x, eps=1e-6):
        return (lag(i, x + eps) - lag(i, x - eps)) / (2 * eps)

    phi = np.array([[lag(i, x) for x in gp] for i in range(4)])  # (4, q)
    dphi = np.array([[dlag(i, x) for x in gp] for i in range(4)])
    ke = np.zeros((16, 16))
    fe = np.zeros(16)
    for a in range(4):
        for b in range(4):
            for c in range(4):
                for d in range(4):
                    # grad phi_ab . grad phi_cd integrated (tensor products)
                    kxx = np.sum(gw * dphi[a] * dphi[c]) * np.sum(gw * phi[b] * phi[d])
                    kyy = np.sum(gw * phi[a] * phi[c]) * np.sum(gw * dphi[b] * dphi[d])
                    ke[a * 4 + b, c * 4 + d] = kxx + kyy  # h cancels: (1/h^2)*h^2
            fe[a * 4 + b] = (
                np.sum(gw * phi[a]) * np.sum(gw * phi[b]) * h * h
            )
    return ke, fe


def main(n=6, device=None, dtype=None):
    from hypre_tpu_torch.fei import FEISystem

    h = 1.0 / n
    ke, fe = _q3_element(h)
    kw = {} if dtype is None else {"dtype": dtype}
    fei = FEISystem(device=device, **kw).initFields()
    fei.initElemBlock("q3", n * n, 16)
    N = 3 * n  # global node grid is (3n+1) x (3n+1)
    for ei in range(n):
        for ej in range(n):
            conn = [
                (3 * ei + a, 3 * ej + b) for a in range(4) for b in range(4)
            ]
            fei.sumInElemMatrix("q3", (ei, ej), conn, ke)
            fei.sumInElemRHS("q3", (ei, ej), conn, fe)
    bnd = [
        (i, j) for i in range(N + 1) for j in range(N + 1)
        if i in (0, N) or j in (0, N)
    ]
    fei.loadNodeBCs(bnd, [0.0] * len(bnd))
    fei.loadComplete()
    # Q3 stiffness matrices have large positive off-diagonals (non-M), where
    # classical-AMG/ILU preconditioning degrades (hypre's ex16 pairs with
    # specialized solvers); diagonal-scaled CG is robust here
    x, info = fei.parameters(
        ["solver cg", "preconditioner diagonal"]
    ).solve(rtol=1e-8, maxiter=600)
    assert bool(info.converged)
    # sanity: the FEM solution peak approaches the known continuum value
    xs = float(x.max())
    assert 0.05 < xs < 0.09, xs  # max of -Lap u = 1 on unit square ~0.0737
    print(
        f"ex16: Q3 FEM ({fei.n_nodes} nodes) + DS-CG: "
        f"{int(info.iterations)} iterations, max u = {xs:.4f}"
    )
    return info


if __name__ == "__main__":
    main()
