"""ex7 analogue (src/examples/ex7.c): convection-reaction-diffusion
div(-K grad u + B u) + C u = F on the unit square through the
semi-structured interface (one part, one cell-centered variable),
nonsymmetric, solved with GMRES preconditioned by the Split solver. The
port of ``examples/ex7_sstruct_convection.py`` on ``device`` in
``dtype``."""

import numpy as np
import torch

from hypre_tpu_torch.krylov import gmres
from hypre_tpu_torch.sstruct import SplitSolver, SStructGrid
from hypre_tpu_torch.sstruct.matrix import sstruct_matrix
from hypre_tpu_torch.struct.matrix import struct_from_dense_coeffs


def main(n=32, K=1.0, B=10.0, C=1.0, device=None, dtype=None):
    h = 1.0 / (n + 1)
    # central diffusion + first-order upwind convection (B in +x) +
    # reaction, matching ex7.c's stencil construction
    diff = K / (h * h)
    conv = B / h
    coeffs = {
        (0, 0): np.full((n, n), 4.0 * diff + conv + C),
        (-1, 0): np.full((n, n), -diff - conv),
        (1, 0): np.full((n, n), -diff),
        (0, -1): np.full((n, n), -diff),
        (0, 1): np.full((n, n), -diff),
    }
    coeffs[(-1, 0)][0, :] = 0
    coeffs[(1, 0)][-1, :] = 0
    coeffs[(0, -1)][:, 0] = 0
    coeffs[(0, 1)][:, -1] = 0
    part = struct_from_dense_coeffs(coeffs, (n, n), dtype=dtype,
                                    device=device)
    grid = SStructGrid(((n, n),))
    A = sstruct_matrix([part], grid)

    b = torch.ones(A.n_rows, dtype=part.dtype, device=part.device)
    M = SplitSolver(solver="pfmg").setup(A).precond()
    x, info = gmres(A.as_linear_op(), b, M=M, rtol=1e-6, k_dim=30,
                    device=part.device)
    print(
        f"ex7: sstruct convection-diffusion Split-GMRES: "
        f"{int(info.iterations)} iterations"
    )
    assert bool(info.converged)
    return info


if __name__ == "__main__":
    main()
