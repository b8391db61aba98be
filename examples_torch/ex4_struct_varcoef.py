"""ex4 analogue (src/examples/ex4.c): variable-coefficient struct problem
with general boundary handling, PFMG-preconditioned PCG. The port of
``examples/ex4_struct_varcoef.py`` on ``device`` in ``dtype``."""

import numpy as np
import torch

from hypre_tpu_torch.krylov import pcg
from hypre_tpu_torch.struct import PFMG
from hypre_tpu_torch.struct.matrix import struct_from_dense_coeffs


def main(n=32, eps=0.1, device=None, dtype=None):
    # -div(K grad u) with K varying smoothly (ex4's convection variant is
    # exercised by the difconv ij examples; here the struct path)
    xs = np.linspace(0, 1, n)
    K = 1.0 + 10.0 * np.outer(xs, xs)
    Kx = 0.5 * (K + np.roll(K, -1, 0))
    Ky = 0.5 * (K + np.roll(K, -1, 1))
    coeffs = {
        (0, 0): Kx + np.roll(Kx, 1, 0) + Ky + np.roll(Ky, 1, 1) + eps,
        (-1, 0): -np.roll(Kx, 1, 0),
        (1, 0): -Kx,
        (0, -1): -np.roll(Ky, 1, 1),
        (0, 1): -Ky,
    }
    # zero the fluxes across the physical boundary (Dirichlet truncation)
    coeffs[(-1, 0)][0, :] = 0
    coeffs[(1, 0)][-1, :] = 0
    coeffs[(0, -1)][:, 0] = 0
    coeffs[(0, 1)][:, -1] = 0
    A = struct_from_dense_coeffs(coeffs, (n, n), dtype=dtype, device=device)
    b = torch.ones((n, n), dtype=A.dtype, device=A.device)
    pf = PFMG().setup(A)

    def op(v):
        return A.mv(v.reshape(n, n)).reshape(-1)

    def M(r):
        return pf.cycle(r.reshape(n, n)).reshape(-1)

    x, info = pcg(op, b.reshape(-1), M=M, rtol=1e-6, device=A.device)
    assert bool(info.converged)
    print(f"ex4: PFMG-PCG, variable coefficients: {int(info.iterations)} iterations")
    return info


if __name__ == "__main__":
    main()
