"""ex17/ex18 analogue (src/examples/ex17.c, ex18.c): N-dimensional
Laplacian (here 4-D) solved with plain diagonally-scaled CG through the
struct interface's N-dim stencil machinery. The port of
``examples/ex17_ndim_laplacian.py`` on ``device`` in ``dtype``."""

import torch

from hypre_tpu_torch.krylov import pcg
from hypre_tpu_torch.problems.laplacian import stencil_to_ell


def main(n=8, ndim=4, device=None, dtype=None):
    offsets = [(0,) * ndim]
    coeffs = [2.0 * ndim]
    for d in range(ndim):
        for s in (-1, 1):
            off = [0] * ndim
            off[d] = s
            offsets.append(tuple(off))
            coeffs.append(-1.0)
    A = stencil_to_ell((n,) * ndim, offsets, coeffs, dtype=dtype,
                       device=device)
    b = torch.ones(A.n_rows, dtype=A.dtype, device=A.device)
    dinv = 1.0 / A.diagonal()
    x, info = pcg(A.mv, b, M=lambda r: dinv * r, rtol=1e-6, maxiter=500,
                  device=A.device)
    assert bool(info.converged)
    print(f"ex17: {ndim}-D Laplacian ({A.n_rows} rows) DS-CG: "
          f"{int(info.iterations)} iterations")
    return info


if __name__ == "__main__":
    main()
