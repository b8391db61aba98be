"""ex18 analogue (src/examples/ex18.c): the 4-dimensional Laplacian
through the SEMI-structured interface (one part, one cell-centered
variable on a 4-D box) solved with diagonally-scaled CG (the reference
drives plain PCG too; its point is the NDIM grid machinery). The port of
``examples/ex18_sstruct_ndim.py`` on ``device`` in ``dtype``."""

import torch

from hypre_tpu_torch.krylov import pcg
from hypre_tpu_torch.problems.struct_problems import struct_laplacian
from hypre_tpu_torch.sstruct import SStructGrid
from hypre_tpu_torch.sstruct.matrix import sstruct_matrix


def main(n=6, ndim=4, device=None, dtype=None):
    shape = (n,) * ndim
    part = struct_laplacian(shape, dtype=dtype, device=device)
    grid = SStructGrid((shape,))
    A = sstruct_matrix([part], grid)

    b = torch.ones(A.n_rows, dtype=part.dtype, device=part.device)
    dinv = torch.full((A.n_rows,), 1.0 / (2.0 * ndim), dtype=part.dtype,
                      device=part.device)
    x, info = pcg(A.as_linear_op(), b, M=lambda r: dinv * r, rtol=1e-6,
                  device=part.device)
    print(
        f"ex18: sstruct {ndim}-D Laplacian ({n}^{ndim} cells): "
        f"{int(info.iterations)} iterations"
    )
    assert bool(info.converged)
    return info


if __name__ == "__main__":
    main()
