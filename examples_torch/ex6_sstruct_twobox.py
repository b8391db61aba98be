"""ex6 analogue (src/examples/ex6.c): the two-processor multi-box problem
of ex2, expressed through the SEMI-structured interface (one part, one
cell-centered variable) and solved with SMG-preconditioned PCG, showing
the sstruct interface subsumes the struct one. The port of
``examples/ex6_sstruct_twobox.py`` on ``device`` in ``dtype``."""

import numpy as np
import torch

from hypre_tpu_torch.krylov import pcg
from hypre_tpu_torch.sstruct import SplitSolver, SStructGrid
from hypre_tpu_torch.sstruct.matrix import sstruct_matrix
from hypre_tpu_torch.struct.matrix import struct_from_dense_coeffs


def _twobox_part(nx=10, ny=4, device=None, dtype=None):
    # boxes from ex2.c/ex6.c shifted onto a [0,10)x[0,4) bounding grid;
    # inactive cells become identity rows (the dense-array image of the
    # sstruct part's BoxArray)
    active = np.zeros((nx, ny), bool)
    active[0:3, 0:2] = True
    active[3:6, 0:4] = True
    active[6:10, 0:4] = True
    offsets = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
    coeffs = {(0, 0): np.where(active, 4.0, 1.0)}
    for off in offsets[1:]:
        nb = np.roll(active, shift=(-off[0], -off[1]), axis=(0, 1))
        if off[0] == 1:
            nb[-1, :] = False
        if off[0] == -1:
            nb[0, :] = False
        if off[1] == 1:
            nb[:, -1] = False
        if off[1] == -1:
            nb[:, 0] = False
        coeffs[off] = np.where(active & nb, -1.0, 0.0)
    return struct_from_dense_coeffs(coeffs, (nx, ny), dtype=dtype,
                                    device=device), active


def main(device=None, dtype=None):
    part, active = _twobox_part(device=device, dtype=dtype)
    grid = SStructGrid(((10, 4),))
    A = sstruct_matrix([part], grid)

    b = torch.as_tensor(active.reshape(-1), dtype=part.dtype) \
        .to(part.device)
    M = SplitSolver(solver="smg").setup(A).precond()
    x, info = pcg(A.as_linear_op(), b, M=M, rtol=1e-7, device=part.device)
    print(f"ex6: sstruct two-box SMG-PCG: {int(info.iterations)} iterations")
    assert bool(info.converged)
    return info


if __name__ == "__main__":
    main()
