"""ex1/ex2 analogue (reference src/examples/ex1.c, ex2.c): 2-D structured
Laplacian solved with SMG. hypre splits the grid over 2 MPI ranks; here the
grid is one tensor on one card.

The port of ``examples/ex1_struct_smg.py``: the same problem, solver and
checks, on ``device`` (CUDA unless named) in ``dtype`` (float32 unless
named)."""

import torch

from hypre_tpu_torch.problems.struct_problems import struct_laplacian
from hypre_tpu_torch.struct import SMG


def main(n=64, device=None, dtype=None):
    A = struct_laplacian((n, n), dtype=dtype, device=device)
    b = torch.ones((n, n), dtype=A.dtype, device=A.device)
    x, info = SMG().setup(A).solve(b, rtol=1e-6)
    r = b - A.mv(x)
    rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
    print(f"ex1: SMG {int(info.iterations)} iterations, true rel res {rel:.2e}")
    assert bool(info.converged) and rel < 1e-5
    return info


if __name__ == "__main__":
    main()
