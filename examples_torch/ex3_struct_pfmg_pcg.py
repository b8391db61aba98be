"""ex3/ex4 analogue (src/examples/ex3.c, ex4.c): anisotropic structured
problem, PFMG-preconditioned PCG; semicoarsening picks the strong axis.
The port of ``examples/ex3_struct_pfmg_pcg.py`` on ``device`` in
``dtype``."""

import torch

from hypre_tpu_torch.krylov import pcg
from hypre_tpu_torch.problems.struct_problems import struct_laplacian
from hypre_tpu_torch.struct import PFMG


def main(n=64, eps=0.05, device=None, dtype=None):
    A = struct_laplacian((n, n), weights=(1.0, eps), dtype=dtype,
                         device=device)
    pf = PFMG(relax_type="jacobi").setup(A)
    b = torch.ones(n * n, dtype=A.dtype, device=A.device)
    x, info = pcg(A.as_linear_op(), b, M=pf.precond(), rtol=1e-7,
                  device=A.device)
    print(f"ex3: PFMG-PCG (eps={eps}) {int(info.iterations)} iterations")
    assert bool(info.converged) and int(info.iterations) <= 15
    return info


if __name__ == "__main__":
    main()
