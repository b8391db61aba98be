"""ex12 analogue (src/examples/ex12.c): the ex1 grid with nodal unknowns;
PCG preconditioned with either PFMG (struct path) or BoomerAMG (the
sstruct object converted to the unstructured matrix), selected by flag.
The port of ``examples/ex12_sstruct_nodal.py`` on ``device`` in
``dtype``."""

import sys

import torch


def main(n=24, solver="pfmg", device=None, dtype=None):
    from hypre_tpu_torch.krylov import pcg
    from hypre_tpu_torch.problems.struct_problems import struct_laplacian
    from hypre_tpu_torch.struct import PFMG

    A = struct_laplacian((n, n), dtype=dtype, device=device)
    b = torch.ones((n, n), dtype=A.dtype, device=A.device)

    def op(v):
        return A.mv(v.reshape(n, n)).reshape(-1)

    if solver == "pfmg":
        pf = PFMG().setup(A)
        M = lambda r: pf.cycle(r.reshape(n, n)).reshape(-1)
    else:  # 'amg': object_type HYPRE_PARCSR, same grid through BoomerAMG
        from hypre_tpu_torch.amg import BoomerAMG
        from hypre_tpu_torch.problems.laplacian import laplacian_2d_5pt

        amg = BoomerAMG().setup(
            laplacian_2d_5pt(n, n, dtype=A.dtype, device=A.device),
            device=A.device)
        M = amg.precond()
    x, info = pcg(op, b.reshape(-1), M=M, rtol=1e-6, device=A.device)
    assert bool(info.converged)
    print(f"ex12[{solver}]: {int(info.iterations)} iterations")
    return info


if __name__ == "__main__":
    main(solver=sys.argv[1] if len(sys.argv) > 1 else "pfmg")
    main(solver="amg")
