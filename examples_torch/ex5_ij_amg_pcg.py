"""ex5 analogue (src/examples/ex5.c), the canonical hypre path:
assemble a 2-D Laplacian through the IJ interface, solve with AMG-PCG.
The port of ``examples/ex5_ij_amg_pcg.py`` on ``device`` in ``dtype``."""

import numpy as np
import torch

from hypre_tpu_torch.amg import BoomerAMG
from hypre_tpu_torch.ij import IJMatrix, IJVector
from hypre_tpu_torch.krylov import pcg


def main(n=64, device=None, dtype=None):
    N = n * n
    m = IJMatrix(N, N)
    for i in range(N):  # the ex5.c row loop
        r, c = divmod(i, n)
        cols, vals = [i], [4.0]
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            rr, cc = r + dr, c + dc
            if 0 <= rr < n and 0 <= cc < n:
                cols.append(rr * n + cc)
                vals.append(-1.0)
        m.set_values([i] * len(cols), cols, vals)
    A = m.assemble().get_object(dtype=dtype, device=device)
    b = IJVector(N).set_values(np.arange(N), np.ones(N)).assemble() \
        .get_object(dtype=A.dtype, device=A.device)

    amg = BoomerAMG().setup(A, device=A.device)
    x, info = pcg(A.mv, b, M=amg.precond(), rtol=1e-7, device=A.device)
    r = b - A.mv(x)
    rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
    print(f"ex5: AMG-PCG {int(info.iterations)} iterations, true rel res {rel:.2e}")
    assert bool(info.converged) and int(info.iterations) <= 10
    return info


if __name__ == "__main__":
    main()
