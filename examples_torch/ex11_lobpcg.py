"""ex11 analogue (src/examples/ex11.c): smallest eigenpairs of the 2-D
Laplacian with LOBPCG, preconditioned by an AMG cycle. The port of
``examples/ex11_lobpcg.py`` on ``device`` in ``dtype``; returns the
eigenvalues."""

import numpy as np
import torch

from hypre_tpu_torch.amg import BoomerAMG
from hypre_tpu_torch.krylov import block_op, lobpcg
from hypre_tpu_torch.problems.laplacian import laplacian_2d_5pt


def main(n=32, m=4, device=None, dtype=None):
    A = laplacian_2d_5pt(n, n, dtype=dtype, device=device)
    amg = BoomerAMG().setup(A, device=A.device)
    X0 = torch.as_tensor(np.random.default_rng(7).standard_normal((n * n, m)),
                         dtype=A.dtype).to(A.device)
    lam, X, rn = lobpcg(
        block_op(A.mv),
        X0,
        T=block_op(amg.precond()),
        tol=1e-6,
        maxiter=100,
    )
    # analytic: 4 sin^2(p pi / (2(n+1))) + 4 sin^2(q pi / (2(n+1)))
    s = lambda k: 4 * np.sin(k * np.pi / (2 * (n + 1))) ** 2
    want = np.sort([s(p) + s(q) for p in range(1, 4) for q in range(1, 4)])[:m]
    got = np.sort(lam.cpu().numpy())
    print(f"ex11: LOBPCG eigenvalues {got} (analytic {want})")
    assert np.allclose(got, want, rtol=1e-4)
    return lam


if __name__ == "__main__":
    main()
