"""ex15 analogue (src/examples/ex15.c): edge-element curl-curl system
preconditioned with AMS (discrete gradient + coordinates). The port of
``examples/ex15_ams.py`` on ``device`` in ``dtype``; the problem comes
from ``problems/maxwell.py`` (the reference test helper's vectorized
counterpart)."""

import torch

from hypre_tpu_torch.amg.ams import AMS
from hypre_tpu_torch.krylov import pcg
from hypre_tpu_torch.problems.maxwell import curl_curl_2d


def main(n=12, beta=0.01, device=None, dtype=None):
    A, G, coords = curl_curl_2d(n, n, beta=beta, dtype=dtype, device=device)
    ams = AMS().setup(A, G, coords, device=A.device)
    b = torch.ones(A.n_rows, dtype=A.dtype, device=A.device)
    x, info = pcg(A.mv, b, M=ams.precond(), rtol=1e-6, device=A.device)
    print(f"ex15: AMS-PCG on curl-curl (beta={beta}): {int(info.iterations)} iterations")
    assert bool(info.converged) and int(info.iterations) <= 15
    return info


if __name__ == "__main__":
    main()
