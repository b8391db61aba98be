"""Matrix-free solver protocol.

Counterpart of ``hypre_tpu/krylov/base.py``. hypre's Krylov layer is
matrix-free over a caller-supplied vtable (``krylov/pcg.h:49-70``); here
the operator and the preconditioner are plain callables on tensors:

- ``A``: a function ``x -> A@x``;
- ``M``: optional preconditioner ``r -> z`` (setup happens when the
  closure is built).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from hypre_tpu_torch.core.config import ConvergenceInfo, make_convergence_info

LinearOp = Callable[[torch.Tensor], torch.Tensor]


def identity_precond(r: torch.Tensor) -> torch.Tensor:
    return r


def finite(x: torch.Tensor) -> torch.Tensor:
    """NaN/Inf guard on a scalar (hypre pcg.c:391 checks sdotp sanity)."""
    return torch.isfinite(x)


def zero_rhs(b: torch.Tensor, history: Optional[int] = None,
             stagnated: Optional[bool] = None, mesh=None
             ) -> Optional[tuple[torch.Tensor, ConvergenceInfo]]:
    """The answer to b = 0, or None when b is not zero.

    hypre's PCG sets x = b = 0 and returns at once, whatever the initial
    guess (``krylov/pcg.c``); every driver here does the same: zeros, 0
    iterations, relative residual 0, converged. The reference iterates
    from a nonzero x0 to maxiter instead. ``history``: the length of the
    res_history to return (slot 0 = 0, the rest -1), when logging.
    ``stagnated``: the flag to report, when the driver reports one.
    ``mesh``: a ``dist`` mesh whose processes each hold a part of b (the
    test is then global, so every process takes the same branch)."""
    nonzero = torch.any(b != 0).to(torch.int32)
    if mesh is not None and mesh.comm.backend == "dist":
        nonzero = mesh.comm.max(nonzero.reshape(1)).reshape(())
    if bool(nonzero):
        return None
    norms = None
    if history is not None:
        norms = torch.full((history,), -1.0, dtype=b.dtype, device=b.device)
        norms[0] = 0.0
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    return torch.zeros_like(b), make_convergence_info(
        0, zero, True, res_history=norms, stagnated=stagnated)
