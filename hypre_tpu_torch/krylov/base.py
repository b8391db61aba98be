"""Matrix-free solver protocol.

Counterpart of ``hypre_tpu/krylov/base.py``. hypre's Krylov layer is
matrix-free over a caller-supplied vtable (``krylov/pcg.h:49-70``); here
the operator and the preconditioner are plain callables on tensors:

- ``A``: a function ``x -> A@x``;
- ``M``: optional preconditioner ``r -> z`` (setup happens when the
  closure is built).
"""

from __future__ import annotations

from typing import Callable

import torch

LinearOp = Callable[[torch.Tensor], torch.Tensor]


def identity_precond(r: torch.Tensor) -> torch.Tensor:
    return r


def finite(x: torch.Tensor) -> torch.Tensor:
    """NaN/Inf guard on a scalar (hypre pcg.c:391 checks sdotp sanity)."""
    return torch.isfinite(x)
