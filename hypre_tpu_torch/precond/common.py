"""Pattern lookups shared by the preconditioner family.

Counterpart of ``lookup`` in ``hypre_tpu/precond/common.py`` (the rest of
that module waits for the preconditioners, ROADMAP.md Queue 1 item 12):
entries of an ELL matrix at arbitrary (row, column) index pairs, the
replacement for hypre's per-row hash lookups.
"""

from __future__ import annotations

import torch

from hypre_tpu_torch.core.config import fold_sum
from hypre_tpu_torch.seq.ell import EllMatrix


def lookup(A: EllMatrix, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """A[rows, cols] for index tensors of one shape; a missing entry, or a
    negative row, gives 0."""
    rsafe = rows.clamp(min=0).long()
    rvals = A.vals[rsafe]  # (..., kA)
    rcols = A.cols[rsafe]
    match = (rcols == cols[..., None]) & (rcols >= 0) & (rows >= 0)[..., None]
    return fold_sum(torch.where(match, rvals, torch.zeros_like(rvals)),
                    dim=-1)
