"""Strength of connection (hypre_BoomerAMGCreateS, parcsr_ls/par_strength.c:531).

Counterpart of ``hypre_tpu/amg/strength.py``: S is a boolean (n, k) mask
aligned with A's ELL slots instead of a separate matrix. Entry (i, j) is
strong iff -sign(a_ii) * a_ij >= theta * max_{k != i}(-sign(a_ii) * a_ik);
rows whose largest off-diagonal candidate is <= 0 have no strong
connections.
"""

from __future__ import annotations

import torch

from hypre_tpu_torch.core.config import fold_sum
from hypre_tpu_torch.seq.ell import EllMatrix


def strength_mask(
    A: EllMatrix, theta: float = 0.25, max_row_sum: float = 1.0
) -> torch.Tensor:
    """Boolean (n, k) mask over A's slots: True = strong connection.

    max_row_sum < 1 applies hypre's weak-dependence cutoff
    (HYPRE_BoomerAMGSetMaxRowSum): a row with |sum_j a_ij| >
    max_row_sum * |a_ii| gets no strong dependencies."""
    offd = A.offdiag_mask()
    diag = A.diagonal()
    sign = torch.where(diag >= 0, 1.0, -1.0).to(A.dtype)
    cand = torch.where(offd, -sign[:, None] * A.vals,
                       torch.full_like(A.vals, -torch.inf))
    row_max = cand.amax(dim=1)
    has_strong = row_max > 0
    thresh = theta * row_max
    S = offd & (cand >= thresh[:, None]) & has_strong[:, None] & (cand > 0)
    if max_row_sum < 1.0:
        row_sum = fold_sum(torch.where(offd, A.vals,
                                       torch.zeros_like(A.vals))) + diag
        safe_d = torch.where(diag != 0, diag, torch.ones_like(diag))
        dominant = (row_sum / safe_d).abs() > max_row_sum
        S = S & ~dominant[:, None]
    return S


def strength_transpose_counts(A: EllMatrix, S: torch.Tensor) -> torch.Tensor:
    """|S^T_i| = number of points that strongly depend on i: a count of
    the strong slots' columns (exact in any order)."""
    return torch.bincount(A.cols[S].long(), minlength=A.n_rows) \
        .to(torch.int32)
