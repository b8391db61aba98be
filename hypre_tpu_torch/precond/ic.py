"""Incomplete Cholesky and the domain-decomposed DDICT/DDILUT shells.

Counterpart of ``hypre_tpu/precond/ic.py``, the analogues of the LSI
preconditioners ``FEI_mv/fei-hypre/HYPRE_LSI_ddict.c`` (incomplete
Cholesky on per-processor subdomains with overlap rows) and
``HYPRE_LSI_ddilut.c`` (the same around ILUT). The reference's subdomains
become a block-diagonal-with-overlap restriction of the pattern, factored
by the fine-grained fixed-point kernels.

The IC fixed point mirrors the Chow-Patel ILU one on the lower pattern:

    l_ij = (a_ij - sum_{k<j} l_ik l_jk) / l_jj   (j < i)
    l_ii = sqrt(a_ii - sum_{k<i} l_ik^2)

iterated over all entries at once; the apply is Jacobi-iterated
triangular solves with L and L^T (L^T stored at setup and applied by
gather, so that the card and the CPU sum in the same order). As in
``ilu.py``, l_{c_a, c_b} is found by a search in the sorted columns of
row c_a once per setup, not by the reference's (n, k, k, k) match.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hypre_tpu_torch.core.config import PAD_COL, fold_sum, resolve_device
from hypre_tpu_torch.precond.common import row_chunks
from hypre_tpu_torch.precond.ilu import (
    ILUT, _row_ids, _zero, compact_ell, pair_index, pair_values,
)
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.spgemm import ell_transpose


def ic_sweeps(A: EllMatrix, sweeps: int) -> torch.Tensor:
    """Fixed-point incomplete Cholesky on A's lower pattern. Returns F
    aligned with A.cols: L on the strictly lower and diagonal slots, zero
    elsewhere. Rows hold each column once."""
    n, k = A.cols.shape
    cols = A.cols
    rows = _row_ids(A)
    is_low = (cols >= 0) & (cols < rows)
    is_diag = cols == rows
    csafe = cols.clamp(min=0).long()
    # l_{c_a, c_b} for c_b < c_a: the inner sum's k < j = c_a
    pos = pair_index(cols, lambda ca, cb: cb < ca)
    chunks = row_chunks(n, 4 * k * k)
    a_ii = fold_sum(torch.where(is_diag, A.vals, _zero(A.vals)))

    # start: the lower part of A scaled, diagonal sqrt(a_ii)
    d0 = torch.sqrt(a_ii.clamp(min=1e-12))
    F = torch.where(is_low, A.vals / d0[csafe],
                    torch.where(is_diag, d0[:, None], _zero(A.vals)))
    for _ in range(sweeps):
        Lik = torch.where(is_low, F, _zero(F))
        S = torch.cat([(pair_values(F, pos, lo, hi) * Lik[lo:hi, None, :])
                       .sum(dim=2) for lo, hi in chunks])
        dL = fold_sum(torch.where(is_diag, F, _zero(F)))
        dL = torch.where(dL != 0, dL, torch.ones_like(dL))
        new_low = (A.vals - S) / dL[csafe]
        # diagonal: sqrt(a_ii - sum_k l_ik^2), clamped SPD-safe
        sq = fold_sum(torch.where(is_low, F * F, _zero(F)))
        new_diag = torch.sqrt((a_ii - sq).clamp(min=1e-12))
        F = torch.where(is_low, new_low,
                        torch.where(is_diag, new_diag[:, None], _zero(F)))
    return F


@dataclasses.dataclass
class IC:
    """Incomplete Cholesky IC(0): M = L L^T on A's lower pattern."""

    factor_sweeps: int = 8
    solve_sweeps: int = 8

    L: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    Lt: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    dinv: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                     repr=False)

    def setup(self, A: EllMatrix, device=None) -> "IC":
        """Factor A on ``device`` (CUDA unless the caller names another)."""
        A = A.to(resolve_device(device))
        F = ic_sweeps(A, self.factor_sweeps)
        rows = _row_ids(A)
        is_low = (A.cols >= 0) & (A.cols < rows)
        diag = fold_sum(torch.where(A.cols == rows, F, _zero(F)))
        self.dinv = 1.0 / torch.where(diag != 0, diag, torch.ones_like(diag))
        # strictly lower L; the diagonal is applied through dinv
        self.L = compact_ell(EllMatrix(
            vals=torch.where(is_low, F, _zero(F)),
            cols=torch.where(is_low, A.cols, torch.full_like(A.cols,
                                                             PAD_COL)),
            n_cols=A.n_rows))
        self.Lt = ell_transpose(self.L)
        return self

    def precond(self):
        L, Lt, dinv = self.L, self.Lt, self.dinv
        if L is None:
            raise RuntimeError("call setup(A) first")
        m = self.solve_sweeps

        def M(r):
            # forward: (L + D) y = r by Jacobi iteration
            y = dinv * r
            for _ in range(m):
                y = dinv * (r - L.mv(y))
            # backward: (D + L^T) x = y
            x = dinv * y
            for _ in range(m):
                x = dinv * (y - Lt.mv(x))
            return x

        return M


@dataclasses.dataclass
class DDICT(IC):
    """HYPRE_LSI_DDICTCreate analogue: incomplete Cholesky over
    per-subdomain diagonal blocks with ``overlap`` extra coupled rows at
    each boundary (the reference receives that many overlap rows from its
    neighbours, HYPRE_LSI_ddict.c)."""

    num_subdomains: int = 4
    overlap: int = 2
    fillin: float = 0.0   # -ddictFillin, kept for API parity: the
    # fixed-point kernel needs no pattern growth
    threshold: float = 0.0  # -ddictDropTol pre-drop

    def setup(self, A: EllMatrix, device=None) -> "DDICT":
        A = A.to(resolve_device(device))
        super().setup(overlap_block_pattern(A, self.num_subdomains,
                                            self.overlap, self.threshold),
                      device=A.device)
        return self


def overlap_block_pattern(A: EllMatrix, nblocks: int, overlap: int,
                          drop_tol: float) -> EllMatrix:
    """A restricted to block-diagonal-with-overlap: (i, j) stays when j
    falls in row i's block extended by ``overlap`` rows on each side."""
    n = A.n_rows
    bounds = np.linspace(0, n, nblocks + 1).astype(np.int64)
    block_of = np.repeat(np.arange(nblocks), np.diff(bounds))
    lo = torch.from_numpy(bounds[block_of] - overlap).to(A.device)
    hi = torch.from_numpy(bounds[block_of + 1] + overlap).to(A.device)
    c = A.cols.clamp(min=0)
    same = (A.cols >= 0) & (c >= lo[:, None]) & (c < hi[:, None])
    vals = A.vals
    if drop_tol > 0:
        rownorm = torch.where(A.cols >= 0, vals.abs(), _zero(vals)) \
            .amax(dim=1)
        same = same & ((vals.abs() >= drop_tol * rownorm[:, None])
                       | (A.cols == _row_ids(A)))
    return EllMatrix(vals=torch.where(same, vals, _zero(vals)),
                     cols=torch.where(same, A.cols,
                                      torch.full_like(A.cols, PAD_COL)),
                     n_cols=A.n_cols)


@dataclasses.dataclass
class DDILUT:
    """HYPRE_LSI_DDIlutCreate analogue: ILUT on per-subdomain blocks with
    overlap rows (HYPRE_LSI_ddilut.c's -ddilutFillin/-ddilutDropTol)."""

    num_subdomains: int = 4
    overlap: int = 2
    fillin: int = 8          # max kept entries per factor row
    drop_tol: float = 1e-3   # relative drop tolerance

    _ilut: Optional[ILUT] = dataclasses.field(default=None, repr=False)

    def setup(self, A: EllMatrix, device=None) -> "DDILUT":
        A = A.to(resolve_device(device))
        Ab = overlap_block_pattern(A, self.num_subdomains, self.overlap, 0.0)
        self._ilut = ILUT(drop_tol=self.drop_tol,
                          max_row_nnz=self.fillin).setup(Ab, device=A.device)
        return self

    def precond(self):
        return self._ilut.precond()
