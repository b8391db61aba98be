"""EllMatrix — the on-device static-shape sparse format.

PyTorch counterpart of ``hypre_tpu/seq/ell.py``: a dense ``(n_rows, k)``
slab of values plus a matching slab of column indices, rows padded to the
largest row count ``k``. The stencil matrices multigrid lives on have
uniform row counts (5/7/27), so the padding is near zero where it matters,
and every structural operation (transpose, SpGEMM, masking) is a
fixed-shape sort/segment problem.

Padding convention: unused slots hold ``cols == PAD_COL (-1)`` and
``vals == 0``. Numeric code may clip the index (the zero value makes the
contribution inert); structural code masks with ``cols >= 0``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hypre_tpu_torch.core.config import (
    PAD_COL, default_real_dtype, fold_sum, resolve_device, tensors_to,
)
from hypre_tpu_torch.seq.csr import HostCSR


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Static-shape ELL sparse matrix.

    vals: (n_rows, k) real — padded entries are 0.
    cols: (n_rows, k) int32 — padded entries are PAD_COL.
    n_cols: logical column-space size.
    shifts: optional structural annotation — cols[i, s] == i + shifts[s]
    at every valid slot (a boundary-truncated stencil in lexicographic
    order), set by the stencil generators. Advisory only.
    """

    vals: torch.Tensor
    cols: torch.Tensor
    n_cols: int
    shifts: Optional[tuple] = None

    @property
    def n_rows(self) -> int:
        return self.vals.shape[0]

    @property
    def k(self) -> int:
        return self.vals.shape[1]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device) -> "EllMatrix":
        return tensors_to(self, device)

    def structural_mask(self) -> torch.Tensor:
        return self.cols >= 0

    # -- row-local queries used throughout AMG setup -------------------------

    def _row_ids(self) -> torch.Tensor:
        return torch.arange(self.n_rows, dtype=self.cols.dtype,
                            device=self.cols.device)[:, None]

    def diagonal(self) -> torch.Tensor:
        """d_i = sum of entries with col == row (no ordering assumption)."""
        return fold_sum(torch.where(self.cols == self._row_ids(), self.vals,
                                    torch.zeros_like(self.vals)))

    def row_sums(self) -> torch.Tensor:
        return fold_sum(self.vals)

    def abs_row_sums(self) -> torch.Tensor:
        return fold_sum(self.vals.abs())

    def offdiag_mask(self) -> torch.Tensor:
        return (self.cols != self._row_ids()) & self.structural_mask()

    def scale_rows(self, s: torch.Tensor) -> "EllMatrix":
        return dataclasses.replace(self, vals=self.vals * s[:, None])

    # -- operator protocol (shared by every level operator, like hypre's
    #    matvec vtable HYPRE_MatvecFunctions.h) -------------------------------

    @property
    def vec_len_rows(self) -> int:
        return self.n_rows

    @property
    def vec_len_cols(self) -> int:
        return self.n_cols

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return ell_spmv(self, x)

    def mv_t(self, x: torch.Tensor) -> torch.Tensor:
        return ell_spmv_t(self, x)

    def _masked_apply(self, x: torch.Tensor, sign: int) -> torch.Tensor:
        rel = (self.cols - self._row_ids()) * sign
        keep = (rel > 0) & self.structural_mask()
        g = x[self.cols.clamp(min=0).long()]
        return fold_sum(torch.where(keep, self.vals, torch.zeros_like(
            self.vals)) * g)

    def lower_apply(self, x: torch.Tensor) -> torch.Tensor:
        """L x, L the strict lower triangle (slot mask, no new matrix)."""
        return self._masked_apply(x, -1)

    def upper_apply(self, x: torch.Tensor) -> torch.Tensor:
        """U x, U the strict upper triangle."""
        return self._masked_apply(x, 1)


# ---------------------------------------------------------------------------
# SpMV (hypre_CSRMatrixMatvec, seq_mv/csr_matvec.c:699)
# ---------------------------------------------------------------------------


def ell_spmv(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: gather + row reduction."""
    if x.shape[0] != A.n_cols:
        raise ValueError(
            f"shape mismatch: A is {A.shape}, x has {x.shape[0]} rows")
    gathered = x[A.cols.clamp(min=0).long()]
    if x.ndim == 1:
        return (A.vals * gathered).sum(dim=1)
    return (A.vals[:, :, None] * gathered).sum(dim=1)


def ell_spmv_t(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A.T @ x via scatter-add (hypre_CSRMatrixMatvecT)."""
    if x.shape[0] != A.n_rows:
        raise ValueError(
            f"shape mismatch: A.T is {A.shape[::-1]}, x has {x.shape[0]} rows")
    cols = A.cols.clamp(min=0).reshape(-1).long()
    contrib = (A.vals * x[:, None]).reshape(-1)
    contrib = torch.where(A.cols.reshape(-1) >= 0, contrib,
                          torch.zeros_like(contrib))
    y = torch.zeros(A.n_cols, dtype=contrib.dtype, device=contrib.device)
    return y.index_put_((cols,), contrib, accumulate=True)


# ---------------------------------------------------------------------------
# Host conversion
# ---------------------------------------------------------------------------


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def csr_to_ell(csr: HostCSR, k: int | None = None, dtype=None,
               device=None) -> EllMatrix:
    """Pad host CSR rows to width k (defaults to max row nnz)."""
    device = resolve_device(device)
    dtype = _np_dtype(dtype or default_real_dtype())
    n = csr.n_rows
    if k is None:
        k = max(csr.max_row_nnz(), 1)
    vals = np.zeros((n, k), dtype=dtype)
    cols = np.full((n, k), PAD_COL, dtype=np.int32)
    row_nnz = csr.row_nnz()
    if int(row_nnz.max(initial=0)) > k:
        raise ValueError(f"row nnz {int(row_nnz.max())} exceeds ELL width {k}")
    rows = np.repeat(np.arange(n), row_nnz)
    within = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], row_nnz)
    vals[rows, within] = csr.data
    cols[rows, within] = csr.indices
    return EllMatrix(vals=torch.from_numpy(vals).to(device),
                     cols=torch.from_numpy(cols).to(device),
                     n_cols=csr.shape[1])


def ell_to_csr(A: EllMatrix) -> HostCSR:
    """Device ELL -> host CSR (test oracle path)."""
    vals = A.vals.cpu().numpy()
    cols = A.cols.cpu().numpy()
    mask = cols >= 0
    rows = np.repeat(np.arange(A.n_rows), A.k).reshape(A.n_rows, A.k)
    return HostCSR.from_coo(
        rows[mask], cols[mask], vals[mask], (A.n_rows, A.n_cols),
        sum_duplicates=True,
    )


def ell_from_dense(M: np.ndarray, k: int | None = None,
                   device=None) -> EllMatrix:
    n, m = M.shape
    rows, cols = np.nonzero(M)
    return csr_to_ell(
        HostCSR.from_coo(rows, cols, M[rows, cols], (n, m)), k=k,
        dtype=M.dtype, device=device,
    )
