"""Row-oriented matrix facade: hypre's distributed_matrix + matrix_matrix.

Counterpart of ``hypre_tpu/matrix_facade.py``. hypre's
``distributed_matrix/`` gives PILUT/Euclid a backend-agnostic row-access
protocol (``distributed_matrix.c``), and ``matrix_matrix/`` converts
ParCSR to it. Here a small protocol (``get_row``, shape, iteration) over
host CSR storage, with a converter from every storage type of the port,
so that host-side algorithms can consume any of them uniformly.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from hypre_tpu_torch.seq.csr import HostCSR
from hypre_tpu_torch.seq.ell import EllMatrix, ell_to_csr


@dataclasses.dataclass
class DistributedMatrix:
    """HYPRE_DistributedMatrix analogue: row access over host CSR storage."""

    csr: HostCSR

    @property
    def shape(self) -> tuple[int, int]:
        return self.csr.shape

    def get_row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(cols, values) of row i (HYPRE_DistributedMatrixGetRow)."""
        seg = slice(self.csr.indptr[i], self.csr.indptr[i + 1])
        return self.csr.indices[seg], self.csr.data[seg]

    def rows(self) -> Iterator[tuple[int, np.ndarray, np.ndarray]]:
        for i in range(self.shape[0]):
            cols, vals = self.get_row(i)
            yield i, cols, vals


def convert_to_distributed(A) -> DistributedMatrix:
    """hypre_ConvertParCSRMatrixToDistributedMatrix analogue: accepts any
    of the port's matrix types."""
    if isinstance(A, DistributedMatrix):
        return A
    if isinstance(A, HostCSR):
        return DistributedMatrix(A)
    if isinstance(A, EllMatrix):
        return DistributedMatrix(ell_to_csr(A))
    if getattr(A, "ell", None) is not None:  # BandedEll
        return DistributedMatrix(ell_to_csr(A.ell))
    if hasattr(A, "to_ell"):  # BsrMatrix
        return DistributedMatrix(ell_to_csr(A.to_ell()))
    if hasattr(A, "to_dense"):  # Struct/Dia/SStruct-style operators
        dense = np.asarray(A.to_dense().cpu())
        rows, cols = np.nonzero(dense)
        return DistributedMatrix(
            HostCSR.from_coo(rows, cols, dense[rows, cols], dense.shape))
    raise TypeError(f"cannot convert {type(A).__name__}")
