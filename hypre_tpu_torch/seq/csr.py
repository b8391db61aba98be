"""Host-side CSR utilities (numpy) for assembly and setup analysis.

Copy of ``hypre_tpu/seq/csr.py`` (numpy only), kept in the port so that it
imports nothing of the JAX package. Analogue of the host paths of hypre's
``seq_mv/csr_matrix.c`` / ``csr_matop.c``: the exact-nnz CSR format lives
only on the host, during problem assembly and as a reference oracle for
tests; everything that runs on the device uses the ELL format
(``seq/ell.py``).
"""

from __future__ import annotations

import numpy as np


class HostCSR:
    """Minimal CSR container: indptr (n+1,), indices (nnz,), data (nnz,)."""

    def __init__(self, indptr, indices, data, shape):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int64)
        self.data = np.asarray(data)
        self.shape = (int(shape[0]), int(shape[1]))

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_coo(rows, cols, vals, shape, sum_duplicates: bool = True) -> "HostCSR":
        """COO -> CSR with duplicate summation (hypre IJ AddToValues semantics,
        ``IJ_mv/IJMatrix_parcsr_device.c`` sort+reduce-by-key path)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and len(rows) > 0:
            is_new = np.empty(len(rows), dtype=bool)
            is_new[0] = True
            is_new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            group = np.cumsum(is_new) - 1
            summed = np.zeros(group[-1] + 1, dtype=vals.dtype)
            np.add.at(summed, group, vals)
            rows, cols, vals = rows[is_new], cols[is_new], summed
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return HostCSR(indptr, cols, vals, shape)

    @staticmethod
    def eye(n: int, dtype=np.float64) -> "HostCSR":
        return HostCSR(np.arange(n + 1), np.arange(n), np.ones(n, dtype), (n, n))

    # -- basic properties ---------------------------------------------------

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def max_row_nnz(self) -> int:
        return int(self.row_nnz().max()) if self.n_rows else 0

    def diagonal(self) -> np.ndarray:
        d = np.zeros(self.n_rows, dtype=self.data.dtype)
        for i in range(self.n_rows):
            seg = slice(self.indptr[i], self.indptr[i + 1])
            hits = self.indices[seg] == i
            if hits.any():
                d[i] = self.data[seg][hits].sum()
        return d

    # -- ops (reference oracles) --------------------------------------------

    def matvec(self, x: np.ndarray) -> np.ndarray:
        y = np.zeros(self.n_rows, dtype=np.result_type(self.data, x))
        np.add.at(
            y,
            np.repeat(np.arange(self.n_rows), self.row_nnz()),
            self.data * x[self.indices],
        )
        return y

    def transpose(self) -> "HostCSR":
        n, m = self.shape
        rows = np.repeat(np.arange(n), self.row_nnz())
        return HostCSR.from_coo(self.indices, rows, self.data, (m, n), sum_duplicates=False)

    def matmat(self, other: "HostCSR") -> "HostCSR":
        """Sort-based SpGEMM oracle (hypre: ``seq_mv/csr_spgemm_device.c``)."""
        assert self.shape[1] == other.shape[0]
        out_rows, out_cols, out_vals = [], [], []
        for i in range(self.n_rows):
            seg = slice(self.indptr[i], self.indptr[i + 1])
            acc: dict[int, float] = {}
            for j, a in zip(self.indices[seg], self.data[seg]):
                bseg = slice(other.indptr[j], other.indptr[j + 1])
                for k, b in zip(other.indices[bseg], other.data[bseg]):
                    acc[k] = acc.get(k, 0.0) + a * b
            for k, v in acc.items():
                out_rows.append(i)
                out_cols.append(k)
                out_vals.append(v)
        return HostCSR.from_coo(
            np.array(out_rows, dtype=np.int64),
            np.array(out_cols, dtype=np.int64),
            np.array(out_vals, dtype=self.data.dtype),
            (self.n_rows, other.shape[1]),
            sum_duplicates=False,
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        for i in range(self.n_rows):
            seg = slice(self.indptr[i], self.indptr[i + 1])
            np.add.at(out[i], self.indices[seg], self.data[seg])
        return out
