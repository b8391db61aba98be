"""IJ assembly interface — hypre's IJ_mv layer (HYPRE_IJMatrix/IJVector).

Counterpart of ``hypre_tpu/ij.py``, the canonical assembly path
(``IJ_mv/HYPRE_IJMatrix.c:23,297,681``): Create -> SetValues /
AddToValues (any order) -> Assemble -> GetObject. hypre stages the
entries in an aux matrix and resolves them at assemble time; here that is
a host-side sort and reduce in numpy, as in the reference, and the object
``get_object`` returns lives on the requested device (CUDA unless the
caller names another).

Duplicate semantics follow hypre: AddToValues accumulates; SetValues
overwrites everything staged before it for that (row, col), and the
entries after it sum in staging order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hypre_tpu_torch.core.config import default_real_dtype, resolve_device
from hypre_tpu_torch.seq.csr import HostCSR
from hypre_tpu_torch.seq.ell import EllMatrix, _np_dtype, csr_to_ell


@dataclasses.dataclass
class IJMatrix:
    """HYPRE_IJMatrixCreate(comm, ilower, iupper, jlower, jupper) analogue."""

    nrows: int
    ncols: int

    def __post_init__(self):
        self._rows: list[np.ndarray] = []
        self._cols: list[np.ndarray] = []
        self._vals: list[np.ndarray] = []
        self._is_set: list[np.ndarray] = []
        self._obj = None

    def _stage(self, rows, cols, values, is_set: bool):
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        cols = np.atleast_1d(np.asarray(cols, dtype=np.int64))
        values = np.atleast_1d(np.asarray(values))
        rows, cols, values = np.broadcast_arrays(rows, cols, values)
        if rows.min(initial=0) < 0 or rows.max(initial=0) >= self.nrows:
            raise ValueError("row index out of range")
        if cols.min(initial=0) < 0 or cols.max(initial=0) >= self.ncols:
            raise ValueError("col index out of range")
        self._rows.append(rows.ravel())
        self._cols.append(cols.ravel())
        self._vals.append(values.ravel())
        self._is_set.append(np.full(rows.size, is_set, dtype=bool))
        self._obj = None

    def set_values(self, rows, cols, values) -> "IJMatrix":
        """HYPRE_IJMatrixSetValues — overwrites prior entries."""
        self._stage(rows, cols, values, True)
        return self

    def add_to_values(self, rows, cols, values) -> "IJMatrix":
        """HYPRE_IJMatrixAddToValues — accumulates."""
        self._stage(rows, cols, values, False)
        return self

    def assemble(self) -> "IJMatrix":
        """HYPRE_IJMatrixAssemble: resolve set/add ordering, dedupe, build."""
        if not self._rows:
            self._obj = HostCSR.from_coo([], [], [], (self.nrows, self.ncols))
            return self
        rows = np.concatenate(self._rows)
        cols = np.concatenate(self._cols)
        vals = np.concatenate(self._vals)
        sets = np.concatenate(self._is_set)
        seq = np.arange(rows.size, dtype=np.int64)
        # per (row, col), entries in staging order: the latest 'set' drops
        # everything staged before it, the rest sum in that order
        order = np.lexsort((seq, cols, rows))
        r, c, v, s = rows[order], cols[order], vals[order], sets[order]
        is_new = np.empty(r.size, dtype=bool)
        is_new[0] = True
        is_new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        group = np.cumsum(is_new) - 1
        n = r.size
        last_set_of_group = np.full(group[-1] + 1, -1, dtype=np.int64)
        np.maximum.at(last_set_of_group, group, np.where(s, np.arange(n), -1))
        keep = np.arange(n) >= last_set_of_group[group]
        summed = np.zeros(group[-1] + 1, dtype=vals.dtype)
        np.add.at(summed, group[keep], v[keep])
        self._obj = HostCSR.from_coo(
            r[is_new], c[is_new], summed, (self.nrows, self.ncols),
            sum_duplicates=False)
        return self

    # -- GetObject ------------------------------------------------------------

    def get_csr(self) -> HostCSR:
        if self._obj is None:
            raise RuntimeError("call assemble() first")
        return self._obj

    def get_object(self, k: Optional[int] = None, dtype=None,
                   device=None) -> EllMatrix:
        """HYPRE_IJMatrixGetObject (object_type HYPRE_PARCSR analogue): the
        assembled matrix as an EllMatrix on ``device``."""
        return csr_to_ell(self.get_csr(), k=k, dtype=dtype, device=device)

    def get_par_object(self, mesh, dtype=None):
        """Distributed variant: the assembled matrix partitioned over a
        shard mesh (``parallel.make_mesh``), as a ParEllMatrix on the
        mesh's device."""
        from hypre_tpu_torch.parallel.par_ell import partition_ell

        return partition_ell(self.get_object(dtype=dtype, device="cpu"),
                             mesh)


@dataclasses.dataclass
class IJVector:
    """HYPRE_IJVectorCreate analogue; values are staged on the host in
    ``dtype`` (float64)."""

    n: int
    dtype: type = np.float64

    def __post_init__(self):
        self._v = np.zeros(self.n, dtype=self.dtype)

    def set_values(self, indices, values) -> "IJVector":
        self._v[np.asarray(indices, dtype=np.int64)] = values
        return self

    def add_to_values(self, indices, values) -> "IJVector":
        np.add.at(self._v, np.asarray(indices, dtype=np.int64), values)
        return self

    def assemble(self) -> "IJVector":
        return self

    def get_object(self, dtype=None, device=None) -> torch.Tensor:
        """The vector on ``device`` in ``dtype`` (the port's real type by
        default; the reference returns JAX's default real type, float32
        unless x64 is on)."""
        dtype = dtype or default_real_dtype()
        return torch.from_numpy(self._v.astype(_np_dtype(dtype))).to(
            resolve_device(device))
