"""SStructMatrix — per-part stencil matrices + unstructured graph couplings.

Counterpart of ``hypre_tpu/sstruct/matrix.py`` (hypre's PMatrix/UMatrix
split, ``_hypre_sstruct_mv.h:555-616``): the structured intra-part
coupling lives in StructMatrix parts, everything irregular (inter-part
neighbour entries, HYPRE_SStructGraphAddEntries) in a flat EllMatrix ``U``
over the concatenated global index space.

``mv`` keeps the reference's order (``sstruct_matvec.c:262-319``): the
part products, concatenated, then ``+ U x``. Each part applies through its
DIA view (``StructMatrix.mv``: the DIA kernels on the card); ``U`` through
the format ``seq/fastmv.py::optimize_operator`` picks for it, built once
per matrix and kept with it (the glued parts of the sstruct driver give
two mostly-zero diagonals at +-n: a DIA view).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.seq.csr import HostCSR
from hypre_tpu_torch.seq.ell import EllMatrix, csr_to_ell
from hypre_tpu_torch.sstruct.grid import SStructGrid
from hypre_tpu_torch.struct.matrix import StructMatrix


def coupling_operator(U: EllMatrix):
    """The product format of a U matrix: its DIA view when it decomposes
    into at most 48 diagonals (with the row list when that is the smaller
    layout), else the banded format on the card when it is large and
    banded enough, else U itself."""
    from hypre_tpu_torch.seq.dia import DiaMatrix, compact_dia
    from hypre_tpu_torch.seq.fastmv import optimize_operator

    op = optimize_operator(U)
    return compact_dia(op) if isinstance(op, DiaMatrix) else op


@dataclasses.dataclass(frozen=True)
class SStructMatrix:
    parts: tuple[StructMatrix, ...]
    U: Optional[EllMatrix]  # (N, N) over the flat global space; None if empty
    grid: SStructGrid

    @property
    def n_rows(self) -> int:
        return self.grid.total_size

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def to(self, device) -> "SStructMatrix":
        return SStructMatrix(
            parts=tuple(P.to(device) for P in self.parts),
            U=None if self.U is None else self.U.to(device), grid=self.grid)

    @property
    def U_op(self):
        """U's product format (``coupling_operator``), built at first use."""
        store = self.__dict__.setdefault("_cache", {})
        if "U_op" not in store:
            store["U_op"] = coupling_operator(self.U)
        return store["U_op"]

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x on the flat global vector (hypre_SStructMatvec)."""
        if x.dim() != 1 or x.shape[0] != self.n_rows:
            raise ValueError(f"shape mismatch: {self.n_rows} rows @ "
                             f"{tuple(x.shape)}")
        xs = self.grid.split(x)
        y = torch.cat([P.mv(xp).reshape(-1)
                       for P, xp in zip(self.parts, xs)])
        if self.U is not None:
            y = y + self.U_op.mv(x)
        return y

    def as_linear_op(self):
        return self.mv

    def to_dense(self) -> torch.Tensor:
        """(n, n) dense matrix: ``mv`` on the unit columns."""
        eye = torch.eye(self.n_rows, dtype=self.dtype, device=self.device)
        return torch.stack([self.mv(e) for e in eye], dim=1)


class SStructGraphBuilder:
    """HYPRE_SStructGraphAddEntries analogue: collect non-stencil couplings
    ((part, index) -> (to_part, to_index) with a value), then build the U
    EllMatrix."""

    def __init__(self, grid: SStructGrid):
        self.grid = grid
        self._rows: list[int] = []
        self._cols: list[int] = []
        self._vals: list[float] = []

    def add_entry(self, part, index, to_part, to_index,
                  value) -> "SStructGraphBuilder":
        self._rows.append(self.grid.global_index(
            part, tuple(np.atleast_1d(index))))
        self._cols.append(self.grid.global_index(
            to_part, tuple(np.atleast_1d(to_index))))
        self._vals.append(float(value))
        return self

    def build(self, dtype=None, device=None) -> Optional[EllMatrix]:
        """U on ``device`` (CUDA unless the caller names another), float32
        unless ``dtype``; None when no entry was added."""
        if not self._rows:
            return None
        n = self.grid.total_size
        csr = HostCSR.from_coo(self._rows, self._cols, self._vals, (n, n))
        return csr_to_ell(csr, dtype=dtype, device=resolve_device(device))


def sstruct_matrix(
    parts: list[StructMatrix],
    grid: SStructGrid,
    graph: Optional[SStructGraphBuilder] = None,
) -> SStructMatrix:
    """The SStructMatrix of ``parts`` and the graph's U, on the parts'
    device and in their type."""
    U = None if graph is None else graph.build(dtype=parts[0].dtype,
                                               device=parts[0].device)
    return SStructMatrix(parts=tuple(parts), U=U, grid=grid)
