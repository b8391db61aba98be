"""SStruct FEM assembly — HYPRE_SStructMatrixAddFEMValues and friends.

Counterpart of ``hypre_tpu/sstruct/fem.py`` (``HYPRE_sstruct_matrix.c:361``,
``HYPRE_SStructGridSetFEMOrdering``): the grid declares, per part, the
element's dof list as (variable, node offset) pairs, and AddFEMValues
scatters an element matrix for the element at ``index`` into the dofs at
``index + offset``. Shared nodes across parts are identified through the
grid (``share_node``). Dofs are numbered at first use and the system lands
in the IJ layer (sorted COO -> ELL), one element per call as in hypre's
API; the Dirichlet elimination is a set of tensor ``where``s on the
assembled ELL slabs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.ij import IJMatrix
from hypre_tpu_torch.seq.ell import EllMatrix


@dataclasses.dataclass
class SStructFEMGrid:
    """Node grids per part + per-part FEM dof ordering + shared dofs."""

    part_shapes: Sequence[tuple]  # NODE-grid shapes per part
    nvars: int = 1

    _fem_vars: Dict = dataclasses.field(default_factory=dict, repr=False)
    _fem_offsets: Dict = dataclasses.field(default_factory=dict, repr=False)
    _alias: Dict = dataclasses.field(default_factory=dict, repr=False)
    _numbering: Optional[Dict] = dataclasses.field(default=None, repr=False)

    def set_fem_ordering(self, part: int, fem_vars: Sequence[int],
                         fem_offsets: Sequence[tuple]) -> "SStructFEMGrid":
        """HYPRE_SStructGridSetFEMOrdering: the element dof list as
        (variable, node offset) pairs, in the order element matrices use."""
        if len(fem_vars) != len(fem_offsets):
            raise ValueError("fem_vars and fem_offsets differ in length")
        self._fem_vars[part] = tuple(int(v) for v in fem_vars)
        self._fem_offsets[part] = tuple(tuple(o) for o in fem_offsets)
        return self

    def share_node(self, part, index, other_part, other_index
                   ) -> "SStructFEMGrid":
        """Identify (part, index) with (other_part, other_index) for every
        variable — the SetSharedPart / neighbour-part dof identification."""
        self._alias[(part, tuple(index))] = (other_part, tuple(other_index))
        return self

    def _canon(self, part, index):
        key = (part, tuple(index))
        seen = set()
        while key in self._alias and key not in seen:
            seen.add(key)
            key = self._alias[key]
        return key

    def dof(self, part, index, var) -> int:
        """Global dof number (first-use numbering of canonical nodes)."""
        if self._numbering is None:
            self._numbering = {}
        key = self._canon(part, index) + (var,)
        if key not in self._numbering:
            self._numbering[key] = len(self._numbering)
        return self._numbering[key]

    @property
    def n_dofs(self) -> int:
        return len(self._numbering or {})


def eliminate_dirichlet(A: EllMatrix, rows: torch.Tensor
                        ) -> tuple[EllMatrix, EllMatrix]:
    """A with the Dirichlet rows ``rows`` replaced by identity rows and
    their columns zeroed off the diagonal (symmetric elimination), and
    the column entries it took out, on A's pattern (their product with
    the BC values moves to the rhs)."""
    n = A.n_rows
    is_bc = torch.zeros(n, dtype=torch.bool, device=A.device)
    is_bc[rows] = True
    rid = torch.arange(n, device=A.device)[:, None]
    cols = A.cols.long()
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    on_diag = cols == rid
    keep = ~is_bc[:, None] | on_diag
    vals = torch.where(keep & (cols >= 0), A.vals, zero)
    vals = torch.where(on_diag & is_bc[:, None], torch.ones_like(vals), vals)
    colbc = (cols >= 0) & is_bc[cols.clamp(min=0)] & ~on_diag
    return (EllMatrix(vals=torch.where(colbc, zero, vals), cols=A.cols,
                      n_cols=A.n_cols),
            EllMatrix(vals=torch.where(colbc, vals, zero), cols=A.cols,
                      n_cols=A.n_cols))


@dataclasses.dataclass
class SStructFEMMatrix:
    """AddFEMValues-accumulating assembler (HYPRE_SStructMatrix FEM mode);
    ``assemble`` builds A and b on ``device`` (CUDA unless the caller
    names another) in ``dtype`` (float32 unless the caller names
    another)."""

    grid: SStructFEMGrid
    dtype: torch.dtype = torch.float32
    device: object = None

    _rows: List = dataclasses.field(default_factory=list, repr=False)
    _cols: List = dataclasses.field(default_factory=list, repr=False)
    _vals: List = dataclasses.field(default_factory=list, repr=False)
    _rhs: Dict = dataclasses.field(default_factory=dict, repr=False)
    A: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    b: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)

    def _elem_dofs(self, part, index):
        fvars = self.grid._fem_vars[part]
        foffs = self.grid._fem_offsets[part]
        return [self.grid.dof(part, tuple(i + o for i, o in zip(index, off)),
                              var)
                for var, off in zip(fvars, foffs)]

    def add_fem_values(self, part, index, values) -> "SStructFEMMatrix":
        """HYPRE_SStructMatrixAddFEMValues: scatter the element matrix for
        the element anchored at ``index`` into its declared dofs."""
        dofs = self._elem_dofs(part, index)
        ke = np.asarray(values, float).reshape(len(dofs), len(dofs))
        self._rows.append(np.repeat(dofs, len(dofs)))
        self._cols.append(np.tile(dofs, len(dofs)))
        self._vals.append(ke.reshape(-1))
        return self

    def add_fem_rhs(self, part, index, values) -> "SStructFEMMatrix":
        """HYPRE_SStructVectorAddFEMValues for the right-hand side."""
        dofs = self._elem_dofs(part, index)
        for d, v in zip(dofs, np.asarray(values, float)):
            self._rhs[d] = self._rhs.get(d, 0.0) + float(v)
        return self

    def assemble(self, dirichlet: Sequence[int] = ()) -> "SStructFEMMatrix":
        n = self.grid.n_dofs
        ij = IJMatrix(n, n)
        if self._rows:
            ij.add_to_values(np.concatenate(self._rows),
                             np.concatenate(self._cols),
                             np.concatenate(self._vals))
        dev = resolve_device(self.device)
        A = ij.assemble().get_object(dtype=self.dtype, device=dev)
        rhs = np.zeros(n)
        for d, v in self._rhs.items():
            rhs[d] += v
        if len(dirichlet):
            rows = sorted(set(int(d) for d in dirichlet))
            A, _ = eliminate_dirichlet(A, torch.tensor(rows, device=dev))
            rhs[np.asarray(rows)] = 0.0
        self.A = A
        self.b = torch.from_numpy(rhs).to(dev, self.dtype)
        return self
