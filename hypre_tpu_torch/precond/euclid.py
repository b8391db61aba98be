"""Euclid and PILUT — hypre's distributed_ls parallel ILU factorizations.

Counterpart of ``hypre_tpu/precond/euclid.py``. Reference:
``distributed_ls/Euclid/`` (parallel ILU(k)/ILUT, ``Euclid_dh.c``,
``Euclid_apply.c``, wrapped by ``parcsr_ls/HYPRE_parcsr_Euclid.c``) and
``distributed_ls/pilut/`` (Karypis/Kumar parallel ILUT, ``parilut.c``).
Both spend most of their lines on MPI plumbing that extracts parallelism
from an exact factorization; the factorization here is parallel already
(the Chow-Patel fixed point of ``ilu.py``), so the two objects are
configuration shells that map the reference's knobs onto it:

- ``Euclid``: ILU(k) with Euclid's flags — ``level`` (fill), ``bj``
  (block Jacobi over per-subdomain diagonal blocks, ``-bj``),
  ``sparse_a`` (pre-drop small |a_ij|, ``-sparseA``) and ``row_scale``
  (rows scaled to unit inf-norm before factoring, ``-rowScale``).
- ``PILUT``: ILUT with pilut's ``factor_row_size`` and
  ``drop_tolerance``.

On a row-sharded ``ParEllMatrix`` both take the distributed path of
``precond/par_ilu.py``, as the reference's do: Euclid the distributed
Chow-Patel ILU (``ParILU``, after ``par_extend_pattern`` for ``level >
0``), PILUT the distributed ILUT (``ParILUT``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hypre_tpu_torch.core.config import PAD_COL, resolve_device
from hypre_tpu_torch.precond.ilu import ILU, ILUT, _row_ids, _zero
from hypre_tpu_torch.seq.ell import EllMatrix


def is_distributed(A, what: str) -> bool:
    """True for a row-sharded ParEllMatrix, False for a single-device
    EllMatrix; another operator type raises."""
    from hypre_tpu_torch.parallel.par_ell import ParEllMatrix

    if isinstance(A, ParEllMatrix):
        return True
    if isinstance(A, EllMatrix):
        return False
    raise TypeError(f"{what} takes an EllMatrix or a ParEllMatrix, not "
                    f"{type(A).__name__}")


def block_diag_pattern(A: EllMatrix, num_subdomains: int) -> EllMatrix:
    """A masked to its block diagonal: the entries whose column falls in
    the row's contiguous row block (Euclid's block-Jacobi subdomains)."""
    n = A.n_rows
    bounds = np.linspace(0, n, num_subdomains + 1).astype(np.int64)
    block_of = torch.from_numpy(
        np.repeat(np.arange(num_subdomains), np.diff(bounds))).to(A.device)
    same = (A.cols >= 0) & (block_of[A.cols.clamp(min=0).long()]
                            == block_of[:, None])
    return EllMatrix(vals=torch.where(same, A.vals, _zero(A.vals)),
                     cols=torch.where(same, A.cols,
                                      torch.full_like(A.cols, PAD_COL)),
                     n_cols=A.n_cols)


def _preprocess(A: EllMatrix, sparse_a: float, row_scale: bool,
                bj_blocks: int):
    """Euclid's -sparseA / -rowScale / -bj preprocessing: the matrix to
    factor and the row scaling (None when off)."""
    scale = None
    absv = torch.where(A.cols >= 0, A.vals.abs(), _zero(A.vals))
    if row_scale:
        absmax = absv.amax(dim=1)
        scale = 1.0 / torch.where(absmax > 0, absmax, torch.ones_like(absmax))
        A = EllMatrix(vals=A.vals * scale[:, None], cols=A.cols,
                      n_cols=A.n_cols)
        absv = torch.where(A.cols >= 0, A.vals.abs(), _zero(A.vals))
    if sparse_a > 0.0:
        rownorm = absv.amax(dim=1)
        keep = (A.cols >= 0) & ((A.vals.abs() >= sparse_a * rownorm[:, None])
                                | (A.cols == _row_ids(A)))
        A = EllMatrix(vals=torch.where(keep, A.vals, _zero(A.vals)),
                      cols=torch.where(keep, A.cols,
                                       torch.full_like(A.cols, PAD_COL)),
                      n_cols=A.n_cols)
    if bj_blocks > 1:
        A = block_diag_pattern(A, bj_blocks)
    return A, scale


@dataclasses.dataclass
class Euclid(ILU):
    """HYPRE_EuclidCreate / SetLevel / SetBJ / SetSparseA / SetRowScale
    analogue (``parcsr_ls/HYPRE_parcsr_ls.h:1860``, flag database
    ``distributed_ls/Euclid/Parser_dh.c``).

    On a ParEllMatrix the factorization is distributed (``ParILU`` on
    the ``level``-envelope of ``par_extend_pattern``) and runs on the
    matrix's own mesh and device; ``sparse_a``, ``row_scale`` and ``bj``
    are ignored there, as the reference ignores them."""

    level: int = 1            # -level: fill level k
    bj: int = 0               # -bj: block-Jacobi subdomains (0 = off)
    sparse_a: float = 0.0     # -sparseA: relative pre-drop threshold
    row_scale: bool = False   # -rowScale

    _row_scale_vec: object = dataclasses.field(default=None, init=False,
                                               repr=False)
    _par: object = dataclasses.field(default=None, init=False, repr=False)

    def setup(self, A, device=None) -> "Euclid":
        if is_distributed(A, "Euclid"):
            from hypre_tpu_torch.precond.par_ilu import (
                ParILU, par_extend_pattern,
            )

            Ax = par_extend_pattern(A, self.level) if self.level > 0 else A
            self._par = ParILU(factor_sweeps=self.factor_sweeps,
                               solve_sweeps=self.solve_sweeps).setup(Ax)
            self._row_scale_vec = None
            return self
        self._par = None
        A = A.to(resolve_device(device))
        Af, self._row_scale_vec = _preprocess(A, self.sparse_a,
                                              self.row_scale, self.bj)
        self.fill_level = self.level
        super().setup(Af, device=A.device)
        return self

    def precond(self):
        if self._par is not None:
            return self._par.precond()
        base = super().precond()
        scale = self._row_scale_vec
        if scale is None:
            return base
        return lambda r: base(scale * r)


@dataclasses.dataclass
class PILUT(ILUT):
    """HYPRE_ParCSRPilutCreate / SetFactorRowSize / SetDropTolerance
    analogue (``parcsr_ls/HYPRE_parcsr_ls.h:1996``,
    ``distributed_ls/pilut/``)."""

    factor_row_size: int = 20   # SetFactorRowSize (pilut default 20)
    drop_tolerance: float = 1e-4  # SetDropTolerance
    num_subdomains: int = 0     # > 1: block-Jacobi restriction, as -bj

    _par: object = dataclasses.field(default=None, init=False, repr=False)

    def setup(self, A, device=None) -> "PILUT":
        """On a ParEllMatrix: the distributed ILUT (``ParILUT``) with
        ``drop_tolerance`` and ``factor_row_size``, on the matrix's mesh."""
        if is_distributed(A, "PILUT"):
            from hypre_tpu_torch.precond.par_ilu import ParILUT

            self._par = ParILUT(drop_tolerance=self.drop_tolerance,
                                factor_row_size=self.factor_row_size
                                ).setup(A)
            return self
        self._par = None
        A = A.to(resolve_device(device))
        if self.num_subdomains > 1:
            A = block_diag_pattern(A, self.num_subdomains)
        self.max_row_nnz = self.factor_row_size
        self.drop_tol = self.drop_tolerance
        super().setup(A, device=A.device)
        return self

    def precond(self):
        if self._par is not None:
            return self._par.precond()
        return super().precond()
