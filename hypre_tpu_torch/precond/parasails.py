"""ParaSails-style sparse approximate inverse (distributed_ls/ParaSails/).

Counterpart of ``hypre_tpu/precond/parasails.py``. hypre's ParaSails
builds M ~= A^{-1} by minimizing ||I - M A||_F row by row over a
thresholded power-of-A pattern (``ParaSails.c``, ``PrunedRows.c``). The
row problems are solved through the normal equations:

    min_{m_i on J_i} || e_i - m_i A ||_2
    =>  (A A^T)[J_i, J_i] m_i^T = A[J_i, i]

B = A A^T is formed once (``ell_spgemm``); every row then gathers
B[J_i, J_i] (in row chunks: at kB = 25 and k = 7 the lookup is 2.6 G
elements at n = 2 097 152) and one batched (n, k, k) solve follows.

The pattern follows hypre's knobs (``HYPRE_ParaSailsCreate``): ``thresh``
drops weak couplings (|a_ij| < thresh sqrt(|a_ii a_jj|)), ``nlevels``
expands the pruned pattern through that many products, capped to
``pattern_cap`` entries by the product magnitudes, and ``filter`` drops
small entries of M afterwards.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hypre_tpu_torch.core.config import PAD_COL, resolve_device
from hypre_tpu_torch.precond.common import gather_submatrices, lookup_chunked
from hypre_tpu_torch.precond.euclid import is_distributed
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.slabops import cap_slab, merge_slab
from hypre_tpu_torch.seq.spgemm import ell_spgemm, ell_transpose


@dataclasses.dataclass
class ParaSails:
    """HYPRE_ParaSails* object protocol (HYPRE_parcsr_ls.h:1658)."""

    thresh: float = 0.0  # pre-prune weak couplings (hypre thresh)
    nlevels: int = 0  # pattern power levels (hypre nlevels)
    filter: float = 0.0  # drop |m_ij| below filter * max|row| after solve
    pattern_cap: int = 24  # max pattern width after expansion

    M: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)

    def _pattern(self, A: EllMatrix) -> torch.Tensor:
        cols, avals = A.cols, A.vals.abs()
        pad = torch.full_like(cols, PAD_COL)
        if self.thresh > 0.0:
            diag = A.diagonal().abs()
            dj = torch.where(cols >= 0, diag[cols.clamp(min=0).long()],
                             torch.ones_like(avals))
            rows = torch.arange(A.n_rows, dtype=cols.dtype,
                                device=A.device)[:, None]
            keep = (cols >= 0) & ((cols == rows) | (
                avals >= self.thresh * torch.sqrt(diag[:, None] * dj)))
            cols = torch.where(keep, cols, pad)
            avals = torch.where(keep, avals, torch.zeros_like(avals))
        pc, pv = cols, avals
        for _ in range(max(self.nlevels, 0)):
            # pattern product with |values| as significance scores
            gb_c = cols[pc.clamp(min=0).long()]
            gb_v = avals[pc.clamp(min=0).long()]
            n, kp = pc.shape
            valid = (pc >= 0)[:, :, None] & (gb_c >= 0)
            cand_c = torch.where(valid, gb_c, torch.full_like(gb_c, PAD_COL)) \
                .reshape(n, -1)
            cand_v = torch.where(valid, pv[:, :, None] * gb_v,
                                 torch.zeros_like(gb_v)).reshape(n, -1)
            cand_c = torch.cat([pc, cand_c], dim=1)
            cand_v = torch.cat([pv, cand_v], dim=1)
            pc, pv, _ = merge_slab(cand_c, cand_v, cand_c.shape[1])
            pc, pv = cap_slab(pc, pv, self.pattern_cap)
        return pc

    def setup(self, A, device=None) -> "ParaSails":
        """Build M on ``device`` (CUDA unless the caller names another).
        On a ParEllMatrix the distributed ``ParSails`` (level-0 pattern,
        ``thresh``) builds it on the matrix's mesh, as the reference's
        does."""
        if is_distributed(A, "ParaSails"):
            from hypre_tpu_torch.precond.par_sails import ParSails

            self.M = ParSails(thresh=self.thresh).setup(A).M
            return self
        A = A.to(resolve_device(device))
        B = ell_spgemm(A, ell_transpose(A))  # A A^T (SPD Gram matrix)
        pattern = self._pattern(A)  # (n, kp)
        sub = gather_submatrices(B, pattern)
        # normal-equations rhs: (A e_i)[J_i] = A[J_i, i], the COLUMN of A
        row_ids = torch.arange(A.n_rows, dtype=pattern.dtype,
                               device=A.device)[:, None].expand(pattern.shape)
        rhs = lookup_chunked(A, pattern, row_ids)
        m = torch.linalg.solve(sub, rhs[..., None])[..., 0]
        m = torch.where(pattern >= 0, m, torch.zeros_like(m))
        if self.filter > 0.0:
            cap = self.filter * m.abs().amax(dim=1, keepdim=True)
            m = torch.where(m.abs() >= cap, m, torch.zeros_like(m))
        self.M = EllMatrix(vals=m, cols=pattern, n_cols=A.n_cols)
        return self

    def precond(self):
        M = self.M
        if M is None:
            raise RuntimeError("call setup(A) first")
        return M.mv
