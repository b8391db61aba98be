"""AIR — approximate ideal restriction for nonsymmetric AMG.

Counterpart of ``hypre_tpu/amg/air.py`` (hypre's lAIR, ``par_restr.c``;
dispatch at ``par_amg_setup.c:1987-2007``). For advection-dominated
operators Galerkin R = P^T transfers along the wrong direction; the ideal
restriction is R = [-A_CF A_FF^{-1}  I]. Distance-1 lAIR approximates each
C row locally: for C-point i with strong F neighbours J_i,

    r_i A[J_i, J_i] = -A[i, J_i]

one small dense solve per point, done as one batched (n, k, k) solve over
a padded pattern. The cycle is then nonsymmetric: pair it with GMRES or
BiCGSTAB.
"""

from __future__ import annotations

import torch

from hypre_tpu_torch.amg.coarsen import C_PT
from hypre_tpu_torch.core.config import PAD_COL
from hypre_tpu_torch.precond.common import lookup
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.spgemm import ell_filter


def air_restriction(A: EllMatrix, S: torch.Tensor, cf: torch.Tensor,
                    cmap: torch.Tensor, n_coarse: int) -> EllMatrix:
    """R (n_coarse x n_fine) with distance-1 lAIR weights; its rows are
    the C points in coarse order (``cmap`` numbers them in row order)."""
    n, k = A.cols.shape
    dev = A.device
    cols_c = A.cols.clamp(min=0).long()
    # per-row pattern: the strong F neighbours J_i, ascending, pads last
    is_f_col = S & (cf[cols_c] != C_PT)
    patt = torch.where(is_f_col, A.cols, torch.full_like(A.cols, PAD_COL))
    order = torch.argsort(torch.where(patt >= 0, patt,
                                      torch.full_like(patt, 2**30)),
                          dim=1, stable=True)
    patt = torch.gather(patt, 1, order)
    valid = patt >= 0

    # the dense local blocks A[J_i, J_i], identity on the padding
    sub = lookup(A, patt[:, :, None].expand(n, k, k),
                 patt[:, None, :].expand(n, k, k))
    pair = valid[:, :, None] & valid[:, None, :]
    sub = torch.where(pair, sub, torch.eye(k, dtype=A.dtype, device=dev)[None])
    row_ids = torch.arange(n, dtype=patt.dtype, device=dev)[:, None] \
        .expand(n, k)
    rhs = -torch.where(valid, lookup(A, row_ids, patt),
                       torch.zeros((), dtype=A.dtype, device=dev))
    # r_i A[J, J] = rhs  <=>  A[J, J]^T r_i^T = rhs^T
    w = torch.linalg.solve(sub.transpose(1, 2), rhs[..., None])[..., 0]
    w = torch.where(valid, w, torch.zeros_like(w))

    is_c = cf == C_PT
    r_cols = torch.cat([patt, torch.arange(n, dtype=patt.dtype,
                                           device=dev)[:, None]], 1)[is_c]
    r_vals = torch.cat([w, torch.ones((n, 1), dtype=A.dtype, device=dev)],
                       1)[is_c]
    R = ell_filter(EllMatrix(vals=r_vals, cols=r_cols, n_cols=n),
                   r_cols >= 0)
    width = max(int(R.structural_mask().sum(dim=1).max()), 1)
    return EllMatrix(vals=R.vals[:, :width], cols=R.cols[:, :width], n_cols=n)
