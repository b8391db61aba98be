"""Interpolation operator construction: extended+i and truncation.

Counterpart of ``hypre_tpu/amg/interp.py`` (``ext_plus_i_interp`` and
``truncate_interp``; the other interpolations come later). Extended+i is
hypre's distance-two interpolation (hypre_BoomerAMGBuildExtPIInterp,
``par_lr_interp.c``) in the modified MM form: for an F-point i,

    w_ij = -[ a_ij + sum_{k in F_i^s} a_ik â_kj / theta_k ] / d_i
    theta_k = sum_{m in C_k^s} â_km + â_ki
    d_i = a_ii + sum_weak a_in + sum_{k in F_i^s} a_ik â_ki / theta_k

(â = entries of sign opposite to the row's diagonal; strong-F rows with
theta = 0 are lumped onto the diagonal).
"""

from __future__ import annotations

import torch

from hypre_tpu_torch.amg.coarsen import C_PT
from hypre_tpu_torch.core.config import PAD_COL, fold_sum
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.spgemm import _merge_rows, ell_filter, ell_remap_cols

# candidate elements (rows x (k + k^2)) per block of ext+i rows: bounds the
# memory of the neighbour-row gathers and of the merge sort; rows are
# independent, so the block size does not change the result
_EXT_PI_BLOCK_ELEMENTS = 64e6


def _where0(mask, x):
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ext_pi_block(A: EllMatrix, S, cf, a_hat, diag, strongC_full, lo: int,
                  blk: int, out_k: int):
    """Candidate generation + merge for rows [lo, lo+blk). Returns merged
    (blk, out_k+1) cols/vals (the C-point identity slot appended) and the
    required width."""
    dev = A.device
    rows = torch.arange(lo, lo + blk, dtype=torch.int32, device=dev)
    cols_b = A.cols[lo:lo + blk]
    vals_b = A.vals[lo:lo + blk]
    S_b = S[lo:lo + blk]
    cols_c = cols_b.clamp(min=0).long()

    is_c_col = cf[cols_c] == C_PT
    strongC = S_b & is_c_col
    strongF = S_b & ~is_c_col

    nb_cols = A.cols.clamp(min=0)[cols_c]  # (blk, k, k)
    nb_strongC = strongC_full[cols_c]
    nb_ahat = a_hat[cols_c]

    # â_ki: row k's sign-filtered coupling back to row i
    back = fold_sum(_where0(nb_cols == rows[:, None, None], nb_ahat), dim=2)
    theta = fold_sum(_where0(nb_strongC, nb_ahat), dim=2) + back
    theta_safe = torch.where(theta != 0, theta, torch.ones_like(theta))
    usable_F = strongF & (theta != 0)

    diag_b = diag[lo:lo + blk]
    weak = (cols_b >= 0) & (cols_b != rows[:, None]) & ~S_b
    d_eff = (
        diag_b
        + fold_sum(_where0(weak, vals_b))
        + fold_sum(_where0(usable_F, vals_b * back / theta_safe))
        + fold_sum(_where0(strongF & (theta == 0), vals_b))
    )

    cand1_cols = torch.where(strongC, cols_b, torch.full_like(cols_b, PAD_COL))
    cand1_vals = _where0(strongC, vals_b)
    through = usable_F[:, :, None] & nb_strongC
    w2 = _where0(through, vals_b[:, :, None] * nb_ahat / theta_safe[:, :, None])
    cand2_cols = torch.where(through, nb_cols, torch.full_like(nb_cols, PAD_COL))
    mc, mv, req = _merge_rows(
        torch.cat([cand1_cols, cand2_cols.reshape(blk, -1)], dim=1),
        torch.cat([cand1_vals, w2.reshape(blk, -1)], dim=1),
        out_k,
    )
    d_safe = torch.where(d_eff != 0, d_eff, torch.ones_like(d_eff))
    w = -mv / d_safe[:, None]
    cf_b = cf[lo:lo + blk]
    is_f = (cf_b != C_PT)[:, None]
    w = _where0(is_f, w)
    mc = torch.where(is_f, mc, torch.full_like(mc, PAD_COL))
    own = torch.where(cf_b == C_PT, rows, torch.full_like(rows, PAD_COL))[:, None]
    ones = (cf_b == C_PT).to(A.dtype)[:, None]
    return torch.cat([mc, own], dim=1), torch.cat([w, ones], dim=1), int(req)


def ext_plus_i_interp(
    A: EllMatrix,
    S: torch.Tensor,
    cf: torch.Tensor,
    cmap: torch.Tensor,
    n_coarse: int,
    out_k: int | None = None,
    row_block: int = 131072,
) -> EllMatrix:
    """Extended+i interpolation, modified MM form (see the module doc).

    Candidate generation gathers each row's neighbour rows — an O(n k^2)
    slab — so rows go in blocks of at most ``row_block`` rows, fewer where
    a block would exceed ``_EXT_PI_BLOCK_ELEMENTS`` candidates.
    """
    n, k = A.cols.shape
    diag = A.diagonal()
    sgn = torch.where(diag >= 0, 1.0, -1.0).to(A.dtype)
    a_hat = _where0(A.vals * sgn[:, None] < 0, A.vals)
    strongC_full = S & (cf[A.cols.clamp(min=0).long()] == C_PT)
    if out_k is None:
        out_k = min(max(4 * k, 8), 64)
    blk_rows = max(1, min(row_block, int(_EXT_PI_BLOCK_ELEMENTS // (k + k * k))))

    def run(out_k: int):
        mcs, mvs, req_max = [], [], 0
        for lo in range(0, n, blk_rows):
            blk = min(blk_rows, n - lo)
            mc, mv, req = _ext_pi_block(A, S, cf, a_hat, diag, strongC_full,
                                        lo, blk, out_k)
            mcs.append(mc)
            mvs.append(mv)
            req_max = max(req_max, req)
        return torch.cat(mcs, 0), torch.cat(mvs, 0), req_max

    mc, mv, req = run(out_k)
    if req > out_k:
        mc, mv, _ = run(req)
    P = EllMatrix(vals=mv, cols=mc, n_cols=n)
    # renumber fine C-columns into the coarse index space
    fine_to_coarse = torch.where(cf == C_PT, cmap, torch.full_like(cmap, -1))
    P = ell_remap_cols(P, fine_to_coarse, int(n_coarse))
    P = ell_filter(P, P.structural_mask())
    width = max(int(P.structural_mask().sum(dim=1).max()), 1)
    return EllMatrix(vals=P.vals[:, :width], cols=P.cols[:, :width],
                     n_cols=P.n_cols)


def truncate_interp(P: EllMatrix, max_elmts: int = 0,
                    trunc_factor: float = 0.0) -> EllMatrix:
    """hypre_BoomerAMGInterpTruncation (par_interp_trunc_device.c).

    Keeps at most ``max_elmts`` largest-|w| entries per row (ties broken by
    slot order: stable sort) and drops entries with |w| < trunc_factor *
    max|w| in the row, then rescales the survivors so the row sum is
    preserved.
    """
    if max_elmts <= 0 and trunc_factor <= 0.0:
        return P
    mask = P.structural_mask()
    absw = torch.where(mask, P.vals.abs(), torch.full_like(P.vals, -1.0))
    keep = mask
    if trunc_factor > 0.0:
        row_max = absw.amax(dim=1, keepdim=True)
        keep = keep & (absw >= trunc_factor * row_max)
    if 0 < max_elmts < P.k:
        # rank of each entry by |w| within its row (descending)
        order = torch.argsort(-absw, dim=1, stable=True)
        rank = torch.argsort(order, dim=1)
        keep = keep & (rank < max_elmts)
    old_sum = P.row_sums()
    Pt = ell_filter(P, keep, out_k=max_elmts if 0 < max_elmts < P.k else None)
    new_sum = Pt.row_sums()
    nz = new_sum != 0
    scale = torch.where(nz, old_sum / torch.where(nz, new_sum,
                                                  torch.ones_like(new_sum)),
                        torch.ones_like(new_sum))
    return Pt.scale_rows(scale)
