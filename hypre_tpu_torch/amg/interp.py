"""Interpolation: direct, classical, extended+i, multipass, Jacobi
improvement and truncation.

Counterpart of ``hypre_tpu/amg/interp.py``. Extended+i is hypre's
distance-two interpolation (hypre_BoomerAMGBuildExtPIInterp,
``par_lr_interp.c``) in the modified MM form: for an F-point i,

    w_ij = -[ a_ij + sum_{k in F_i^s} a_ik â_kj / theta_k ] / d_i
    theta_k = sum_{m in C_k^s} â_km + â_ki
    d_i = a_ii + sum_weak a_in + sum_{k in F_i^s} a_ik â_ki / theta_k

(â = entries of sign opposite to the row's diagonal; strong-F rows with
theta = 0 are lumped onto the diagonal). Direct interpolation
(par_interp.c, sign-split) and classical interpolation (common-C
distribution of the strong-F mass) are row-local slab code as well;
multipass interpolation (par_multi_interp.c) walks the strong graph pass
by pass on the host, as in the reference. Sums over a row's slots run in
slot order (``fold_sum``), so the card and the CPU build the same P.
"""

from __future__ import annotations

import numpy as np
import torch

from hypre_tpu_torch.amg.coarsen import C_PT
from hypre_tpu_torch.core.config import PAD_COL, fold_sum
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.spgemm import (
    _merge_rows, ell_add, ell_filter, ell_remap_cols, ell_spgemm,
)

# candidate elements (rows x (k + k^2)) per block of ext+i rows: bounds the
# memory of the neighbour-row gathers and of the merge sort; rows are
# independent, so the block size does not change the result
_EXT_PI_BLOCK_ELEMENTS = 64e6


def _where0(mask, x):
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _compact(P: EllMatrix) -> EllMatrix:
    """Drop dead slots so P's width is its true largest row fill."""
    P = ell_filter(P, P.structural_mask())
    width = max(int(P.structural_mask().sum(dim=1).max()), 1)
    return EllMatrix(vals=P.vals[:, :width], cols=P.cols[:, :width],
                     n_cols=P.n_cols)


def _with_c_rows(A: EllMatrix, cf, mc, w):
    """F rows' merged (cols, weights) plus the C-point identity slot."""
    n = A.n_rows
    rows = torch.arange(n, dtype=torch.int32, device=A.device)
    is_f = (cf != C_PT)[:, None]
    w = _where0(is_f, w)
    mc = torch.where(is_f, mc, torch.full_like(mc, PAD_COL))
    own = torch.where(cf == C_PT, rows, torch.full_like(rows, PAD_COL))
    ones = (cf == C_PT).to(A.dtype)
    return torch.cat([mc, own[:, None]], 1), torch.cat([w, ones[:, None]], 1)


def _ext_pi_block(A: EllMatrix, S, cf, a_hat, diag, strongC_full, lo: int,
                  blk: int, out_k: int):
    """Candidate generation + merge for rows [lo, lo+blk). Returns the
    merged (blk, out_k) cols and weights (F rows only meaningful) and the
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
    return mc, -mv / d_safe[:, None], int(req)


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

    mc, w, req = run(out_k)
    if req > out_k:
        mc, w, _ = run(req)
    mc, w = _with_c_rows(A, cf, mc, w)
    # renumber fine C-columns into the coarse index space
    fine_to_coarse = torch.where(cf == C_PT, cmap, torch.full_like(cmap, -1))
    return _compact(ell_remap_cols(EllMatrix(vals=w, cols=mc, n_cols=n),
                                   fine_to_coarse, int(n_coarse)))


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


def direct_interp(A: EllMatrix, S: torch.Tensor, cf: torch.Tensor,
                  cmap: torch.Tensor, n_coarse: int) -> EllMatrix:
    """Direct interpolation, sign-split (hypre_BoomerAMGBuildDirInterp):
    for F-point i with strong C set C_i,

        alfa_i = sum_{k != i} a_ik^- / sum_{j in C_i} a_ij^-   (beta_i for +)
        w_ij = -alfa_i a_ij / a_ii  (a_ij < 0),  -beta_i a_ij / a_ii  (> 0)

    with the positive mass lumped onto the diagonal when C_i has no
    positive entry. C rows are identity."""
    offd = A.offdiag_mask()
    cols_c = A.cols.clamp(min=0).long()
    diag = A.diagonal()
    is_strong_c = S & (cf[cols_c] == C_PT)
    neg = A.vals < 0
    pos = A.vals > 0
    sum_n_neg = fold_sum(_where0(offd & neg, A.vals))
    sum_n_pos = fold_sum(_where0(offd & pos, A.vals))
    sum_p_neg = fold_sum(_where0(is_strong_c & neg, A.vals))
    sum_p_pos = fold_sum(_where0(is_strong_c & pos, A.vals))
    one = torch.ones_like(diag)
    have_pos_c = sum_p_pos != 0
    diag_eff = torch.where(have_pos_c, diag, diag + sum_n_pos)
    alfa = sum_n_neg / torch.where(sum_p_neg != 0, sum_p_neg, one)
    beta = _where0(have_pos_c,
                   sum_n_pos / torch.where(have_pos_c, sum_p_pos, one))
    safe_diag = torch.where(diag_eff != 0, diag_eff, one)
    w = torch.where(neg, -alfa[:, None] * A.vals,
                    -beta[:, None] * A.vals) / safe_diag[:, None]
    keep = is_strong_c & (cf != C_PT)[:, None] & (w != 0)
    p_cols = torch.where(keep, cmap[cols_c], torch.full_like(A.cols, PAD_COL))
    own = torch.where(cf == C_PT, cmap, torch.full_like(cmap, PAD_COL))
    P = EllMatrix(
        vals=torch.cat([_where0(keep, w), (cf == C_PT).to(A.dtype)[:, None]],
                       1),
        cols=torch.cat([p_cols, own[:, None]], 1).to(torch.int32),
        n_cols=int(n_coarse))
    return _compact(P)


# candidate elements per block of classical-interpolation rows: the
# common-C membership test is a (rows, k, k, k) slab
_CLASSICAL_BLOCK_ELEMENTS = 64e6


def _classical_block(A: EllMatrix, S, cf, a_hat, diag, lo: int, blk: int,
                     out_k: int):
    """Classical modified interpolation for rows [lo, lo+blk):

        w_ij = -( a_ij + sum_{k in F_i^s} a_ik â_kj / denom_k ) / d_i
        denom_k = sum_{m in C_i^s, â_km != 0} â_km    (common-C)
        d_i = a_ii + sum_{weak n} a_in + sum_{k in F_i^s, denom_k=0} a_ik
    """
    rows = torch.arange(lo, lo + blk, dtype=torch.int32, device=A.device)
    cols_b = A.cols[lo:lo + blk]
    vals_b = A.vals[lo:lo + blk]
    S_b = S[lo:lo + blk]
    cols_c = cols_b.clamp(min=0).long()
    is_c_col = cf[cols_c] == C_PT
    strongC = S_b & is_c_col
    strongF = S_b & ~is_c_col
    nb_cols = A.cols.clamp(min=0)[cols_c]  # (blk, k, k)
    nb_ahat = a_hat[cols_c]
    # is nb_cols[b, a, s] one of row b's strong C columns?
    in_Ci = ((nb_cols[:, :, None, :] == cols_c[:, None, :, None])
             & strongC[:, None, :, None]).any(dim=2)
    denom = fold_sum(_where0(in_Ci, nb_ahat), dim=2)
    usable_F = strongF & (denom != 0)
    denom_safe = torch.where(denom != 0, denom, torch.ones_like(denom))
    weak = (cols_b >= 0) & (cols_b != rows[:, None]) & ~S_b
    d_eff = (diag[lo:lo + blk] + fold_sum(_where0(weak, vals_b))
             + fold_sum(_where0(strongF & (denom == 0), vals_b)))
    through = usable_F[:, :, None] & in_Ci
    w2 = _where0(through,
                 vals_b[:, :, None] * nb_ahat / denom_safe[:, :, None])
    cand2_cols = torch.where(through, nb_cols,
                             torch.full_like(nb_cols, PAD_COL))
    mc, mv, req = _merge_rows(
        torch.cat([torch.where(strongC, cols_b,
                               torch.full_like(cols_b, PAD_COL)),
                   cand2_cols.reshape(blk, -1)], 1),
        torch.cat([_where0(strongC, vals_b), w2.reshape(blk, -1)], 1),
        out_k)
    d_safe = torch.where(d_eff != 0, d_eff, torch.ones_like(d_eff))
    return mc, -mv / d_safe[:, None], int(req)


def classical_interp(A: EllMatrix, S: torch.Tensor, cf: torch.Tensor,
                     cmap: torch.Tensor, n_coarse: int,
                     out_k: int | None = None) -> EllMatrix:
    """hypre_BoomerAMGBuildInterp (par_interp.c:15): distance-1 classical
    interpolation with common-C distribution of the strong-F mass. Rows go
    in blocks that bound the membership slab; rows are independent, so
    the block size does not change the result."""
    n, k = A.cols.shape
    diag = A.diagonal()
    sgn = torch.where(diag >= 0, 1.0, -1.0).to(A.dtype)
    a_hat = _where0(A.vals * sgn[:, None] < 0, A.vals)
    if out_k is None:
        out_k = min(max(2 * k, 8), 64)
    blk_rows = max(1, int(_CLASSICAL_BLOCK_ELEMENTS // max(k ** 3, 1)))

    def run(out_k: int):
        parts = [_classical_block(A, S, cf, a_hat, diag, lo,
                                  min(blk_rows, n - lo), out_k)
                 for lo in range(0, n, blk_rows)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]),
                max(p[2] for p in parts))

    mc, w, req = run(out_k)
    if req > out_k:
        mc, w, _ = run(req)
    mc, w = _with_c_rows(A, cf, mc, w)
    fine_to_coarse = torch.where(cf == C_PT, cmap, torch.full_like(cmap, -1))
    return _compact(ell_remap_cols(EllMatrix(vals=w, cols=mc, n_cols=n),
                                   fine_to_coarse, int(n_coarse)))


def jacobi_improve_interp(A: EllMatrix, P: EllMatrix, cf: torch.Tensor,
                          weight: float = 1.0, passes: int = 1,
                          max_elmts: int = 0,
                          trunc_factor: float = 0.0) -> EllMatrix:
    """Weighted-Jacobi passes on P's F rows (par_jacobi_interp.c):
    P <- P - w D_F^{-1} (A P)|_F, each followed by truncation."""
    diag = A.diagonal()
    nz = diag != 0
    dinv = torch.where(nz, weight / torch.where(nz, diag,
                                                torch.ones_like(diag)),
                       torch.zeros_like(diag))
    is_f = (cf != C_PT).to(A.dtype)
    for _ in range(passes):
        AP = ell_spgemm(A, P).scale_rows(dinv * is_f)
        P = ell_add(1.0, P, -1.0, AP)
        P = truncate_interp(P, max_elmts=max_elmts, trunc_factor=trunc_factor)
    return P


def multipass_interp(A: EllMatrix, S: torch.Tensor, cf: torch.Tensor,
                     cmap: torch.Tensor, n_coarse: int,
                     p_max_elmts: int = 0) -> EllMatrix:
    """Multipass interpolation (hypre_BoomerAMGBuildMultipass,
    par_multi_interp.c), on the host as in the reference. C points are
    pass 0; an F point with a strong dependency of pass p-1 or less is
    pass p, and its row combines theirs,

        w_i = -(1/a_ii) sum_{k in S_i, pass(k) < p} a_ik P_k,

    rescaled to the row sum -(sum_{k != i} a_ik)/a_ii and truncated to
    ``p_max_elmts`` largest magnitudes (renormalized). Computed in float64
    and returned in A's dtype on A's device."""
    Sh = S.cpu().numpy()
    colsE = A.cols.cpu().numpy()
    valsE = A.vals.cpu().numpy()
    cfh = cf.cpu().numpy()
    cmaph = cmap.cpu().numpy()
    n, k = colsE.shape

    diag = np.zeros(n)
    offsum = np.zeros(n)
    strong = [[] for _ in range(n)]  # (col, a_ij) strong entries
    for i in range(n):
        for a in range(k):
            j = colsE[i, a]
            if j < 0:
                continue
            v = valsE[i, a]
            if j == i:
                diag[i] += v
            else:
                offsum[i] += v
                if Sh[i, a]:
                    strong[i].append((int(j), float(v)))

    dependents = [[] for _ in range(n)]
    for i in range(n):
        for j, _ in strong[i]:
            dependents[j].append(i)
    passes = np.full(n, -1, np.int64)
    passes[cfh == C_PT] = 0
    frontier = np.nonzero(cfh == C_PT)[0].tolist()
    p = 0
    while frontier:
        nxt = []
        for j in frontier:
            for i in dependents[j]:
                if passes[i] < 0:
                    passes[i] = p + 1
                    nxt.append(i)
        frontier = nxt
        p += 1

    rows: list = [dict() for _ in range(n)]
    for i in np.nonzero(cfh == C_PT)[0]:
        rows[i][int(cmaph[i])] = 1.0
    for p in range(1, int(passes.max(initial=0)) + 1):
        for i in np.nonzero(passes == p)[0]:
            d = diag[i] if diag[i] != 0 else 1.0
            acc: dict = {}
            for j, aij in strong[i]:
                if 0 <= passes[j] < p and rows[j]:
                    for c, w in rows[j].items():
                        acc[c] = acc.get(c, 0.0) - aij * w / d
            ssum = sum(acc.values())
            target = -offsum[i] / d
            if ssum != 0.0 and target != 0.0:
                scale = target / ssum
                acc = {c: w * scale for c, w in acc.items()}
            if p_max_elmts and len(acc) > p_max_elmts:
                keep = sorted(acc, key=lambda c: -abs(acc[c]))[:p_max_elmts]
                kept = {c: acc[c] for c in keep}
                ks = sum(kept.values())
                if ks != 0.0 and ssum != 0.0:
                    kept = {c: w * (target / ks) for c, w in kept.items()}
                acc = kept
            rows[i] = acc

    width = max(max((len(r) for r in rows), default=1), 1)
    pc = np.full((n, width), PAD_COL, np.int32)
    pv = np.zeros((n, width))
    for i, r in enumerate(rows):
        for a, (c, w) in enumerate(sorted(r.items())):
            pc[i, a] = c
            pv[i, a] = w
    return EllMatrix(vals=torch.from_numpy(pv).to(A.device, A.dtype),
                     cols=torch.from_numpy(pc).to(A.device),
                     n_cols=int(n_coarse))
