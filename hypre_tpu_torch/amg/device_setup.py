"""On-device BoomerAMG setup: slab-formulated strength, PMIS, interpolation
and Galerkin products.

Counterpart of ``hypre_tpu/amg/device_setup.py`` (hypre's
``par_amg_setup.c`` device path: ``par_coarsen_device.c``,
``par_lr_interp_device.c``, ``seq_mv/csr_spgemm_device*.c``). Strength,
PMIS with the distance-2 second pass, ext+i and multipass interpolation,
truncation and the Galerkin triple product all run as tensor operations on
the hierarchy's device:

- neighbour data reaches a row through one row gather of a packed slab,
  or through slices when the index map is shift-structured (the fine
  stencil level; ``slabops.StencilPack``);
- merges are axis-1 slab sorts with segmented doubling scans
  (``slabops.merge_slab``), no scatter;
- strength patterns are capped to the ``s_cap`` strongest entries per row,
  which bounds every later slab width.

The setup is driven by a host loop that reads back one count per level and
one flag per PMIS round. Slab widths are guessed from the reference's
tables and grown when a merge reports a larger requirement; the stored
widths (P, Pt, coarse A) are the reference's, because
``optimize_operator`` picks the solve format from them. A completed setup
records its ladder of sizes and widths, and a later setup of the same
shape and knobs replays it with a single read-back at its end (the
reference's fast setup; see "The recorded ladder and its replay").
"""

from __future__ import annotations

import logging
import os
from typing import List

import torch

from hypre_tpu_torch.core.config import (
    PAD_COL, fold_sum, hash_rand01, resolve_device,
)
from hypre_tpu_torch.core.memory import check_hbm_request
from hypre_tpu_torch.core.timing import annotate
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.slabops import (
    StencilPack, _where_col, _where_val, cap_slab, compact_mask_slab,
    make_stencil_pack, merge_slab, shift_gather_dyn, shift_rows,
    shift_scatter_add_dyn, shift_scatter_max_dyn,
)

C_PT = 1
F_PT = -1
_BIG = 2**30
_LOG = logging.getLogger(__name__)

# element budget for shift-structured candidate slabs: beyond this the slot
# loop is blocked into progressive merges (several copies of the slab live
# at once during the merge sorts)
_SLOT_BLOCK_BUDGET = 96e6
# row-chunked products keep a candidate slab under this many elements
_CHUNK_BUDGET = 48e6


def _rep(x: torch.Tensor, k: int) -> torch.Tensor:
    return x.repeat_interleave(k, dim=1)


# ---------------------------------------------------------------------------
# gather strategies
# ---------------------------------------------------------------------------


def _as_pack(shifts, n, with_d2: bool = False):
    """Normalize a host shift tuple to a StencilPack; None and an existing
    pack pass unchanged."""
    if shifts is None or isinstance(shifts, StencilPack):
        if with_d2 and shifts is not None and shifts.d2 is None:
            raise ValueError("second_pass needs a d2-enabled StencilPack")
        return shifts
    return make_stencil_pack(shifts, n, with_d2=with_d2)


def _gather_rows(X, cols_c, shifts):
    """X[cols[i,s]] -> (n, k, ...): slices when shift-structured (shifts
    is a StencilPack) else a gather. Invalid slots return garbage (or the
    pack's fill) the caller must mask."""
    if shifts is not None:
        return shift_gather_dyn(X, shifts)
    return X[cols_c.long()]


def _scatter_add_counts(cols, mask, n_cols: int, shifts):
    """out[j] = #{(i,s): mask & cols[i,s]==j} (strength-transpose counts)."""
    if shifts is not None:
        return shift_scatter_add_dyn(mask.to(torch.int32), shifts)
    return torch.zeros(n_cols, dtype=torch.int32, device=cols.device) \
        .scatter_add_(0, _slot_targets(cols, mask, n_cols).reshape(-1),
                      mask.to(torch.int32).reshape(-1))


def _slot_targets(cols, mask, n_cols: int) -> torch.Tensor:
    """Scatter targets of a slab's slots, mask-free: a masked slot's
    column, any other slot its own row (clamped into the column space),
    where it adds a neutral value. No read-back, and no one address that
    every unmasked slot's atomic contends for."""
    rows = torch.arange(cols.shape[0], device=cols.device)[:, None] \
        .clamp(max=max(n_cols - 1, 0))
    return torch.where(mask, cols.long(), rows)


# ---------------------------------------------------------------------------
# strength + PMIS (par_strength.c:531, par_coarsen.c:2813)
# ---------------------------------------------------------------------------


def strength_and_cap(A: EllMatrix, theta: float, s_cap: int, shifts=None,
                     with_back: bool = False, tie_cols=None,
                     mxrs: float = 1.0):
    """Strength mask of A (hypre's classical negative-coupling definition,
    as amg/strength.py) and a compact strong-pattern slab (scols, svals)
    of width <= s_cap holding the strongest connections.

    When A is shift-structured the slab keeps A's ORIGINAL slot order (a
    magnitude reorder would destroy the shift structure the slice gathers
    depend on); stencil widths are small, so no capping is needed there.

    with_back: also return sback aligned with the slab, where
    sback[i,a] = A[scols[i,a], i] (the transpose value ext+i's
    back-coupling needs on value-nonsymmetric operators).
    """
    shifts = _as_pack(shifts, A.n_rows)
    rows = torch.arange(A.n_rows, dtype=torch.int32,
                        device=A.device)[:, None]
    offd = (A.cols >= 0) & (A.cols != rows)
    diag = A.diagonal()
    sgn = torch.where(diag >= 0, 1.0, -1.0).to(A.dtype)
    coupling = -A.vals * sgn[:, None]  # positive = "negative" coupling
    max_off = torch.where(offd, coupling, -float("inf")).amax(dim=1)
    thresh = theta * torch.where(torch.isfinite(max_off), max_off, 0.0)
    S = offd & (coupling > thresh.clamp(min=0.0)[:, None]) \
        & (thresh > 0)[:, None]
    if mxrs < 1.0:
        # hypre max_row_sum cutoff (par_strength.c): strongly diagonally
        # dominant rows keep no dependencies
        row_sum = fold_sum(_where_val(A.cols >= 0, A.vals))
        safe_d = torch.where(diag != 0, diag, 1.0)
        S = S & ~((row_sum / safe_d).abs() > mxrs)[:, None]
    scols = _where_col(S, A.cols)
    svals = _where_val(S, A.vals)
    sback = None
    if with_back:
        B_full = paired_transpose_vals(A.cols, A.vals, A.n_rows, shifts)
        sback = _where_val(S, B_full)
    if shifts is None and s_cap < A.k:
        if with_back:
            scols, svals, sback = cap_slab(
                scols, svals, s_cap, extra=(sback,), tie_cols=tie_cols)
        else:
            scols, svals = cap_slab(scols, svals, s_cap, tie_cols=tie_cols)
    return S, scols, svals, sback


def pmis_device(scols: torch.Tensor, n: int, shifts=None,
                global_row_offset: int = 0,
                s_valid: torch.Tensor | None = None) -> torch.Tensor:
    """PMIS on a compact strong-pattern slab (cols only; PAD_COL invalid).

    Same update rules and hash tie-breaking as amg/coarsen.pmis, with the
    neighbour reductions specialized to slices for shift-structured
    patterns (``shifts`` must describe scols' own slot structure). The
    measure is float32 whatever the matrix type. One flag is read back per
    round.
    """
    return _pmis(scols, n, shifts, global_row_offset, s_valid)[0]


def _pmis(scols, n, shifts=None, global_row_offset=0, s_valid=None,
          rounds=None):
    """``pmis_device`` returning (cf, rounds run, decided). With
    ``rounds`` (a count an earlier run recorded) exactly that many rounds
    run, nothing is read back, and ``decided`` is a device bool (every
    point C or F); else ``decided`` is None. A round after every point is
    decided changes nothing, so the two agree whenever ``rounds``
    suffices."""
    shifts = _as_pack(shifts, n)
    dev = scols.device
    S = scols >= 0 if s_valid is None else s_valid
    cols_c = scols.clamp(min=0)
    rows_global = torch.arange(n, dtype=torch.int64, device=dev) \
        + global_row_offset
    st_counts = _scatter_add_counts(scols, S, n, shifts)
    measure = st_counts.to(torch.float32) + hash_rand01(rows_global)
    has_strong_row = S.any(dim=1)
    isolated = ~has_strong_row & (st_counts == 0)
    if shifts is None:
        cols_l = cols_c.long()
        # the column-side max scatters every slot: a strong one its
        # measure to its column, any other a 0 (the measures are >= 0) to
        # its own row
        targets = _slot_targets(scols, S, n).reshape(-1)

    def one_round(cf):
        prev = cf
        undecided = cf == 0
        m = _where_val(undecided, measure)
        m_slots = _where_val(S, m[:, None].expand(S.shape))
        if shifts is not None:
            g = shift_gather_dyn(m, shifts)
            col_nbr_max = shift_scatter_max_dyn(m_slots, shifts, fill=0.0)
        else:
            g = m[cols_l]
            col_nbr_max = torch.zeros(n, dtype=m.dtype, device=dev) \
                .scatter_reduce(0, targets, m_slots.reshape(-1), "amax",
                                include_self=True)
        row_nbr_max = _where_val(S, g).amax(dim=1) if S.shape[1] else \
            torch.zeros_like(m)
        nbr_max = torch.maximum(row_nbr_max, col_nbr_max)
        new_c = undecided & (m > nbr_max) & (m > 0)
        cf = torch.where(new_c, C_PT, cf).to(torch.int32)
        gc = shift_gather_dyn(cf, shifts) if shifts is not None \
            else cf[cols_l]
        dep_on_c = (S & (gc == C_PT)).any(dim=1)
        cf = torch.where((cf == 0) & dep_on_c, F_PT, cf).to(torch.int32)
        cf = torch.where((cf == 0) & isolated, F_PT, cf).to(torch.int32)
        # stall guard: a round that changed nothing turns every undecided
        # point into C
        stalled = (cf == prev).all()
        return torch.where(stalled & (cf == 0), C_PT, cf).to(torch.int32)

    cf = torch.where(isolated, F_PT, 0).to(torch.int32)
    if rounds is None:
        done = 0
        while bool((cf == 0).any()):
            cf = one_round(cf)
            done += 1
        return cf, done, None
    for _ in range(rounds):
        cf = one_round(cf)
    return cf, rounds, (cf != 0).all()


# ---------------------------------------------------------------------------
# transpose-aligned values (for ext+i's back-coupling on nonsymmetric A)
# ---------------------------------------------------------------------------


def paired_transpose_vals(cols: torch.Tensor, vals: torch.Tensor, n: int,
                          shifts=None) -> torch.Tensor:
    """B[i,a] = A[cols[i,a], i] (0 when that entry is absent).

    Shift-structured: pair slot a with the slot carrying -shift (slices).
    General: tag-merge sort. Entries (j, c, 0, val) and queries
    (cols[i,a], i, 1, .) are sorted together by (row, col, tag), the three
    integer keys packed into one int64; a query's answer sits immediately
    before it. No per-query gather.
    """
    nK = cols.numel()
    dev = cols.device
    shifts = _as_pack(shifts, n)
    if shifts is not None:
        out = []
        for a, b in enumerate(shifts.pair_idx):
            if b >= 0:
                g = shift_rows(vals[:, b], shifts.offs[a], 0)
            else:
                g = torch.zeros(cols.shape[0], dtype=vals.dtype, device=dev)
            out.append(g)
        return _where_val(cols >= 0, torch.stack(out, dim=1))

    rows = torch.arange(cols.shape[0], dtype=torch.int64,
                        device=dev)[:, None].expand(cols.shape)
    valid = cols >= 0
    cols_l = cols.to(torch.int64)
    big = torch.full_like(cols_l, _BIG)
    e_r = torch.where(valid, rows, big).reshape(-1)
    e_c = torch.where(valid, cols_l, big).reshape(-1)
    q_r, q_c = e_c, e_r  # queries: the transpose positions
    r = torch.cat([e_r, q_r])
    c = torch.cat([e_c, q_c])
    t = torch.cat([torch.zeros(nK, dtype=torch.int64, device=dev),
                   torch.ones(nK, dtype=torch.int64, device=dev)])
    v = torch.cat([_where_val(valid, vals).reshape(-1),
                   torch.zeros(nK, dtype=vals.dtype, device=dev)])
    ids = torch.cat([torch.full((nK,), _BIG, dtype=torch.int64, device=dev),
                     torch.arange(nK, dtype=torch.int64, device=dev)])
    key, order = torch.sort((r << 32) | (c << 1) | t, stable=True)
    vs, ids_s = v[order], ids[order]
    # an entry and its query share every key bit but the tag
    prev_match = ((key[1:] >> 1) == (key[:-1] >> 1)) \
        & ((key[1:] & 1) == 1) & ((key[:-1] & 1) == 0)
    ans = torch.zeros_like(vs)
    ans[1:] = _where_val(prev_match, vs[:-1])
    # route answers back to query slots: sort by original query index
    _, back = torch.sort(ids_s, stable=True)
    B = ans[back][:nK].reshape(cols.shape)
    return _where_val(valid, B)


# ---------------------------------------------------------------------------
# ext+i interpolation (par_lr_interp.c / par_mod_lr_interp.c)
# ---------------------------------------------------------------------------


def extpi_pack_sources(scols, svals, sgn, is_c_cols, cmap_cols=None):
    """Per-row packed ext+i gather payloads: [thetaC | strongC a_hat] and
    the strongC columns (mapped through cmap_cols when given). ``is_c_cols``
    / ``cmap_cols`` are indexed by scols' COLUMN space."""
    s_valid = scols >= 0
    svals = _where_val(s_valid, svals)
    s_hat = _where_val(svals * sgn[:, None] < 0, svals)
    s_is_c = s_valid & is_c_cols[scols.clamp(min=0).long()]
    own_strongC = s_valid & s_is_c
    thetaC = fold_sum(_where_val(own_strongC, s_hat))
    pc = _where_col(own_strongC, scols)
    if cmap_cols is not None:
        pc = _where_col(pc >= 0, cmap_cols[pc.clamp(min=0).long()])
    pv = _where_val(own_strongC, s_hat)
    packed_f = torch.cat([thetaC[:, None], pv], dim=1)
    return packed_f, pc


def ext_plus_i_device(
    A: EllMatrix,
    scols: torch.Tensor,
    svals: torch.Tensor,
    cf: torch.Tensor,
    out_k: int,
    p_max_elmts: int = 0,
    trunc_factor: float = 0.0,
    shifts=None,
    back_hat: torch.Tensor | None = None,
    chunks: int = 1,
    col_sources=None,
    out_cols=None,
):
    """ext+i on the capped strong slab. Returns (cols_fine, vals, req).

    Modified MM ext+i (the formula of amg/interp.ext_plus_i_interp, which
    documents it against par_lr_interp.c / par_mod_lr_interp.c): per
    strong-F neighbour j of row i, ONE packed row gather fetches
    [thetaC_j | j's strongC cols | j's strongC a_hat]; the back-coupling
    a_hat_{ji} comes from the value-symmetry fast path or from
    ``back_hat`` (paired_transpose_vals). ``chunks`` > 1 processes the
    rows in that many slices to bound peak memory (the candidate slab is
    (n, ks + ks^2) plus sort copies).

    Distribution hooks: ``col_sources = (col_is_c, col_packed_f,
    col_packed_i, col_sgn)`` supplies the gather sources over A's COLUMN
    space when it differs from the row space; ``out_cols = (cand1_cols,
    own_cols)`` overrides the emitted column numbering.
    """
    n, k = A.cols.shape
    ks = scols.shape[1]
    dev = A.device
    shifts = _as_pack(shifts, n)
    W = 1 + ks
    dtype = A.dtype
    diag = A.diagonal()
    sgn = torch.where(diag >= 0, 1.0, -1.0).to(dtype)

    rows_all = torch.arange(n, dtype=torch.int32, device=dev)
    offd = (A.cols >= 0) & (A.cols != rows_all[:, None])
    off_sum = fold_sum(_where_val(offd, A.vals))
    s_valid = scols >= 0
    svals = _where_val(s_valid, svals)
    strong_sum = fold_sum(svals)
    weak_sum = off_sum - strong_sum

    scols_c = scols.clamp(min=0)
    if col_sources is None:
        is_c_src = cf == C_PT
        packed_f_src, packed_i_src = extpi_pack_sources(
            scols, svals, sgn, is_c_src)
        sgn_src = sgn
    else:
        is_c_src, packed_f_src, packed_i_src, sgn_src = col_sources
    s_is_c = s_valid & _gather_rows(is_c_src, scols_c, shifts)

    if back_hat is None:
        # symmetric-value fast path: a_hat_{ji} = sign_j-filtered a_ij
        g_sgn = _gather_rows(sgn_src, scols_c, shifts)
        back_hat = _where_val(svals * g_sgn < 0, svals)
    back_hat = _where_val(s_valid, back_hat)

    if out_cols is None:
        cand1_cols_slab = scols
        own_cols = rows_all
    else:
        cand1_cols_slab, own_cols = out_cols
    is_c_row = cf == C_PT

    if shifts is not None and n * ks * (2 * ks + 1) > _SLOT_BLOCK_BUDGET:
        # 27-pt-class stencil level: the one-shot packed gathers are
        # (n, ks*(1+ks)) + (n, ks*ks) slabs. Process the strong slots in
        # blocks and merge progressively (see spgemm_slab's blocked path
        # for the req/growth contract).
        thetaC = _where_val(
            s_valid, shift_gather_dyn(packed_f_src[:, 0], shifts))
        theta = thetaC + back_hat
        strongF = s_valid & ~s_is_c
        strongC = s_valid & s_is_c
        usable_F = strongF & (theta != 0)
        theta_safe = torch.where(theta != 0, theta, 1.0)
        d_eff = (
            diag + weak_sum
            + fold_sum(_where_val(usable_F, svals * back_hat / theta_safe))
            + fold_sum(_where_val(strongF & (theta == 0), svals))
        )
        d_safe = torch.where(d_eff != 0, d_eff, 1.0)
        scale = (-1.0 / d_safe)[:, None]
        is_f = ~is_c_row[:, None]
        own = _where_col(is_c_row, own_cols)[:, None]
        ones = is_c_row.to(dtype)[:, None]
        cand1_cols = _where_col(strongC & is_f, cand1_cols_slab)
        cand1_vals = _where_val(strongC & is_f, svals * scale)
        acc_c, acc_v, req = merge_slab(
            torch.cat([cand1_cols, own], dim=1),
            torch.cat([cand1_vals, ones], dim=1), out_k)
        coef = _where_val(usable_F, svals / theta_safe)
        blk = max(1, int(_SLOT_BLOCK_BUDGET // (n * 2 * ks)))
        for s0 in range(0, ks, blk):
            s1 = min(s0 + blk, ks)
            nb = s1 - s0
            sh_blk = shifts.slice(s0, s1)
            pf_blk = shift_gather_dyn(packed_f_src, sh_blk, flat=True)
            nb_cols = shift_gather_dyn(packed_i_src, sh_blk, fill=PAD_COL,
                                       flat=True)
            nb_hat = pf_blk.reshape(n, nb, W)[:, :, 1:].reshape(n, nb * ks)
            through = _rep(usable_F[:, s0:s1], ks) & (nb_cols >= 0)
            c2 = _where_col(through & is_f, nb_cols)
            v2 = _where_val(c2 >= 0,
                            _rep(coef[:, s0:s1], ks) * nb_hat * scale)
            acc_c, acc_v, r = merge_slab(
                torch.cat([acc_c, c2], dim=1),
                torch.cat([acc_v, v2], dim=1), out_k)
            req = torch.maximum(req, r)
        acc_c, acc_v, _ = merge_slab(
            acc_c, acc_v, out_k, max_elmts=p_max_elmts,
            trunc_factor=trunc_factor, rescale_rowsum=True)
        return acc_c, acc_v, req

    def chunk_fn(r0, r1):
        sl = slice(r0, r1)
        m = r1 - r0
        if shifts is not None:
            packed_f = shift_gather_dyn(packed_f_src, shifts, flat=True)
            packed_i = shift_gather_dyn(packed_i_src, shifts, fill=PAD_COL,
                                        flat=True)
        else:
            idx = scols_c[sl].long()
            packed_f = packed_f_src[idx].reshape(m, ks * W)
            packed_i = packed_i_src[idx].reshape(m, ks * ks)
        svals_c, s_valid_c, s_is_c_c = svals[sl], s_valid[sl], s_is_c[sl]
        back_c, cf_is_c = back_hat[sl], is_c_row[sl]
        strongF = s_valid_c & ~s_is_c_c
        strongC_c = s_valid_c & s_is_c_c
        pf3 = packed_f.reshape(m, ks, W)
        thetaC = pf3[:, :, 0]
        nb_hat = pf3[:, :, 1:].reshape(m, ks * ks)
        nb_cols = packed_i

        theta = thetaC + back_c
        usable_F = strongF & (theta != 0)
        theta_safe = torch.where(theta != 0, theta, 1.0)
        d_eff = (
            diag[sl] + weak_sum[sl]
            + fold_sum(_where_val(usable_F, svals_c * back_c / theta_safe))
            + fold_sum(_where_val(strongF & (theta == 0), svals_c))
        )
        through = _rep(usable_F, ks) & (nb_cols >= 0)
        w2 = _where_val(through, _rep(svals_c / theta_safe, ks) * nb_hat)
        cand2_cols = _where_col(through, nb_cols)
        cand1_cols = _where_col(strongC_c, cand1_cols_slab[sl])
        cand1_vals = _where_val(strongC_c, svals_c)
        d_safe = torch.where(d_eff != 0, d_eff, 1.0)
        scale = (-1.0 / d_safe)[:, None]
        is_f = ~cf_is_c[:, None]
        cand_cols = torch.cat([cand1_cols, cand2_cols], dim=1)
        cand_vals = torch.cat([cand1_vals, w2], dim=1) * scale
        cand_cols = _where_col(is_f, cand_cols)
        cand_vals = _where_val(is_f, cand_vals)
        # C-row identity appended as one more candidate column (its own
        # single entry survives any truncation; rescale is a no-op there)
        own = _where_col(cf_is_c, own_cols[sl])[:, None]
        ones = cf_is_c.to(dtype)[:, None]
        cand_cols = torch.cat([cand_cols, own], dim=1)
        cand_vals = torch.cat([cand_vals, ones], dim=1)
        return merge_slab(
            cand_cols, cand_vals, out_k, max_elmts=p_max_elmts,
            trunc_factor=trunc_factor, rescale_rowsum=True)

    if chunks <= 1 or shifts is not None:
        return chunk_fn(0, n)
    return _row_chunks(chunk_fn, n, chunks)


def _row_chunks(chunk_fn, n: int, chunks: int):
    """Run ``chunk_fn(r0, r1) -> (cols, vals, req)`` over ``chunks`` row
    slices and join the results."""
    mchunk = -(-n // chunks)
    parts = [chunk_fn(r0, min(r0 + mchunk, n)) for r0 in range(0, n, mchunk)]
    req = parts[0][2]
    for p in parts[1:]:
        req = torch.maximum(req, p[2])
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]), req)


# ---------------------------------------------------------------------------
# SpGEMM via row gathers + slab merge (csr_spgemm_device.c analogue)
# ---------------------------------------------------------------------------


def spgemm_slab(
    a_cols: torch.Tensor,
    a_vals: torch.Tensor,
    b_cols: torch.Tensor,
    b_vals: torch.Tensor,
    out_k: int,
    shifts=None,
    max_elmts: int = 0,
    trunc_factor: float = 0.0,
    rescale_rowsum: bool = False,
    chunks: int = 1,
):
    """C = A @ B on ELL slabs; returns (c_cols, c_vals, required_k).

    The candidates of a row are its A slots' B rows side by side
    (slot-a-major (n, kA*kB) slabs), merged by ``merge_slab``; ``chunks``
    > 1 processes the rows in that many slices to bound peak memory.
    """
    n, kA = a_cols.shape
    kB = b_cols.shape[1]
    shifts = _as_pack(shifts, n)

    def candidates(ac, av, gb_cols, gb_vals):
        a_valid = _rep(ac >= 0, kB)
        cand_cols = _where_col(a_valid & (gb_cols >= 0), gb_cols)
        cand_vals = _where_val(cand_cols >= 0, _rep(av, kB) * gb_vals)
        return cand_cols, cand_vals

    if shifts is not None and n * kA * kB > _SLOT_BLOCK_BUDGET:
        # 27-pt-class stencils: process A-slots in blocks, progressively
        # merging each block's candidates into a width-out_k accumulator.
        # If out_k ever truncates, some intermediate merge reports
        # req > out_k and the caller grows it, so a returned req <= out_k
        # certifies the result exact, as on the one-shot path.
        blk = max(1, int(_SLOT_BLOCK_BUDGET // (n * kB)))
        acc_c = torch.full((n, out_k), PAD_COL, dtype=torch.int32,
                           device=a_cols.device)
        acc_v = torch.zeros((n, out_k), dtype=a_vals.dtype,
                            device=a_cols.device)
        req = torch.zeros((), dtype=torch.int32, device=a_cols.device)
        for s0 in range(0, kA, blk):
            s1 = min(s0 + blk, kA)
            sh_blk = shifts.slice(s0, s1)
            cand_cols, cand_vals = candidates(
                a_cols[:, s0:s1], a_vals[:, s0:s1],
                shift_gather_dyn(b_cols, sh_blk, fill=PAD_COL, flat=True),
                shift_gather_dyn(b_vals, sh_blk, flat=True))
            acc_c, acc_v, r = merge_slab(
                torch.cat([acc_c, cand_cols], dim=1),
                torch.cat([acc_v, cand_vals], dim=1), out_k)
            req = torch.maximum(req, r)
        if max_elmts > 0 or trunc_factor > 0.0 or rescale_rowsum:
            # truncation/rescale must see the FULL merged row: applied once
            # at the end (merging an already-unique slab is idempotent)
            acc_c, acc_v, _ = merge_slab(
                acc_c, acc_v, out_k, max_elmts=max_elmts,
                trunc_factor=trunc_factor, rescale_rowsum=rescale_rowsum)
        return acc_c, acc_v, req

    def chunk_fn(r0, r1):
        ac, av = a_cols[r0:r1], a_vals[r0:r1]
        if shifts is not None:
            gb_cols = shift_gather_dyn(b_cols, shifts, fill=PAD_COL,
                                       flat=True)
            gb_vals = shift_gather_dyn(b_vals, shifts, flat=True)
        else:
            aco = ac.clamp(min=0).long()
            gb_cols = b_cols[aco].reshape(-1, kA * kB)
            gb_vals = b_vals[aco].reshape(-1, kA * kB)
        cand_cols, cand_vals = candidates(ac, av, gb_cols, gb_vals)
        return merge_slab(
            cand_cols, cand_vals, out_k, max_elmts=max_elmts,
            trunc_factor=trunc_factor, rescale_rowsum=rescale_rowsum)

    if chunks <= 1 or shifts is not None:
        return chunk_fn(0, n)
    return _row_chunks(chunk_fn, n, chunks)


def transpose_slab(cols: torch.Tensor, vals: torch.Tensor, n_cols: int,
                   out_k: int):
    """T = A^T via one global sort + slot assignment + scatter.

    The entries are sorted by (column, row), both packed into one int64
    key; each then has a (destination row, slot) pair of its own, so the
    scatter writes every destination once and two runs give the same
    bits. Returns (t_cols, t_vals, required_k).
    """
    n, k = cols.shape
    dev = cols.device
    flat_cols = cols.reshape(-1).to(torch.int64)
    flat_vals = vals.reshape(-1)
    flat_rows = torch.arange(n, dtype=torch.int64, device=dev)[:, None] \
        .expand(n, k).reshape(-1)
    valid = flat_cols >= 0
    big = torch.full_like(flat_cols, _BIG)
    key = (torch.where(valid, flat_cols, big) << 31) \
        | torch.where(valid, flat_rows, big)
    key, order = torch.sort(key, stable=True)
    sc, sr, sv = key >> 31, key & (2**31 - 1), flat_vals[order]
    idx = torch.arange(n * k, dtype=torch.int64, device=dev)
    is_new = torch.ones(n * k, dtype=torch.bool, device=dev)
    is_new[1:] = sc[1:] != sc[:-1]
    seg_start = torch.cummax(torch.where(is_new, idx, 0), dim=0)[0]
    slot = idx - seg_start
    valid_s = sc < _BIG
    required_k = (torch.where(valid_s, slot, -1).max() + 1).to(torch.int32) \
        if n * k else torch.zeros((), dtype=torch.int32, device=dev)
    in_range = valid_s & (slot < out_k)
    # flat destinations, the entries past out_k and the padding into one
    # spare slot that is cut off (no mask, so no read-back)
    size = n_cols * out_k
    dst = torch.where(in_range, sc * out_k + slot, size)
    t_vals = torch.zeros(size + 1, dtype=vals.dtype, device=dev) \
        .scatter_(0, dst, sv)[:size].view(n_cols, out_k)
    t_cols = torch.full((size + 1,), PAD_COL, dtype=torch.int32, device=dev) \
        .scatter_(0, dst, sr.to(torch.int32))[:size].view(n_cols, out_k)
    return t_cols, t_vals, required_k


# ---------------------------------------------------------------------------
# direct interpolation (row-local; par_interp_device.c)
# ---------------------------------------------------------------------------


def direct_interp_slab(A: EllMatrix, S: torch.Tensor, cf: torch.Tensor):
    """Direct interpolation candidates in FINE numbering (cols, vals).
    Row-local apart from one gather of cf; the math of
    amg/interp.direct_interp."""
    n, k = A.cols.shape
    dev = A.device
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    offd = (A.cols >= 0) & (A.cols != rows[:, None])
    cols_c = A.cols.clamp(min=0).long()
    diag = A.diagonal()
    is_strong_c = S & (cf[cols_c] == C_PT)
    neg = A.vals < 0
    pos = A.vals > 0
    sum_n_neg = fold_sum(_where_val(offd & neg, A.vals))
    sum_n_pos = fold_sum(_where_val(offd & pos, A.vals))
    sum_p_neg = fold_sum(_where_val(is_strong_c & neg, A.vals))
    sum_p_pos = fold_sum(_where_val(is_strong_c & pos, A.vals))
    have_pos_c = sum_p_pos != 0
    diag_eff = torch.where(have_pos_c, diag, diag + sum_n_pos)
    alfa = sum_n_neg / torch.where(sum_p_neg != 0, sum_p_neg, 1.0)
    beta = _where_val(
        have_pos_c, sum_n_pos / torch.where(have_pos_c, sum_p_pos, 1.0))
    safe_diag = torch.where(diag_eff != 0, diag_eff, 1.0)
    w = torch.where(neg, -alfa[:, None] * A.vals, -beta[:, None] * A.vals)
    w = w / safe_diag[:, None]
    is_c = cf == C_PT
    keep = is_strong_c & ~is_c[:, None] & (w != 0)
    own = _where_col(is_c, rows)[:, None]
    ones = is_c.to(A.dtype)[:, None]
    return (torch.cat([_where_col(keep, A.cols), own], dim=1),
            torch.cat([_where_val(keep, w), ones], dim=1))


def remap_fine_to_coarse(cols: torch.Tensor, vals: torch.Tensor,
                         cmap: torch.Tensor, shifts=None):
    """Renumber fine-space C columns into coarse indices (drops non-C)."""
    shifts = _as_pack(shifts, cols.shape[0])
    cc = cols.clamp(min=0)
    mapped = _where_col(cols >= 0, _gather_rows(cmap, cc, shifts))
    return _where_col(mapped >= 0, mapped), _where_val(mapped >= 0, vals)


# ---------------------------------------------------------------------------
# Orchestrator: hypre_BoomerAMGSetup on the device (par_amg_setup.c:28)
# ---------------------------------------------------------------------------

_LADDER = (
    4, 6, 8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112, 128,
    160, 192, 224, 256, 320, 384, 448, 512, 640,
)


def _bucket(k: int) -> int:
    for b in _LADDER:
        if b >= k:
            return b
    return int(k)


def _row_bucket(n: int) -> int:
    """Row-count bucket: smallest {2^k, 3*2^(k-1)} >= n (<= 33% padding)."""
    if n <= 256:
        return 256
    b = 256
    while b < n:
        if 3 * b // 2 >= n:
            return 3 * b // 2
        b *= 2
    return b


def _pad_rows(vals, cols, nb: int):
    """Pad an ELL slab to ``nb`` rows with empty (PAD_COL) rows."""
    n, k = cols.shape
    return (torch.cat([vals, vals.new_zeros((nb - n, k))]),
            torch.cat([cols, cols.new_full((nb - n, k), PAD_COL)]))


def _coarse_inv(vals, cols, n_true: int, pinv: bool = False):
    """Dense (pseudo)inverse of the padded coarsest operator; padding rows
    get identity entries. Returns (inverse, max|A inv - I|)."""
    nc = cols.shape[0]
    dtype, dev = vals.dtype, vals.device
    rows = torch.arange(nc, device=dev)[:, None]
    # a row holds each column once: every destination is written once; the
    # padding slots go to one spare entry that is cut off
    dst = torch.where(cols >= 0, rows * nc + cols.long(), nc * nc)
    dense = torch.zeros(nc * nc + 1, dtype=dtype, device=dev) \
        .scatter_(0, dst.reshape(-1), vals.reshape(-1))[:nc * nc] \
        .view(nc, nc)
    pad_eye = (torch.arange(nc, device=dev) >= n_true).to(dtype)
    dense = dense + torch.diag(pad_eye)
    if pinv:
        inv = torch.linalg.pinv(dense, rtol=1e-6)
    else:
        inv, _ = torch.linalg.inv_ex(dense)
    resid = (dense @ inv - torch.eye(nc, dtype=dtype, device=dev)) \
        .abs().max() if nc else torch.zeros((), dtype=dtype, device=dev)
    return inv, resid


def _trim_width(req, width: int) -> int:
    """The bucket of a merged slab's true width ``req``, at most its
    ``width``: padded width is what every downstream slab cost scales
    with."""
    return min(_bucket(max(int(req), 1)), width)


def _trim(cols, vals, w: int):
    """The first ``w`` columns of a slab."""
    if w == cols.shape[1]:
        return cols, vals
    return cols[:, :w].contiguous(), vals[:, :w].contiguous()


def _coarse_map(cf: torch.Tensor):
    is_c = cf == C_PT
    idx = torch.cumsum(is_c.to(torch.int32), dim=0, dtype=torch.int32) - 1
    return _where_col(is_c, idx), is_c.sum(dtype=torch.int32)


def _level_vectors(vals, cols, need_cheby: bool):
    """Per-level smoother vectors. The Chebyshev bound is Gershgorin's on
    D^{-1}A (lmax <= max_i sum_j |a_ij| / |a_ii|): row-local, no power
    method, so it differs from the pure setup's estimate on purpose."""
    n = vals.shape[0]
    rows = torch.arange(n, dtype=cols.dtype, device=cols.device)[:, None]
    diag = fold_sum(_where_val(cols == rows, vals))
    l1 = fold_sum(vals.abs())
    nz = diag != 0
    dinv = _where_val(nz, 1.0 / torch.where(nz, diag, 1.0))
    l1inv = 1.0 / torch.where(l1 > 0, l1, 1.0)
    if need_cheby:
        lmax = (l1 * dinv.abs()).max()
    else:
        lmax = torch.zeros((), dtype=vals.dtype, device=vals.device)
    return dinv, l1inv, lmax


def drop_and_lump(cols, vals, tol: float):
    """Symmetric relative drop of a Galerkin operator: entries with
    |a_ij| < tol*sqrt(|a_ii a_jj|) go, their mass lumped onto the
    diagonal; the survivors are left-compacted."""
    n, k = cols.shape
    rows = torch.arange(n, dtype=cols.dtype, device=cols.device)[:, None]
    is_diag = cols == rows
    diag = fold_sum(_where_val(is_diag, vals))
    valid = cols >= 0
    dj = torch.where(valid, diag.abs()[cols.clamp(min=0).long()], 1.0)
    thresh = tol * torch.sqrt(diag.abs()[:, None] * dj)
    keep = is_diag | (valid & (vals.abs() >= thresh))
    lump = fold_sum(_where_val(valid & ~keep, vals))
    vals = torch.where(is_diag, vals + lump[:, None] * is_diag, vals)
    return compact_mask_slab(cols, vals, keep, k)


def _nchunks(n_rows: int, slab_w: int) -> int:
    """Row slices that keep a candidate slab under the chunk budget
    (several copies live during the merge sorts); powers of two."""
    c = 1
    while n_rows * slab_w / c > _CHUNK_BUDGET:
        c *= 2
    return c


def _grown(product, out_k: int):
    """Run ``product(out_k) -> (cols, vals, req)``; when the merge needed
    more than ``out_k`` columns, run it once more at the bucket of what it
    needed. Returns (cols, vals, req, out_k)."""
    c, v, req = product(out_k)
    req = int(req)
    if req > out_k:
        out_k = _bucket(req)
        c, v, _ = product(out_k)
    return c, v, req, out_k


def _grown_width(guess: int, req: int) -> int:
    """The width ``_grown`` ends at from ``guess`` when the merge needs
    ``req`` columns."""
    return guess if req <= guess else _bucket(req)


# ---------------------------------------------------------------------------
# The recorded ladder and its replay (the reference's fast setup)
# ---------------------------------------------------------------------------
#
# A slow-path setup records its LADDER in the shape registry (warmup.py),
# under the exact shape and a fingerprint of the knobs: per level the
# coarse size, the width each product ended at, the trimmed widths, the
# PMIS round counts, the multipass count, and the transfer's offsets and
# windows. A later setup of the same shape and knobs replays it: each
# product runs once at its recorded width, each PMIS its recorded rounds,
# and nothing is read back until the end, where one read fetches every
# quantity the slow path reads on its way. The replay is accepted only
# when each of them would have led the slow path to the recorded value,
# so an accepted replay builds the slow path's hierarchy bit for bit; on a
# mismatch (a same-shape operator with another split, a width it
# outgrows) it is discarded and the slow path runs.


def _knobs_sig(**kw) -> str:
    return "|".join(f"{k}={kw[k]}" for k in sorted(kw))


def _ladder_get(sig: str, ksig: str):
    from hypre_tpu_torch.warmup import read_registry

    return read_registry().get(f"ladder|{sig}|{ksig}")


def _ladder_put(sig: str, ksig: str, ladder: dict) -> None:
    from hypre_tpu_torch.warmup import update_registry

    update_registry({f"ladder|{sig}|{ksig}": ladder})


def _read_back(t: torch.Tensor) -> list:
    """The replay's one read of the device."""
    return t.cpu().tolist()


class _Deferred:
    """What a replay reads at its end: device tensors, each with the test
    its host values must pass."""

    def __init__(self):
        self.parts, self.tests = [], []

    def add(self, what: str, t: torch.Tensor, test) -> None:
        t = t.reshape(-1)
        self.parts.append(t.to(torch.float64))
        self.tests.append((what, t.numel(), test))

    def first_failure(self) -> str | None:
        """Read every part back at once; the first test that fails, or
        None."""
        vals = _read_back(torch.cat(self.parts)) if self.parts else []
        pos = 0
        for what, m, test in self.tests:
            got = vals[pos:pos + m] if m > 1 else vals[pos]
            pos += m
            if not test(got):
                return f"{what}: {got}"
        return None


def _offsets_match(offs: tuple):
    """Test of a ``probe_offsets_device`` result: exactly ``offs``."""
    def test(uniq):
        d = len(offs)
        return (list(uniq[:d]) == list(offs)
                and (d >= len(uniq) or uniq[d] >= _BIG))
    return test


def setup_hierarchy_device(
    A: EllMatrix,
    strength_threshold: float = 0.25,
    max_row_sum: float = 1.0,
    max_levels: int = 25,
    max_coarse_size: int = 64,
    p_max_elmts: int = 4,
    trunc_factor: float = 0.0,
    relax: str = "l1-jacobi",
    coarsen_rtol: float = 0.9,
    s_cap: int = 12,
    ap_cap: int = 0,
    symmetric: bool = True,
    agg_num_levels: int = 0,
    width_plan: dict | None = None,
    coarse_drop_tol: float = 0.0,
    transfer_dia: bool = False,
    row_bucket: bool = True,
    device=None,
):
    """Device-resident BoomerAMG setup: PMIS + ext+i (or, on the first
    ``agg_num_levels`` levels, the distance-2 second PMIS pass + multipass
    interpolation) + Galerkin RAP, on ``device`` (CUDA unless the caller
    names another; A is moved there). Returns the AMGHierarchy the other
    setup paths produce, so cycling and solve code are shared.

    s_cap: coarse-level strength patterns are capped to this many strongest
    connections per row (exact when rows have fewer strong entries, always
    true on the stencil level).
    ap_cap: if > 0, cap A@P rows to this many largest entries (dropped mass
    lumped onto the largest survivor) before the Pt(AP) product.
    symmetric: value-symmetry of A (lets ext+i's back-coupling avoid a
    transpose alignment pass; pattern symmetry is assumed either way).
    width_plan: a dict (shared across calls) that is filled with the slab
    widths each level used and read back as the first guess on a repeat
    setup with the same sparsity.
    coarse_drop_tol: symmetric relative drop tolerance applied to every
    Galerkin operator, dropped mass lumped onto the diagonal.
    transfer_dia: store the stencil level's interpolation as fine-space
    diagonals (seq/transfer_dia.py) when it has at most 96 of them.
    row_bucket: pad every level's row count to the {2^k, 3*2^(k-1)} ladder
    with empty rows. The returned hierarchy's fine level is then the
    PADDED operator; ``n_fine`` records the true row count,
    ``n_level_true`` every level's, and ``amg_cycle`` pads and unpads
    vectors itself. A setup with ``row_bucket`` records its ladder in the
    shape registry (``warmup.py``), and a later setup of the same shape
    and knobs replays it with one read of the device (see above); the
    hierarchy's ``replayed`` says which path built it, and a rejected
    replay is logged. ``HYPRE_TPU_NO_FAST_SETUP=1`` turns the replay off
    (the ladder is still recorded).

    Under a recording ``torch.profiler`` the setup shows as spans
    (``core/timing.py::annotate``): ``setup.replay`` around a replay
    attempt, ``setup.slow`` around the slow path (after a rejected attempt
    too), and inside either ``setup.L<l>.<stage>`` for each stage of level
    l (split, vectors, interp, ap, transpose, rap, drop, transfer_dia) and
    ``setup.coarse_inv``.
    """
    from hypre_tpu_torch.amg.hierarchy import AMGHierarchy, Level
    from hypre_tpu_torch.seq.transfer_dia import (
        _c2f_from_cf, build_transfer_dia, probe_offsets_device,
        probe_transfer_offsets, windows_of,
    )
    from hypre_tpu_torch.warmup import shape_key

    device = resolve_device(device)
    A = A.to(device)

    def staged(name, fn):
        with annotate(f"setup.{name}"):
            return fn()

    # the fine level keeps ~4 slab-sized copies alive through the split
    # and interpolation merges
    check_hbm_request(4 * A.n_rows * max(A.k, 8) * A.vals.element_size() * 2,
                      device)
    plan = width_plan if width_plan is not None else {}
    need_cheby = relax == "chebyshev"
    dtype = A.dtype
    shifts_host = A.shifts
    n_fine = A.n_rows
    if row_bucket:
        nb = _row_bucket(n_fine)
        if nb != n_fine:
            pv_, pc_ = _pad_rows(A.vals, A.cols, nb)
            # padded rows are empty, so the shifts annotation still holds
            # at every VALID slot and the fine level keeps its DIA kernels
            A = EllMatrix(vals=pv_, cols=pc_, n_cols=nb, shifts=shifts_host)
    shifts0 = None
    if shifts_host is not None:
        shifts0 = make_stencil_pack(shifts_host, A.n_rows, with_d2=True)

    def build(rec):
        """The level loop: the slow path (rec None), reading back what it
        needs as it goes, or the replay of the ladder ``rec``. Returns
        (hierarchy, ladder to record or None, why a replay failed)."""
        replay = rec is not None
        checks = _Deferred()
        levels: List[Level] = []
        recs, updates = [], {}
        n_true = n_fine
        true_sizes = [n_true]  # per-level true row counts incl. coarsest
        A_cur, shifts = A, shifts0
        complete = True  # whether the slow path's ladder can be replayed
        while len(levels) < max_levels - 1 and n_true > max_coarse_size:
            lev_id = len(levels)
            n, kA = A_cur.cols.shape
            rl = None
            if replay:
                if lev_id >= len(rec["levels"]):
                    return None, None, "the ladder has fewer levels"
                rl = rec["levels"][lev_id]
                if rl["kA"] != kA:
                    return None, None, f"L{lev_id} width {kA}"
            aggressive = lev_id < agg_num_levels
            s_cap_l = min(s_cap, kA)

            def split():
                _, scols, svals, sback = strength_and_cap(
                    A_cur, strength_threshold, s_cap_l, shifts,
                    with_back=not aggressive and not symmetric,
                    mxrs=max_row_sum)
                cf, r1, d1 = _pmis(scols, n, shifts=shifts,
                                   rounds=rl["pmis"] if replay else None)
                r2, d2 = 0, None
                if aggressive:
                    cf, r2, d2 = _second_pass(
                        scols, cf, n, _bucket(4 * s_cap_l), shifts,
                        rounds=rl["pmis2"] if replay else None)
                cmap, n_c = _coarse_map(cf)
                return scols, svals, sback, cf, cmap, n_c, (r1, d1, r2, d2)

            scols, svals, sback, cf, cmap, n_c, pm = staged(
                f"L{lev_id}.split", split)
            if replay:
                n_coarse = rl["nc"]
                checks.add(f"L{lev_id} coarse size", n_c,
                           lambda v, w=n_coarse: v == w)
                for decided in (pm[1], pm[3]):
                    if decided is not None:
                        checks.add(f"L{lev_id} PMIS decided", decided, bool)
            else:
                n_coarse = int(n_c)
            nc_b = _row_bucket(n_coarse) if row_bucket else n_coarse
            if replay:
                # coarse ids past the recorded coarse space would index out
                # of it; a split with such ids fails its check, so the
                # replay only has to stay in bounds until then
                cmap = _where_col(cmap < nc_b, cmap)
            dinv, l1inv, lmax = staged(
                f"L{lev_id}.vectors",
                lambda: _level_vectors(A_cur.vals, A_cur.cols, need_cheby))
            if n_coarse == 0 or n_coarse >= coarsen_rtol * n_true:
                complete = False  # a loop ended by a stall is not recorded
                break
            ks = scols.shape[1]
            out_k = _bucket(min(max(2 * ks, 8), 64))
            kP = plan.get((lev_id, "p"), out_k if not aggressive else None)
            # width guesses: plan hit > family default > generic formula.
            # The family defaults are the reference's table of stationary
            # widths (PMIS statistics are scale-free).
            if aggressive and shifts is not None:
                d_ap, d_t, d_ac = (
                    (12, 48, 40) if kA <= 9 else
                    (16, 224, 48) if kA <= 27 else
                    (_bucket(kA), _bucket(8 * kA), 64)
                )
            elif shifts is None and not aggressive:
                d_ap, d_t, d_ac = 32, 64, 96  # canonical coarse-level profile
            else:
                d_ap = _bucket(min(kA * (kP or 8), 3 * kA + 8))
                d_t = _bucket(max(int(4.0 * n_true / max(n_coarse, 1)), 8))
                d_ac = _bucket(max(min(3 * kA, 256), 32))
            guess_ap = plan.get((lev_id, "ap"), d_ap)
            guess_t = plan.get((lev_id, "t"), d_t)
            guess_ac = plan.get((lev_id, "ac"), d_ac)
            ch_i = _nchunks(n, ks * ks + ks + 1)

            def interp():
                mp = rl["mp"] if replay else plan.get((lev_id, "mp"), 3)
                if aggressive:
                    while True:
                        pc, pv, _, unass = multipass_interp_device(
                            A_cur, scols, svals, cf, cmap,
                            max(p_max_elmts, 1), shifts=shifts,
                            max_passes=mp)
                        if replay:
                            # passes past the last assigned one change
                            # nothing, so 6 passes stand for 3 as well
                            checks.add(f"L{lev_id} multipass", unass,
                                       lambda u, mp=mp: u == 0 or mp >= 6)
                        elif int(unass) > 0 and mp < 6:
                            # some F rows need more multipass rounds
                            mp = 6
                            continue
                        return pc, pv, mp
                back_hat = None
                if not symmetric:
                    # sign-filter the transpose values by the NEIGHBOUR
                    # row's diagonal sign
                    d = A_cur.diagonal()
                    sgn = torch.where(d >= 0, 1.0, -1.0).to(dtype)
                    g_sgn = _gather_rows(sgn, scols.clamp(min=0), shifts)
                    back_hat = _where_val(sback * g_sgn < 0, sback)
                pc, pv, _ = ext_plus_i_device(
                    A_cur, scols, svals, cf, out_k, p_max_elmts=p_max_elmts,
                    trunc_factor=float(trunc_factor), shifts=shifts,
                    back_hat=back_hat, chunks=ch_i)
                return (*remap_fine_to_coarse(pc, pv, cmap), mp)

            pc, pv, mp = staged(f"L{lev_id}.interp", interp)
            ch_ap = _nchunks(n, kA * (kP or out_k))

            def grow(product, guess, key):
                """``_grown``; in a replay, one run at the recorded width
                and a deferred check that ``_grown`` ends there."""
                if not replay:
                    return _grown(product, guess)
                w = rl[key]
                c, v, req = product(w)
                checks.add(f"L{lev_id} {key} width", req,
                           lambda r, g=guess, w=w: _grown_width(g, r) == w)
                return c, v, req, w

            def a_times_p():
                apc, apv, req, w = grow(
                    lambda w: spgemm_slab(A_cur.cols, A_cur.vals, pc, pv, w,
                                          shifts=shifts, chunks=ch_ap),
                    guess_ap, "ap")
                if ap_cap and ap_cap < w:
                    apc, apv = cap_slab(apc, apv, ap_cap, lump_largest=True)
                return apc, apv, req, w

            apc, apv, req_ap, out_ap = staged(f"L{lev_id}.ap", a_times_p)
            tc, tv, req_t, out_t = staged(
                f"L{lev_id}.transpose", lambda: grow(
                    lambda w: transpose_slab(pc, pv, nc_b, w), guess_t, "t"))
            ch_ac = _nchunks(nc_b, out_t * out_ap)
            acc, acv, req_ac, out_ac = staged(f"L{lev_id}.rap", lambda: grow(
                lambda w: spgemm_slab(tc, tv, apc, apv, w, chunks=ch_ac),
                guess_ac, "ac"))
            if coarse_drop_tol > 0:
                acc, acv = staged(f"L{lev_id}.drop", lambda: drop_and_lump(
                    acc, acv, float(coarse_drop_tol)))
            rowmax = (acc >= 0).sum(dim=1).max()
            # stored widths: the bucket of each slab's true width
            if replay:
                tw, aw = rl["tw"], rl["aw"]
                checks.add(f"L{lev_id} Pt width", req_t,
                           lambda r, t=out_t, w=tw: _trim_width(r, t) == w)
                checks.add(f"L{lev_id} coarse width", rowmax,
                           lambda r, a=out_ac, w=aw: _trim_width(r, a) == w)
            else:
                rowmax = int(rowmax)
                tw, aw = _trim_width(req_t, out_t), _trim_width(rowmax, out_ac)
            updates.update({(lev_id, "p"): pc.shape[1], (lev_id, "mp"): mp,
                            (lev_id, "ap"): out_ap, (lev_id, "t"): out_t,
                            (lev_id, "ac"): out_ac})
            tc, tv = _trim(tc, tv, tw)
            acc, acv = _trim(acc, acv, aw)

            P = EllMatrix(vals=pv, cols=pc, n_cols=nc_b)
            P_store, Pt_store = P, EllMatrix(vals=tv, cols=tc, n_cols=n)
            T, offs = None, None
            if transfer_dia and shifts is not None:
                # stencil level: store the interpolation as fine-space
                # diagonals (seq/transfer_dia.py). The offsets are probed
                # in every setup: they depend on the grid.
                def build_t():
                    if not replay:
                        offs = probe_transfer_offsets(pc, cf, nc_b)
                        return (None if offs is None else
                                build_transfer_dia(P, cf, offs)), offs
                    offs = tuple(rl["tdia"])
                    win = (rl["we"], rl["xe"], rl["wc"], rl["xc"])
                    uniq = probe_offsets_device(pc, _c2f_from_cf(cf, nc_b))
                    T, sc = build_transfer_dia(P, cf, offs,
                                               known_windows=win)
                    checks.add(f"L{lev_id} transfer offsets", uniq,
                               _offsets_match(offs))
                    checks.add(f"L{lev_id} transfer windows", sc,
                               lambda v, n=n, nc=nc_b, w=win:
                               windows_of(v, n, nc) == w)
                    return T, offs

                T, offs = staged(f"L{lev_id}.transfer_dia", build_t)
                if T is None:
                    complete = False  # the replay needs the TransferDia
                else:
                    P_store, Pt_store = T, None
            levels.append(Level(A=A_cur, P=P_store, Pt=Pt_store, dinv=dinv,
                                l1inv=l1inv, lmax=lmax, cf=cf.to(torch.int8)))
            recs.append(dict(
                agg=int(aggressive), kA=int(kA), ncb=int(nc_b),
                nc=int(n_coarse), out_k=0 if aggressive else int(out_k),
                mp=int(mp), ap=int(out_ap), t=int(out_t), ac=int(out_ac),
                chi=int(ch_i), chap=int(ch_ap), chac=int(ch_ac),
                tw=int(tw), aw=int(aw),
                tdia=None if T is None else [int(o) for o in offs],
                we=0 if T is None else int(T.expand.W),
                xe=0 if T is None else int(T.expand.n_xpad),
                wc=0 if T is None else int(T.compress.W),
                xc=0 if T is None else int(T.compress.n_xpad),
                pmis=int(pm[0]), pmis2=int(pm[2])))
            A_cur = EllMatrix(vals=acv, cols=acc, n_cols=nc_b)
            n_true = n_coarse
            true_sizes.append(n_true)
            shifts = None  # coarse operators are unstructured
        if replay and len(levels) != len(rec["levels"]):
            return None, None, "the ladder has more levels"

        # coarsest level: dense inverse on the device (par_gauss_elim.c
        # analogue; padding rows solved as identity), residual-checked
        # with a pseudo-inverse retry for singular operators
        def coarse():
            inv, resid = _coarse_inv(A_cur.vals, A_cur.cols, n_true)
            if replay:
                got = {}
                checks.add("coarse residual", resid,
                           lambda r: got.update(r=r) or True)
                why = checks.first_failure()
                if why is not None:
                    return None, why
                resid = got["r"]
            if not (float(resid) <= 1e-3):  # also catches a non-finite one
                inv, _ = _coarse_inv(A_cur.vals, A_cur.cols, n_true,
                                     pinv=True)
            return inv, None

        inv, why = staged("coarse_inv", coarse)
        if why is not None:
            return None, None, why
        plan.update(updates)
        hier = AMGHierarchy(
            levels=levels, coarse_inv=inv, galerkin=True, n_fine=n_fine,
            n_level_true=tuple(true_sizes) if row_bucket else (),
            replayed=replay)
        return hier, (recs if complete and recs else None), None

    ksig = _knobs_sig(
        th=strength_threshold, mrs=max_row_sum, ml=max_levels,
        mcs=max_coarse_size, pme=p_max_elmts, tf=trunc_factor, rx=need_cheby,
        crt=coarsen_rtol, sc=s_cap, apc=ap_cap, sym=symmetric,
        agg=agg_num_levels, cdt=coarse_drop_tol, td=transfer_dia)
    shape_sig = shape_key(A.n_rows, A.k, shifts_host)
    if row_bucket and os.environ.get("HYPRE_TPU_NO_FAST_SETUP") != "1":
        rec = _ladder_get(shape_sig, ksig)
        if rec:
            with annotate("setup.replay"):
                hier, _, why = build(rec)
            if hier is not None:
                return hier
            _LOG.warning("device setup: the recorded ladder of shape %s was "
                         "rejected (%s); taking the slow path", shape_sig,
                         why)
    with annotate("setup.slow"):
        hier, recs, _ = build(None)
    if row_bucket and recs:
        _ladder_put(shape_sig, ksig, {"levels": recs})
    return hier


# ---------------------------------------------------------------------------
# Aggressive coarsening: distance-2 strength + second PMIS + multipass
# interpolation (par_amg_setup.c:1193 Create2ndS, par_multi_interp.c)
# ---------------------------------------------------------------------------


def second_pass_pmis(scols: torch.Tensor, cf1: torch.Tensor, n: int,
                     s2_cap: int, shifts=None) -> torch.Tensor:
    """Aggressive second coarsening pass: build the distance-2 strength
    pattern among first-pass C points (hypre_BoomerAMGCreate2ndS) and run
    PMIS on it. Returns the FINAL cf (C = second-pass C, everything else F).

    S2(i,j), i,j in C1: S(i,j) or exists k with S(i,k) & S(k,j). Gather
    route: one row gather of the strong slab and a slab merge (cols only).
    Stencil route: the distance-2 offsets are the pairwise sums of the
    strength stencil's offsets, and an edge exists per output offset when
    one of its path decompositions does (an OR of shifted ANDs, no gather).
    """
    return _second_pass(scols, cf1, n, s2_cap, shifts)[0]


def _second_pass(scols, cf1, n, s2_cap, shifts=None, rounds=None):
    """``second_pass_pmis`` returning its PMIS's (cf, rounds, decided),
    ``rounds`` as ``_pmis`` takes it."""
    ks = scols.shape[1]
    dev = scols.device
    shifts = _as_pack(shifts, n, with_d2=True)
    is_c1 = cf1 == C_PT
    cols_c = scols.clamp(min=0)
    s_valid = scols >= 0

    if shifts is not None:
        if shifts.d2 is None:
            raise ValueError("second_pass needs a d2-enabled StencilPack")
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        cols_list, offs2 = [], []
        for singles, pairs in shifts.d2:
            if singles:
                o = shifts.offs[singles[0]]
            else:
                a0, b0 = pairs[0]
                o = shifts.offs[a0] + shifts.offs[b0]
            v = torch.zeros(n, dtype=torch.bool, device=dev)
            for a in singles:
                v = v | s_valid[:, a]
            for a, b in pairs:
                v = v | (s_valid[:, a]
                         & shift_rows(s_valid[:, b], shifts.offs[a], False))
            # shift_rows fills False out of range, which is the range test
            v = v & is_c1 & shift_rows(is_c1, o, False)
            cols_list.append(_where_col(v, idx + o))
            offs2.append(o)
        s2cols = torch.stack(cols_list, dim=1)
        sp2 = StencilPack(offs2, 2 * shifts.margin)
        cf2, done, decided = _pmis(s2cols, n, shifts=sp2, rounds=rounds)
    else:
        # pre-filter each row's strong slab to its C1 columns, THEN gather
        # those filtered rows: candidates are C1-only by construction
        s_is_c1 = s_valid & is_c1[cols_c.long()]
        sc1 = _where_col(s_valid & s_is_c1, scols)
        nb_cols = sc1[cols_c.long()]  # (n, ks, ks)
        nb_cols = _where_col(s_valid[:, :, None] & (nb_cols >= 0), nb_cols) \
            .reshape(n, ks * ks)
        cand_c1 = torch.cat([sc1, nb_cols], dim=1)
        rows = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
        cand_c1 = _where_col(cand_c1 != rows, cand_c1)
        cand_c1 = _where_col(is_c1[:, None], cand_c1)
        s2cols, _, _ = merge_slab(
            cand_c1, torch.zeros(cand_c1.shape, dtype=torch.float32,
                                 device=dev), s2_cap)
        cf2, done, decided = _pmis(s2cols, n, rounds=rounds)
    # isolated C1 points (no strong C1 within distance 2) must stay C:
    # nothing can interpolate them otherwise
    iso_c1 = is_c1 & ~(s2cols >= 0).any(dim=1)
    cf = torch.where(is_c1 & (cf2 == C_PT), C_PT, F_PT)
    return torch.where(iso_c1, C_PT, cf).to(torch.int32), done, decided


def multipass_interp_device(
    A: EllMatrix,
    scols: torch.Tensor,
    svals: torch.Tensor,
    cf: torch.Tensor,
    cmap: torch.Tensor,
    p_max_elmts: int,
    shifts=None,
    max_passes: int = 3,
):
    """Multipass interpolation (hypre_BoomerAMGBuildMultipass,
    par_multi_interp.c): pass-1 F points use direct interpolation over
    their strong C neighbours; a pass-p point combines its strong
    lower-pass neighbours' P rows, rescaled so the row sum equals
    -(sum off-diag)/a_ii.

    Pass numbers come from a few gather rounds, then one sweep per pass
    gathers the P slab of the strong neighbours and slab-merges. Columns
    come out in coarse numbering. Returns (pc, pv, req, n_unassigned);
    n_unassigned counts F rows with strong neighbours that did not resolve
    within ``max_passes`` (the caller then asks for more passes).
    """
    n, k = A.cols.shape
    ks = scols.shape[1]
    dev = A.device
    shifts = _as_pack(shifts, n)
    dtype = A.dtype
    diag = A.diagonal()
    d_safe = torch.where(diag != 0, diag, 1.0)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    offd = (A.cols >= 0) & (A.cols != rows[:, None])
    offsum = fold_sum(_where_val(offd, A.vals))
    target = -offsum / d_safe  # constant-preserving row-sum target

    s_valid = scols >= 0
    svals = _where_val(s_valid, svals)
    cols_c = scols.clamp(min=0)
    is_c = cf == C_PT

    # pass numbers: C=0; F reachable through strong lower-pass neighbours
    passno = torch.where(is_c, 0, -1).to(torch.int32)
    for r in range(1, max_passes + 1):
        nb = _gather_rows(passno, cols_c, shifts)
        reachable = (s_valid & (nb >= 0) & (nb < r)).any(dim=1)
        passno = torch.where((passno < 0) & reachable, r, passno) \
            .to(torch.int32)
    # unreachable F points keep -1 and get empty rows (hypre drops them
    # too); if they HAVE strong neighbours they may need more passes
    n_unassigned = ((passno < 0) & s_valid.any(dim=1)).sum(dtype=torch.int32)

    width = p_max_elmts if p_max_elmts > 0 else min(4 * ks, 32)
    pc = torch.full((n, width), PAD_COL, dtype=torch.int32, device=dev)
    pv = torch.zeros((n, width), dtype=dtype, device=dev)
    pc[:, 0] = _where_col(is_c, cmap)
    pv[:, 0] = is_c.to(dtype)

    req_all = torch.zeros((), dtype=torch.int32, device=dev)
    for p in range(1, max_passes + 1):
        nb_pass = _gather_rows(passno, cols_c, shifts)
        lower = s_valid & (nb_pass >= 0) & (nb_pass < p)
        if shifts is not None:
            gc = shift_gather_dyn(pc, shifts, fill=PAD_COL, flat=True)
            gv = shift_gather_dyn(pv, shifts, flat=True)
        else:
            gc = pc[cols_c.long()].reshape(n, ks * width)
            gv = pv[cols_c.long()].reshape(n, ks * width)
        coef = _rep(_where_val(lower, -svals / d_safe[:, None]), width)
        cand_c = _where_col(_rep(lower, width) & (gc >= 0), gc)
        cand_v = _where_val(cand_c >= 0, coef * gv)
        mc, mv, req = merge_slab(cand_c, cand_v, width,
                                 max_elmts=p_max_elmts)
        req_all = torch.maximum(req_all, req)
        # rescale to the constant-preserving target (hypre's per-pass scale)
        ssum = fold_sum(mv)
        scale = torch.where(
            (ssum != 0) & (target != 0),
            target / torch.where(ssum != 0, ssum, 1.0), 1.0)
        mv = mv * scale[:, None]
        mine = (passno == p)[:, None]
        pc = torch.where(mine, mc[:, :width], pc)
        pv = torch.where(mine, mv[:, :width], pv)
    return pc, pv, req_all, n_unassigned
