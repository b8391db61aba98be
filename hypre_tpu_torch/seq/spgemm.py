"""Sparse matrix algebra on EllMatrix: SpGEMM, transpose, filter, remap.

Counterpart of ``hypre_tpu/seq/spgemm.py`` (hypre's
``seq_mv/csr_spgemm_device.c`` and ``csr_sptrans_device.c`` roles), in the
same sort/segment formulation: expand candidate products, sort each row by
column, sum duplicates, compact into a fixed output width ``out_k``. The
raw functions return the width the rows really need, so the host-side
caller can run again with a larger capacity.

Duplicate columns are summed left to right in sorted order (one pass per
rank within a run of equal columns), and every scatter writes each
destination once, so no result depends on how a device orders atomics:
the CPU and the card build the same hierarchy.
"""

from __future__ import annotations

import torch

from hypre_tpu_torch.core.config import PAD_COL
from hypre_tpu_torch.seq.ell import EllMatrix

_BIG = 2**30  # sort key for padding; larger than any column index

# candidate-slab element count above which ell_spgemm works over row
# chunks of at most _SPGEMM_CHUNK_ELEMENTS candidates each. The reference
# sends such products to its device-setup slab path; rows are independent,
# so the chunked product is the same row for row.
_BIG_SPGEMM_ELEMENTS = 2e8
_SPGEMM_CHUNK_ELEMENTS = 48e6

# pair-count cap for the stencil-composition product
_STENCIL_SPGEMM_MAX_PAIRS = 4096


def _merge_rows(cols: torch.Tensor, vals: torch.Tensor, out_k: int):
    """Merge duplicate columns within each row of a candidate slab.

    cols: (n, K) int32 with PAD_COL padding; vals: (n, K).
    Returns (out_cols (n,out_k), out_vals (n,out_k), required_k tensor).
    Entries beyond out_k uniques per row are dropped (the caller checks
    required_k and retries with a larger capacity).
    """
    n, K = cols.shape
    dev = cols.device
    valid = cols >= 0
    key = torch.where(valid, cols, torch.full_like(cols, _BIG))
    sc, order = torch.sort(key, dim=1, stable=True)
    sv = torch.gather(torch.where(valid, vals, torch.zeros_like(vals)), 1,
                      order)
    valid_s = sc < _BIG
    is_new = torch.cat(
        [valid_s[:, :1], (sc[:, 1:] != sc[:, :-1]) & valid_s[:, 1:]], dim=1)
    upos = torch.cumsum(is_new.to(torch.int32), dim=1) - 1
    if K > 0 and n > 0:
        required_k = (upos[:, -1] + 1).max()
    else:
        required_k = torch.zeros((), dtype=torch.int64, device=dev)
    # padding and entries beyond capacity are dropped
    kept = valid_s & (upos < out_k)
    rows = torch.arange(n, device=dev)[:, None].expand(n, K)

    # rank of each entry within its run of equal columns
    idx = torch.arange(K, device=dev).expand(n, K)
    seg_start = torch.cummax(
        torch.where(is_new, idx, torch.zeros_like(idx)), dim=1).values
    rank = idx - seg_start
    out_cols = torch.full((n, out_k), PAD_COL, dtype=torch.int32, device=dev)
    out_vals = torch.zeros((n, out_k), dtype=vals.dtype, device=dev)
    first = kept & is_new
    out_cols[rows[first], upos[first].long()] = sc[first]
    max_rank = int(rank[kept].max()) if bool(kept.any()) else -1
    for d in range(max_rank + 1):
        # each (row, slot) appears at most once per rank
        m = kept & (rank == d)
        r_m, u_m = rows[m], upos[m].long()
        out_vals[r_m, u_m] = out_vals[r_m, u_m] + sv[m]
    return out_cols, out_vals, required_k


def stencil_spgemm(A: EllMatrix, B: EllMatrix) -> EllMatrix:
    """C = A @ B when both operands are shift-structured stencils.

    Stencil offsets compose additively: C's diagonal set is the pairwise
    sums {sa + sb}, and each output diagonal is a sum of rolled elementwise
    products. A wrapped roll can only be read where A's slot is
    structurally invalid (value 0), so the unmasked sum is exact; C's
    structure is tracked through rolled masks.
    """
    shA = tuple(int(s) for s in A.shifts)
    shB = tuple(int(s) for s in B.shifts)
    n = A.n_rows
    pairs: dict[int, list] = {}
    for ia, sa in enumerate(shA):
        for ib, sb in enumerate(shB):
            pairs.setdefault(sa + sb, []).append((ia, ib, sa))
    offs = sorted(pairs)
    idx = torch.arange(n, dtype=torch.int32, device=A.device)
    a_valid = A.cols >= 0
    b_valid = B.cols >= 0
    cols_list, vals_list = [], []
    for o in offs:
        acc = torch.zeros(n, dtype=A.dtype, device=A.device)
        vmask = torch.zeros(n, dtype=torch.bool, device=A.device)
        for ia, ib, sa in pairs[o]:
            acc = acc + A.vals[:, ia] * torch.roll(B.vals[:, ib], -sa)
            vmask = vmask | (a_valid[:, ia] & torch.roll(b_valid[:, ib], -sa))
        cols_list.append(torch.where(vmask, idx + o,
                                     torch.full_like(idx, PAD_COL)))
        vals_list.append(torch.where(vmask, acc, torch.zeros_like(acc)))
    return EllMatrix(
        vals=torch.stack(vals_list, dim=1),
        cols=torch.stack(cols_list, dim=1).to(torch.int32),
        n_cols=B.n_cols,
        shifts=tuple(offs),
    )


def ell_spgemm_raw(A: EllMatrix, B: EllMatrix, out_k: int):
    """C = A @ B with fixed output width; returns (C, required_k)."""
    aco = A.cols.clamp(min=0).long()
    cand_cols = B.cols[aco]  # (n, kA, kB)
    cand_vals = A.vals[:, :, None] * B.vals[aco]
    a_valid = (A.cols >= 0)[:, :, None]
    cand_cols = torch.where(a_valid, cand_cols,
                            torch.full_like(cand_cols, PAD_COL))
    cand_vals = torch.where(a_valid, cand_vals, torch.zeros_like(cand_vals))
    n = A.n_rows
    out_cols, out_vals, required_k = _merge_rows(
        cand_cols.reshape(n, -1), cand_vals.reshape(n, -1), out_k)
    return EllMatrix(vals=out_vals, cols=out_cols, n_cols=B.n_cols), required_k


def _row_slice(A: EllMatrix, lo: int, hi: int) -> EllMatrix:
    return EllMatrix(vals=A.vals[lo:hi], cols=A.cols[lo:hi], n_cols=A.n_cols)


def _spgemm_chunked(A: EllMatrix, B: EllMatrix, out_k: int):
    """ell_spgemm_raw over row chunks of bounded candidate count."""
    n = A.n_rows
    per_row = max(A.k * B.k, 1)
    rows = max(int(_SPGEMM_CHUNK_ELEMENTS // per_row), 1)
    vals, cols, req = [], [], 0
    for lo in range(0, n, rows):
        C, r = ell_spgemm_raw(_row_slice(A, lo, min(lo + rows, n)), B, out_k)
        vals.append(C.vals)
        cols.append(C.cols)
        req = max(req, int(r))
    C = EllMatrix(vals=torch.cat(vals), cols=torch.cat(cols), n_cols=B.n_cols)
    return C, req


def ell_spgemm(A: EllMatrix, B: EllMatrix, out_k: int | None = None) -> EllMatrix:
    """Host-orchestrated SpGEMM with capacity re-estimation on overflow.

    Products with more than ``_BIG_SPGEMM_ELEMENTS`` candidates (n*kA*kB)
    run over row chunks to bound device memory.
    """
    n, kA, kB = A.n_rows, A.k, B.k
    if (
        A.shifts is not None
        and B.shifts is not None
        and A.n_cols == B.n_rows == n
        and kA * kB <= _STENCIL_SPGEMM_MAX_PAIRS
    ):
        return stencil_spgemm(A, B)
    if out_k is None:
        out_k = min(kA * kB, max(kA, kB) * 4)
    if n * kA * kB > _BIG_SPGEMM_ELEMENTS:
        run = _spgemm_chunked
    else:
        def run(A_, B_, k_):
            C_, r_ = ell_spgemm_raw(A_, B_, k_)
            return C_, int(r_)
    C, required_k = run(A, B, out_k)
    if required_k > out_k:
        C, _ = run(A, B, required_k)
    elif required_k < out_k:
        # uniques are left-aligned by the merge; shrink to the true width
        k = max(required_k, 1)
        C = EllMatrix(vals=C.vals[:, :k], cols=C.cols[:, :k], n_cols=C.n_cols)
    return C


def stencil_transpose(A: EllMatrix) -> EllMatrix:
    """A^T of a shift-structured square stencil, by rolls: diagonal o of
    the transpose is diagonal -o of A rolled by -o."""
    sh = tuple(int(s) for s in A.shifts)
    slot = {s: j for j, s in enumerate(sh)}
    offs = sorted(-s for s in sh)
    idx = torch.arange(A.n_rows, dtype=torch.int32, device=A.device)
    a_valid = A.cols >= 0
    cols_list, vals_list = [], []
    for o in offs:
        j = slot[-o]
        m = torch.roll(a_valid[:, j], -o)
        v = torch.roll(A.vals[:, j], -o)
        vals_list.append(torch.where(m, v, torch.zeros_like(v)))
        cols_list.append(torch.where(m, idx + o, torch.full_like(idx, PAD_COL)))
    return EllMatrix(
        vals=torch.stack(vals_list, dim=1),
        cols=torch.stack(cols_list, dim=1).to(torch.int32),
        n_cols=A.n_rows,
        shifts=tuple(offs),
    )


def ell_transpose_raw(A: EllMatrix, out_k: int):
    """T = A.T with fixed row width; returns (T, required_k).

    Sort all entries by column (stable keeps row order), find each entry's
    slot within its column run by a running segment-start cummax, then
    scatter into the transposed slab. Duplicate (row, col) entries remain
    duplicates (ELL semantics sum them).
    """
    n, k = A.cols.shape
    dev = A.device
    flat_cols = A.cols.reshape(-1)
    flat_vals = A.vals.reshape(-1)
    flat_rows = torch.arange(n, dtype=torch.int32, device=dev)[:, None] \
        .expand(n, k).reshape(-1)
    valid = flat_cols >= 0
    key = torch.where(valid, flat_cols, torch.full_like(flat_cols, _BIG))
    sc, order = torch.sort(key, stable=True)
    sv = flat_vals[order]
    sr = flat_rows[order]
    idx = torch.arange(n * k, device=dev)
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        sc[1:] != sc[:-1]])
    seg_start = torch.cummax(torch.where(is_new, idx, torch.zeros_like(idx)),
                             dim=0).values
    slot = idx - seg_start
    valid_s = sc < _BIG
    if n * k:
        required_k = (torch.where(valid_s, slot, torch.full_like(slot, -1))
                      .max() + 1)
    else:
        required_k = torch.zeros((), dtype=torch.int64, device=dev)
    # every in-range destination (column, slot) is hit exactly once
    sel = valid_s & (slot < out_k)
    flat_dst = sc[sel].long() * out_k + slot[sel]
    t_vals = torch.zeros(A.n_cols * out_k, dtype=A.dtype, device=dev)
    t_vals[flat_dst] = sv[sel]
    t_cols = torch.full((A.n_cols * out_k,), PAD_COL, dtype=torch.int32,
                        device=dev)
    t_cols[flat_dst] = sr[sel]
    t_vals = t_vals.reshape(A.n_cols, out_k)
    t_cols = t_cols.reshape(A.n_cols, out_k)
    T = EllMatrix(vals=t_vals, cols=t_cols, n_cols=n)
    return T, required_k


def ell_transpose(A: EllMatrix, out_k: int | None = None) -> EllMatrix:
    if A.shifts is not None and A.n_cols == A.n_rows:
        return stencil_transpose(A)
    if out_k is None:
        # average row fill of A.T, padded up; retried below if insufficient
        out_k = max(2 * A.k, 4)
    T, required_k = ell_transpose_raw(A, out_k)
    required_k = int(required_k)
    if required_k > out_k:
        T, _ = ell_transpose_raw(A, required_k)
    elif required_k < out_k:
        # slots are filled left-to-right per column segment; shrink
        k = max(required_k, 1)
        T = EllMatrix(vals=T.vals[:, :k], cols=T.cols[:, :k], n_cols=T.n_cols)
    return T


def ell_filter(A: EllMatrix, keep: torch.Tensor,
               out_k: int | None = None) -> EllMatrix:
    """Keep only entries where ``keep`` (n,k) is True, compacting rows left
    (stable: kept entries keep their order)."""
    keep = keep & A.structural_mask()
    order = torch.argsort(keep.logical_not().to(torch.int32), dim=1,
                          stable=True)
    cols = torch.gather(
        torch.where(keep, A.cols, torch.full_like(A.cols, PAD_COL)), 1, order)
    vals = torch.gather(
        torch.where(keep, A.vals, torch.zeros_like(A.vals)), 1, order)
    if out_k is not None:
        cols, vals = cols[:, :out_k], vals[:, :out_k]
    return EllMatrix(vals=vals, cols=cols, n_cols=A.n_cols)


def ell_remap_cols(A: EllMatrix, col_map: torch.Tensor,
                   new_n_cols: int) -> EllMatrix:
    """Renumber columns through ``col_map`` (entries mapping to <0 are
    dropped)."""
    mapped = col_map[A.cols.clamp(min=0).long()].to(torch.int32)
    new_cols = torch.where(A.cols >= 0, mapped, torch.full_like(mapped, PAD_COL))
    vals = torch.where(new_cols >= 0, A.vals, torch.zeros_like(A.vals))
    new_cols = torch.where(new_cols >= 0, new_cols,
                           torch.full_like(new_cols, PAD_COL))
    return EllMatrix(vals=vals, cols=new_cols, n_cols=new_n_cols)
