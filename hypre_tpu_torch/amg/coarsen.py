"""Coarsening: PMIS, CLJP, Ruge-Stüben, HMIS, CR and CGC
(hypre_BoomerAMGCoarsen*, parcsr_ls/par_coarsen.c, par_cr.c,
par_cgc_coarsen.c).

Counterpart of ``hypre_tpu/amg/coarsen.py``. PMIS (the device default,
par_coarsen.c:2813) runs every round data-parallel:

  measure_i = |S^T_i| + rand_i   (rand from the stateless hash of the row)
  repeat until no point is undecided:
    - a point joins C if its measure beats every undecided neighbour in
      S_i ∪ S^T_i,
    - an undecided point becomes F once some C point appears in S_i.

CLJP adds its measure updates to the same rounds, CR promotes the points
where F-relaxation contracts slowly, and the HMIS cleanup is one pass;
these are tensor code on the hierarchy's device, reading one flag back per
round. Ruge-Stüben's first pass, HMIS's RS pass and CGC's candidate
passes are sequential greedy algorithms on the host in the reference too
(numpy and ``heapq``); they read S back, run there and hand a CF marker
back on A's device.

CF marker convention follows hypre: +1 = C-point, -1 = F-point. Points with
no strong connections are finalized as F with an empty interpolation row.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from hypre_tpu_torch.amg.strength import strength_transpose_counts
from hypre_tpu_torch.core.config import hash_rand01
from hypre_tpu_torch.seq.ell import EllMatrix

C_PT = 1
F_PT = -1
UNDECIDED = 0


def pmis(A: EllMatrix, S: torch.Tensor,
         global_row_offset: int = 0) -> torch.Tensor:
    """Returns the CF marker (n,) int32 in {+1 C, -1 F}."""
    n, _ = A.cols.shape
    dev = A.device
    rows_global = torch.arange(n, dtype=torch.int64, device=dev) \
        + global_row_offset
    st_counts = strength_transpose_counts(A, S)
    measure = st_counts.to(A.dtype) + hash_rand01(rows_global).to(A.dtype)

    has_strong_row = S.any(dim=1)
    has_strong_col = st_counts > 0
    isolated = ~has_strong_row & ~has_strong_col

    cols_c = A.cols.clamp(min=0).long()
    # the strong slots only, as (row, col) pairs: the reference scatters
    # every slot and sends the weak ones to an overflow slot, which on the
    # card makes millions of atomics contend for one address
    strong_rows, strong_slots = S.nonzero(as_tuple=True)
    strong_cols = A.cols[strong_rows, strong_slots].long()
    zero = torch.zeros((), dtype=A.dtype, device=dev)

    cf = torch.where(isolated, F_PT, UNDECIDED).to(torch.int32)
    while bool((cf == UNDECIDED).any()):
        prev = cf
        undecided = cf == UNDECIDED
        m = torch.where(undecided, measure, zero)

        # neighbour max over S rows (gather) and S columns (scatter-max)
        row_nbr_max = torch.where(S, m[cols_c], zero).amax(dim=1)
        col_nbr_max = torch.zeros(n, dtype=m.dtype, device=dev) \
            .scatter_reduce(0, strong_cols, m[strong_rows], "amax",
                            include_self=True)
        nbr_max = torch.maximum(row_nbr_max, col_nbr_max)

        new_c = undecided & (m > nbr_max) & (m > 0)
        cf = torch.where(new_c, C_PT, cf).to(torch.int32)

        # undecided points strongly depending on a C point become F
        dep_on_c = (S & (cf[cols_c] == C_PT)).any(dim=1)
        cf = torch.where((cf == UNDECIDED) & dep_on_c, F_PT, cf).to(torch.int32)
        cf = torch.where((cf == UNDECIDED) & isolated, F_PT, cf).to(torch.int32)
        # stall guard: if nothing changed this round (pathological ties),
        # promote all remaining undecided to C to guarantee termination
        stalled = bool((cf == prev).all())
        if stalled:
            cf = torch.where(cf == UNDECIDED, C_PT, cf).to(torch.int32)
    return cf


def coarse_map(cf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(map, n_coarse): map[i] = coarse index of C-point i, -1 for F-points
    (hypre's coarse-grid numbering pass, par_coarse_parms.c)."""
    is_c = cf == C_PT
    idx = torch.cumsum(is_c.to(torch.int32), dim=0, dtype=torch.int32) - 1
    return torch.where(is_c, idx, torch.full_like(idx, -1)), \
        is_c.to(torch.int32).sum()


# ---------------------------------------------------------------------------
# CLJP (par_coarsen.c:93, coarsen types 0/7)
# ---------------------------------------------------------------------------


def cljp(A: EllMatrix, S: torch.Tensor,
         global_row_offset: int = 0) -> torch.Tensor:
    """Cleary-Luby-Jones-Plassmann coarsening: the PMIS rounds plus
    CLJP's weight updates. Each strong edge to a C point (either way)
    takes one from an undecided point's measure, recomputed from the
    starting measure; a point whose measure falls below 1 becomes F."""
    n, _ = A.cols.shape
    dev = A.device
    rows_global = torch.arange(n, dtype=torch.int64, device=dev) \
        + global_row_offset
    st_counts = strength_transpose_counts(A, S)
    measure0 = st_counts.to(A.dtype) + hash_rand01(rows_global).to(A.dtype)
    isolated = ~S.any(dim=1) & (st_counts == 0)
    cols_c = A.cols.clamp(min=0).long()
    strong_rows, strong_slots = S.nonzero(as_tuple=True)
    strong_cols = A.cols[strong_rows, strong_slots].long()
    zero = torch.zeros((), dtype=A.dtype, device=dev)

    measure = measure0
    cf = torch.where(isolated, F_PT, UNDECIDED).to(torch.int32)
    while bool((cf == UNDECIDED).any()):
        prev = cf
        undecided = cf == UNDECIDED
        m = torch.where(undecided, measure, zero)
        row_nbr_max = torch.where(S, m[cols_c], zero).amax(dim=1)
        col_nbr_max = torch.zeros(n, dtype=m.dtype, device=dev) \
            .scatter_reduce(0, strong_cols, m[strong_rows], "amax",
                            include_self=True)
        new_c = undecided & (m > torch.maximum(row_nbr_max, col_nbr_max)) \
            & (m > 0)
        cf = torch.where(new_c, C_PT, cf).to(torch.int32)

        # every strong edge touching a C point loses its vote: counts are
        # integers, exact in any order
        is_c = cf == C_PT
        dec_row = (S & is_c[cols_c]).sum(dim=1).to(A.dtype)
        from_c = is_c[strong_rows]
        dec_col = torch.bincount(strong_cols[from_c], minlength=n) \
            .to(A.dtype)
        measure = torch.where(undecided & ~new_c,
                              measure0 - dec_row - dec_col, measure)
        cf = torch.where((cf == UNDECIDED) & (measure < 1.0), F_PT, cf) \
            .to(torch.int32)
        cf = torch.where((cf == UNDECIDED) & isolated, F_PT, cf) \
            .to(torch.int32)
        if bool((cf == prev).all()):
            cf = torch.where(cf == UNDECIDED, C_PT, cf).to(torch.int32)
    return cf


# ---------------------------------------------------------------------------
# Ruge-Stüben first pass and HMIS (par_coarsen.c:908, 2846; on the host)
# ---------------------------------------------------------------------------


def _strong_lists(A: EllMatrix, S: torch.Tensor, rows=None):
    """Host adjacency of the strong graph: dep[i] = the columns i strongly
    depends on (slot order), inf[j] = the rows that depend on j (row
    order). ``rows`` (a boolean host mask) keeps only edges between rows
    it marks."""
    Sh = S.cpu().numpy()
    cols = A.cols.cpu().numpy()
    ei, ea = np.nonzero(Sh)
    ej = cols[ei, ea].astype(np.int64)
    if rows is not None:
        keep = rows[ei] & rows[ej]
        ei, ej = ei[keep], ej[keep]
    n = cols.shape[0]
    dep = np.split(ej, np.cumsum(np.bincount(ei, minlength=n))[:-1])
    order = np.argsort(ej, kind="stable")
    inf = np.split(ei[order], np.cumsum(np.bincount(ej, minlength=n))[:-1])
    return [d.tolist() for d in dep], [f.tolist() for f in inf]


def _rs_pass(dep, inf, idx, measure, unit: int, cf) -> None:
    """Greedy max-measure C selection over the points ``idx`` (a bucket
    queue by heap): the chosen point's dependents become F and their other
    dependencies gain ``unit``; its own dependencies lose ``unit``. A point
    popped with less than ``unit`` left becomes F."""
    heap = [(-measure[i], i) for i in idx]
    heapq.heapify(heap)
    while heap:
        negm, i = heapq.heappop(heap)
        if cf[i] != UNDECIDED or -negm != measure[i]:
            continue  # stale entry
        if measure[i] < unit:
            cf[i] = F_PT
            continue
        cf[i] = C_PT
        for j in inf[i]:
            if cf[j] == UNDECIDED:
                cf[j] = F_PT
                for l in dep[j]:
                    if cf[l] == UNDECIDED:
                        measure[l] += unit
                        heapq.heappush(heap, (-measure[l], l))
        for j in dep[i]:
            if cf[j] == UNDECIDED:
                measure[j] -= unit
                heapq.heappush(heap, (-measure[j], j))


def ruge_stuben(A: EllMatrix, S: torch.Tensor) -> torch.Tensor:
    """Classical RS first-pass coarsening (hypre_BoomerAMGCoarsenRuge,
    coarsen_type 1): sequential and greedy, so it runs on the host, as in
    the reference; returns the CF marker on A's device."""
    n = A.n_rows
    dep, inf = _strong_lists(A, S)
    measure = [len(inf[i]) for i in range(n)]
    cf = np.zeros(n, dtype=np.int32)
    _rs_pass(dep, inf, range(n), measure, 1, cf)
    cf[cf == UNDECIDED] = F_PT
    return torch.from_numpy(cf).to(A.device)


def _promote_uncovered(A: EllMatrix, S: torch.Tensor,
                       cf: torch.Tensor) -> torch.Tensor:
    """Strong F points without a strong C dependency become C (the HMIS
    and CGC repair)."""
    dep_on_c = (S & (cf[A.cols.clamp(min=0).long()] == C_PT)).any(dim=1)
    bad = (cf == F_PT) & S.any(dim=1) & ~dep_on_c
    return torch.where(bad, C_PT, cf).to(torch.int32)


def hmis(A: EllMatrix, S: torch.Tensor,
         global_row_offset: int = 0) -> torch.Tensor:
    """HMIS coarsening (type 10) on one shard: the RS first pass, then
    every F point left without a strong C dependency joins C."""
    return _promote_uncovered(A, S, ruge_stuben(A, S))


# ---------------------------------------------------------------------------
# Compatible relaxation (par_cr.c, coarsen types 98/99)
# ---------------------------------------------------------------------------


def cr(A: EllMatrix, S: torch.Tensor, num_relax: int = 5,
       theta_cr: float = 0.7, max_rounds: int = 10) -> torch.Tensor:
    """Compatible relaxation: F-relaxation on A e = 0 from a hashed random
    error; the F points where the error contracts slower than
    ``theta_cr`` per sweep are the slow ones. A PMIS pass over the slow
    points' strong graph picks the new C points (with the slow points
    that have no slow strong neighbour); repeat."""
    n, _ = A.cols.shape
    dev = A.device
    diag = A.diagonal()
    nz = diag != 0
    dinv = torch.where(nz, 1.0 / torch.where(nz, diag, torch.ones_like(diag)),
                       torch.zeros_like(diag))
    cf = torch.full((n,), F_PT, dtype=torch.int32, device=dev)
    e0 = hash_rand01(torch.arange(n, device=dev)).to(A.dtype) - 0.5
    zero = torch.zeros((), dtype=A.dtype, device=dev)
    cols_c = A.cols.clamp(min=0).long()
    for _ in range(max_rounds):
        is_f = cf == F_PT
        e = torch.where(is_f, e0, zero)
        before = e.abs()
        for _ in range(num_relax):
            # Jacobi on the F points, C points pinned to 0
            e = torch.where(is_f, e - dinv * A.mv(e), zero)
        ratio = (e.abs() / torch.clamp(before, min=1e-30)) \
            ** (1.0 / num_relax)
        slow = is_f & (ratio > theta_cr)
        if not bool(slow.any()):
            break
        sub_S = S & slow[cols_c] & slow[:, None]
        newly_c = slow & (pmis(A, sub_S) == C_PT)
        newly_c = newly_c | (slow & ~sub_S.any(dim=1))
        if not bool(newly_c.any()):
            newly_c = slow
        cf = torch.where(newly_c, C_PT, cf).to(torch.int32)
    return cf


# ---------------------------------------------------------------------------
# CGC — coarse grid classification (par_cgc_coarsen.c, types 21/22)
# ---------------------------------------------------------------------------


def cgc(A: EllMatrix, S: torch.Tensor, num_candidates: int = 4,
        n_blocks: int = 0, cc_penalty: float = 2.0) -> torch.Tensor:
    """Coarse-grid-classification coarsening (Griebel/Metsch/Schweitzer),
    on the host as in the reference: the rows fall into contiguous blocks
    (the reference's ranks); each block runs the RS first pass over its
    own strong edges ``num_candidates`` times with seeded tie-breaks; the
    blocks, most cross-connected first, then pick the candidate that
    minimizes ``cc_penalty`` x (cross strong C-C pairs) + (uncovered cross
    F points) against the blocks fixed so far. The HMIS repair ends it."""
    Sh = S.cpu().numpy()
    cols = A.cols.cpu().numpy()
    n = cols.shape[0]
    if n_blocks <= 0:
        n_blocks = int(min(max(n // 256, 1), 8))
    bounds = np.linspace(0, n, n_blocks + 1).astype(np.int64)
    block_of = np.zeros(n, np.int64)
    for b in range(n_blocks):
        block_of[bounds[b]:bounds[b + 1]] = b
    ei, ea = np.nonzero(Sh)
    ej = cols[ei, ea]
    intra = block_of[ei] == block_of[ej]
    cross_i, cross_j = ei[~intra], ej[~intra]

    def rs_block(b: int, dep, inf, seed: int) -> np.ndarray:
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        w = hi - lo
        tie = np.random.RandomState(12345 + seed).permutation(w)
        # a measure of w per dependent, ties broken by the permutation
        measure = {i: len(inf[i]) * w + int(tie[i - lo])
                   for i in range(lo, hi)}
        cf = np.zeros(n, np.int32)
        _rs_pass(dep, inf, range(lo, hi), measure, w, cf)
        part = cf[lo:hi]
        part[part == UNDECIDED] = F_PT
        return part

    cands = []
    for b in range(n_blocks):
        in_b = block_of == b
        dep, inf = _strong_lists(A, S, rows=in_b)
        cands.append([rs_block(b, dep, inf, c)
                      for c in range(num_candidates)])

    def score(cf_full: np.ndarray, b: int, cand: np.ndarray) -> float:
        trial = cf_full.copy()
        trial[bounds[b]:bounds[b + 1]] = cand
        m = (block_of[cross_i] == b) | (block_of[cross_j] == b)
        ti, tj = cross_i[m], cross_j[m]
        fixed = (trial[ti] != UNDECIDED) & (trial[tj] != UNDECIDED)
        ti, tj = ti[fixed], tj[fixed]
        cc = np.sum((trial[ti] == C_PT) & (trial[tj] == C_PT))
        uncov = 0
        for i in np.unique(ti[trial[ti] == F_PT]):
            if not np.any(trial[cols[i][Sh[i]]] == C_PT):
                uncov += 1
        return cc_penalty * float(cc) + float(uncov)

    cf_full = np.zeros(n, np.int32)
    cross_count = np.bincount(block_of[cross_i], minlength=n_blocks)
    for b in np.argsort(-cross_count):
        best = min(range(num_candidates),
                   key=lambda c: score(cf_full, b, cands[b][c]))
        cf_full[bounds[b]:bounds[b + 1]] = cands[b][best]
    return _promote_uncovered(A, S, torch.from_numpy(cf_full).to(A.device))
