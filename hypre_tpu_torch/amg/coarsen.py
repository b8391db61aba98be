"""PMIS coarsening (hypre_BoomerAMGCoarsenPMIS, parcsr_ls/par_coarsen.c:2813).

Counterpart of ``hypre_tpu/amg/coarsen.py`` (PMIS and the coarse
numbering; the other coarsenings come later). Every round is
data-parallel:

  measure_i = |S^T_i| + rand_i   (rand from the stateless hash of the row)
  repeat until no point is undecided:
    - a point joins C if its measure beats every undecided neighbour in
      S_i ∪ S^T_i,
    - an undecided point becomes F once some C point appears in S_i.

CF marker convention follows hypre: +1 = C-point, -1 = F-point. Points with
no strong connections are finalized as F with an empty interpolation row.
The loop reads one flag back to the host per round.
"""

from __future__ import annotations

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
