"""ILU(k) and ILUT with a fine-grained parallel factorization and
iterative triangular solves.

Counterpart of ``hypre_tpu/precond/ilu.py`` (hypre's ILU family,
``parcsr_ls/par_ilu_setup.c``, GPU triangular solves at
``par_ilu_solve.c``):

- factorization: Chow-Patel fine-grained ILU, the ILU fixed-point
  equations iterated over all nonzeros at once. Each sweep reads only the
  previous sweep's factor values (a Jacobi-style fixed point), so its
  result is the reference's to rounding, whatever the summation order.
- application: Jacobi-iterated triangular solves (hypre's
  ``iterative_setup_type`` / GPU path): y ~= (I+L)^{-1} r by m sweeps of
  y <- r - L y, then x ~= U^{-1} y by x <- D^{-1}(y - U' x).

The reference finds U(c_a, c_b) for row i's slot pair (a, b) through an
(n, k, k, k) one-hot match; at k = 25 (ILU(1) on the 7-pt operator,
n = 2 097 152) that is 33 G elements. Here a binary search in the sorted
columns of row c_a finds the slot once per setup (``pair_slots``), stored
as an (n, k, k) int32 index; every sweep gathers through it in row chunks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hypre_tpu_torch.core.config import PAD_COL, fold_sum, resolve_device
from hypre_tpu_torch.precond.common import pair_slots, row_chunks, sorted_rows
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.spgemm import ell_filter, ell_spgemm


def _row_ids(A: EllMatrix) -> torch.Tensor:
    return torch.arange(A.n_rows, dtype=A.cols.dtype, device=A.device)[:, None]


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def compact_ell(A: EllMatrix) -> EllMatrix:
    """A with its entries left-compacted (in slot order) and its width cut
    to the widest row: the same matrix in fewer slots."""
    C = ell_filter(A, A.cols >= 0)
    width = max(int((C.cols >= 0).sum(dim=1).max()), 1)
    return EllMatrix(vals=C.vals[:, :width].contiguous(),
                     cols=C.cols[:, :width].contiguous(), n_cols=C.n_cols)


def pair_index(cols: torch.Tensor, keep) -> torch.Tensor:
    """(n, k, k) int32 flat index c_a * k + s of row c_a's entry in column
    c_b, or -1, kept only where ``keep(ca, cb)`` (both (m, k, k)) holds;
    built in row chunks."""
    n, k = cols.shape
    skey, perm = sorted_rows(cols)
    out = []
    for lo, hi in row_chunks(n, 8 * k * k):
        pos = pair_slots(cols, skey, perm, lo, hi)
        c = cols[lo:hi]
        ok = keep(c[:, :, None], c[:, None, :])
        out.append(torch.where(ok, pos, torch.full_like(pos, -1))
                   .to(torch.int32))
    return torch.cat(out)


def pair_values(F: torch.Tensor, pos: torch.Tensor, lo: int,
                hi: int) -> torch.Tensor:
    """F at the flat slots pos[lo:hi] (0 where -1)."""
    p = pos[lo:hi].long()
    got = F.reshape(-1)[p.clamp(min=0)]
    return torch.where(p >= 0, got, _zero(got))


@dataclasses.dataclass
class ILU:
    """HYPRE_ILU* object protocol (HYPRE_parcsr_ls.h; ilu_type 0 =
    ILU(0)). fill_level > 0 gives ILU(k) on the pattern of A^(k+1),
    hypre's level of fill."""

    factor_sweeps: int = 5
    solve_sweeps: int = 6
    fill_level: int = 0

    L: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    U: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    dinv: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                     repr=False)

    def setup(self, A: EllMatrix, device=None) -> "ILU":
        """Factor A on ``device`` (CUDA unless the caller names another)."""
        A = A.to(resolve_device(device))
        if self.fill_level > 0:
            A = grow_pattern(A, self.fill_level)
        F = chow_patel_sweeps(A, self.factor_sweeps)
        self._split_factors(A, F)
        return self

    def _split_factors(self, A: EllMatrix, F: torch.Tensor) -> None:
        cols = A.cols
        row_ids = _row_ids(A)
        is_l = (cols >= 0) & (cols < row_ids)
        # U without its diagonal, which is applied through dinv
        is_u = (cols >= 0) & (cols > row_ids)
        diag = fold_sum(torch.where(cols == row_ids, F, _zero(F)))
        pad = torch.full_like(cols, PAD_COL)
        self.L = compact_ell(EllMatrix(vals=torch.where(is_l, F, _zero(F)),
                                       cols=torch.where(is_l, cols, pad),
                                       n_cols=A.n_cols))
        self.U = compact_ell(EllMatrix(vals=torch.where(is_u, F, _zero(F)),
                                       cols=torch.where(is_u, cols, pad),
                                       n_cols=A.n_cols))
        self.dinv = 1.0 / torch.where(diag != 0, diag, torch.ones_like(diag))

    def precond(self):
        """M^{-1} ~= (LU)^{-1} by Jacobi-iterated triangular solves."""
        L, U, dinv = self.L, self.U, self.dinv
        if L is None:
            raise RuntimeError("call setup(A) first")
        m = self.solve_sweeps

        def M(r):
            y = r
            for _ in range(m):
                y = r - L.mv(y)  # (I + L) y = r
            x = dinv * y
            for _ in range(m):
                x = dinv * (y - U.mv(x))  # (D + U') x = y
            return x

        return M


def chow_patel_sweeps(A: EllMatrix, sweeps: int,
                      F0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sweeps`` Chow-Patel fixed-point iterations on A's pattern; returns
    the factor values F (L strictly lower, scaled; U upper with its
    diagonal) aligned with A.cols. F0 warm-starts the iteration (ILUT's
    refit after the prune). Rows hold each column once."""
    n, k = A.cols.shape
    cols = A.cols
    row_ids = _row_ids(A)
    is_l = (cols >= 0) & (cols < row_ids)
    is_u = (cols >= 0) & (cols >= row_ids)
    is_d = cols == row_ids
    csafe = cols.clamp(min=0).long()
    # U(c_a, c_b) for c_a < c_b, the k-range constraint k = c_a < j = c_b
    pos = pair_index(cols, lambda ca, cb: ca < cb)
    chunks = row_chunks(n, 4 * k * k)

    F = torch.where(cols >= 0, A.vals, _zero(A.vals)) if F0 is None else F0
    for _ in range(sweeps):
        Lia = torch.where(is_l, F, _zero(F))
        S = torch.cat([(Lia[lo:hi, :, None] * pair_values(F, pos, lo, hi))
                       .sum(dim=1) for lo, hi in chunks])
        dU = fold_sum(torch.where(is_d, F, _zero(F)))
        dU = torch.where(dU != 0, dU, torch.ones_like(dU))
        new = A.vals - S
        F = torch.where(is_u, new, torch.where(is_l, new / dU[csafe],
                                               _zero(F)))
    return F


@dataclasses.dataclass
class ILUT(ILU):
    """Threshold ILU, hypre's ilu_type 1 ILUT(p, tau)
    (``parcsr_ls/par_ilu_setup.c:346-527``; Saad's dual threshold: drop
    |entry| < tau * ||row of A||_2 and keep at most ``max_row_nnz`` entries
    per row in each of L and U, the diagonal always kept).

    The candidate pattern is that of A^(fill_level+1), factored by
    Chow-Patel sweeps, pruned by the dual threshold (a per-row sort of the
    factor values, once per setup) and swept again on the pruned pattern
    from the kept values."""

    drop_tol: float = 1e-3
    max_row_nnz: int = 0   # 0 = unlimited (tau-only ILUT); hypre's lfil
    fill_level: int = 1    # candidate pattern = structure of A^(fill_level+1)
    refit_sweeps: int = 3

    def setup(self, A: EllMatrix, device=None) -> "ILUT":
        A = A.to(resolve_device(device))
        Ac = grow_pattern(A, self.fill_level) if self.fill_level > 0 else A
        F = chow_patel_sweeps(Ac, self.factor_sweeps)

        n, k = Ac.cols.shape
        cols = Ac.cols
        row_ids = _row_ids(Ac)
        valid = cols >= 0
        isdiag = cols == row_ids
        # tau relative to the ORIGINAL row 2-norm (the grown pattern's fill
        # slots carry 0, so the norm over Ac.vals is A's row norm)
        rownorm = torch.sqrt(
            torch.where(valid, Ac.vals * Ac.vals, _zero(F)).sum(dim=1))
        absF = torch.where(valid & ~isdiag, F.abs(), _zero(F))
        keep = absF >= self.drop_tol * rownorm[:, None]
        if self.max_row_nnz > 0:
            m = min(self.max_row_nnz, k)

            def topk_mask(v):
                srt = torch.sort(v, dim=1, descending=True).values
                thresh = srt[:, m - 1].clamp(min=1e-300)
                return v >= thresh[:, None]

            is_l = valid & (cols < row_ids)
            is_u_off = valid & (cols > row_ids)
            keep = (keep
                    & (topk_mask(torch.where(is_l, absF, _zero(F))) | ~is_l)
                    & (topk_mask(torch.where(is_u_off, absF, _zero(F)))
                       | ~is_u_off))
        keep = (keep | isdiag) & valid
        pad = torch.full_like(cols, PAD_COL)
        kept_cols = torch.where(keep, cols, pad)
        pruned = ell_filter(EllMatrix(
            vals=torch.where(keep, Ac.vals, _zero(F)), cols=kept_cols,
            n_cols=Ac.n_cols), keep)
        # the converged factor values go through the same compaction, so
        # the refit starts at the fixed point restricted to the pattern
        Fkept = ell_filter(EllMatrix(vals=torch.where(keep, F, _zero(F)),
                                     cols=kept_cols, n_cols=Ac.n_cols),
                           keep).vals
        width = max(int((pruned.cols >= 0).sum(dim=1).max()), 1)
        pruned = EllMatrix(vals=pruned.vals[:, :width].contiguous(),
                           cols=pruned.cols[:, :width].contiguous(),
                           n_cols=pruned.n_cols)
        F2 = chow_patel_sweeps(pruned, self.refit_sweeps,
                               F0=Fkept[:, :width].contiguous())
        self._split_factors(pruned, F2)
        return self


def grow_pattern(A: EllMatrix, level: int) -> EllMatrix:
    """A on the pattern of A^(level+1), zeros in the fill positions (the
    ILU(k) static pattern), columns ascending in each row.

    The pattern product is ``ell_spgemm`` of 0/1 values (the reference
    calls its C++ SpGEMM), and A's values are laid on it by a binary
    search of sorted (row, col) keys (the reference fills a dict, one
    entry at a time)."""
    ones = torch.where(A.cols >= 0, torch.ones_like(A.vals), _zero(A.vals))
    B = EllMatrix(vals=ones, cols=A.cols, n_cols=A.n_cols, shifts=A.shifts)
    P = B
    for _ in range(level):
        P = ell_spgemm(P, B)
    pcols, _ = sorted_rows(P.cols)
    width = max(int((pcols < 2**30).sum(dim=1).max()), 1)
    pcols = pcols[:, :width]
    valid = pcols < 2**30
    pcols = torch.where(valid, pcols, torch.full_like(pcols, PAD_COL))

    n, nc = A.n_rows, A.n_cols
    rows = torch.arange(n, dtype=torch.int64, device=A.device)[:, None]
    a_ok = A.cols >= 0
    akeys = (rows * nc + A.cols.long())[a_ok]
    skeys, order = torch.sort(akeys)
    svals = A.vals[a_ok][order]
    pkeys = (rows * nc + pcols.long()).reshape(-1)
    at = torch.searchsorted(skeys, pkeys).clamp(max=skeys.numel() - 1)
    hit = (skeys[at] == pkeys) & valid.reshape(-1)
    vals = torch.where(hit, svals[at], _zero(A.vals))
    return EllMatrix(vals=vals.reshape(n, width).contiguous(),
                     cols=pcols.contiguous(), n_cols=nc)
