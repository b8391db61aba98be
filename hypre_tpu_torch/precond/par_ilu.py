"""Distributed fine-grained ILU on row-sharded operators.

Counterpart of ``hypre_tpu/precond/par_ilu.py``, the parallel-ILU
analogue of hypre's Euclid (``distributed_ls/Euclid/Euclid_dh.c``):
Euclid factors across ranks by exchanging the *external rows* of the
factor along the subdomain graph. Here the Chow-Patel fixed point of
``precond/ilu.py`` is distributed with exactly that exchange:

- every sweep updates all local factor entries at once from the ILU
  fixed-point equations, with the neighbour rows' factor values fetched
  by ONE forward halo exchange over A's schedule
  (``parallel/par_setup.py::_fetch``, the ``hypre_ParCSRMatrixExtractBExt``
  idea applied to the factor);
- comparisons run on *global* column ids (the halo rows' global columns
  are fetched once, the pattern being static), so the iteration is the
  synchronous global Chow-Patel iteration and converges to the
  single-device ILU(0) fixed point;
- the apply is Jacobi-iterated triangular solves whose products are
  ``par_spmv`` on the L and strict-U factors, stored as ParEllMatrix over
  A's own halo schedule (the factor pattern is a subset of A's).

The shards this process holds are a batch axis, their extended column
spaces stacked (``par_setup._stacked``): one launch serves every shard.
Where the reference matches U(c_a, c_b) with an (n, k, k, k) one-hot
tensor, the port finds the slot once per setup by a binary search in the
neighbour row's sorted global columns (``precond/ilu.py::pair_index``).
Only ``comm.shift`` and the reductions are used, so both backends run it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hypre_tpu_torch.core.config import PAD_COL
from hypre_tpu_torch.parallel.par_ell import ParEllMatrix, par_spmv
from hypre_tpu_torch.parallel.par_setup import (
    _ext_matrix, _fetch, _global_cols, _stack, _stacked, par_from_global_cols,
)
from hypre_tpu_torch.precond.common import row_chunks
from hypre_tpu_torch.seq.slabops import merge_slab

_BIG = 2**30


@dataclasses.dataclass(frozen=True)
class ExtLayout:
    """Every held shard's extended rows, stacked (S * n rows): values and
    columns in A's slot order (diag, then offd), the stacked extended
    column of each slot, its global column (``_BIG`` where invalid), each
    row's global id, and the global id of every stacked extended
    position."""

    vals: torch.Tensor  # (S * n, k)
    sc: torch.Tensor  # (S * n, k) stacked extended column, -1 pad
    gcols: torch.Tensor  # (S * n, k) global column, _BIG pad
    grow: torch.Tensor  # (S * n,) global row id
    gmap: torch.Tensor  # (S * (n + M),) global id of each extended slot

    @property
    def valid(self) -> torch.Tensor:
        return self.sc >= 0

    @property
    def rsafe(self) -> torch.Tensor:
        return self.sc.clamp(min=0).long()


def ext_layout(A: ParEllMatrix) -> ExtLayout:
    vals, cols = _ext_matrix(A)
    S, n, k = cols.shape
    sc = _stacked(cols, A.n_col_local, A.recv_size).reshape(S * n, k)
    g = _global_cols(A).reshape(S * n, k)
    gcols = torch.where(g >= 0, g, torch.full_like(g, _BIG))
    ncl = A.n_col_local
    own = (torch.arange(ncl, device=A.device)[None, :]
           + A.mesh.comm.shard_ids(A.device)[:, None] * ncl).to(torch.int32)
    return ExtLayout(vals=vals.reshape(S * n, k), sc=sc, gcols=gcols,
                     grow=own.reshape(-1), gmap=_stack(own, _fetch(A, own)))


def fetch_rows(A: ParEllMatrix, rows: torch.Tensor) -> torch.Tensor:
    """Per-row payloads of the held shards (S * n, ...) -> the same over
    the stacked extended space, the halo rows fetched over A's schedule."""
    S, n = A.local_shards, A.n_col_local
    r = rows.reshape((S, n) + tuple(rows.shape[1:]))
    return _stack(r, _fetch(A, r))


def sorted_lookup(keys: torch.Tensor, vals: torch.Tensor):
    """Rows of (global column, value) pairs sorted by column for binary
    searches (``_BIG`` keys last)."""
    skey, perm = torch.sort(keys, dim=1, stable=True)
    return skey.contiguous(), torch.gather(vals, 1, perm)


def find_in_rows(skey: torch.Tensor, rows: torch.Tensor,
                 want: torch.Tensor) -> torch.Tensor:
    """Position in sorted row ``rows[...]`` of column ``want[..., :]``,
    flat (row * k + slot), or -1 where the row holds no such column.
    rows: (m, a); want: (m, a, w); returns (m, a, w)."""
    k = skey.shape[1]
    row_keys = skey[rows]  # (m, a, k)
    pos = torch.searchsorted(row_keys, want.contiguous()).clamp(max=k - 1)
    hit = (torch.gather(row_keys, 2, pos) == want) & (want < _BIG)
    flat = rows[:, :, None] * k + pos
    return torch.where(hit, flat, torch.full_like(flat, -1))


def _par_chow_patel(A: ParEllMatrix, sweeps: int):
    """Distributed Chow-Patel factorization. Returns (Fd, Fo, dinv,
    is_l_d, is_l_o, is_diag_d): factor values aligned with A's diag/offd
    slabs (S, n, kd) / (S, n, ko), the inverse diagonal of U (flat), and
    the global-order masks that split L from U."""
    lay = ext_layout(A)
    S, n, kd = A.diag_cols.shape
    k = lay.sc.shape[1]
    valid, rsafe, gcols = lay.valid, lay.rsafe, lay.gcols
    grow = lay.grow[:, None]
    is_l = valid & (gcols < grow)
    is_u = valid & (gcols >= grow)
    is_diag = valid & (gcols == grow)
    zero = torch.zeros((), dtype=lay.vals.dtype, device=lay.vals.device)

    # U(c_a, c_b): row c_a's slot holding column c_b, for c_b at or above
    # row c_a's diagonal and c_a < c_b (the sum's k < j range); the
    # pattern is static, so the slots are found once
    gcols_ext = fetch_rows(A, gcols)
    skey, sperm = torch.sort(gcols_ext, dim=1, stable=True)
    skey = skey.contiguous()
    pos = []
    for lo, hi in row_chunks(S * n, 8 * k * k):
        g = gcols[lo:hi]
        want = g[:, None, :].expand(-1, k, -1)
        p = find_in_rows(skey, rsafe[lo:hi], want)
        slot = sperm.reshape(-1)[p.clamp(min=0)]  # its slot in A's order
        flat = rsafe[lo:hi][:, :, None] * k + slot
        ok = ((p >= 0) & valid[lo:hi][:, :, None]
              & (g[:, None, :] >= lay.gmap[rsafe[lo:hi]][:, :, None])
              & (g[:, :, None] < g[:, None, :]))
        pos.append(torch.where(ok, flat, torch.full_like(flat, -1))
                   .to(torch.int32))
    pos = torch.cat(pos)
    chunks = row_chunks(S * n, 4 * k * k)

    F = torch.where(valid, lay.vals, zero)
    for _ in range(sweeps):
        F_ext = fetch_rows(A, F)
        flat = F_ext.reshape(-1)
        Lia = torch.where(is_l, F, zero)
        Ssum = []
        for lo, hi in chunks:
            p = pos[lo:hi].long()
            uab = torch.where(p >= 0, flat[p.clamp(min=0)], zero)
            Ssum.append((Lia[lo:hi, :, None] * uab).sum(dim=1))
        Ssum = torch.cat(Ssum)
        dU_ext = torch.where(gcols_ext == lay.gmap[:, None], F_ext,
                             zero).sum(dim=1)
        dU_col = dU_ext[rsafe]
        dU_col = torch.where(dU_col != 0, dU_col, torch.ones_like(dU_col))
        new = lay.vals - Ssum
        F = torch.where(is_u, new, torch.where(is_l, new / dU_col, zero))
    dU = torch.where(is_diag, F, zero).sum(dim=1)
    nz = dU != 0
    dinv = torch.where(nz, 1.0 / torch.where(nz, dU, torch.ones_like(dU)),
                       torch.ones_like(dU))
    F = F.reshape(S, n, k)
    is_l = is_l.reshape(S, n, k)
    return (F[..., :kd], F[..., kd:], dinv, is_l[..., :kd], is_l[..., kd:],
            is_diag.reshape(S, n, k)[..., :kd])


def _masked_par(A: ParEllMatrix, Fd, Fo, mask_d, mask_o) -> ParEllMatrix:
    """A ParEllMatrix holding the masked factor values over A's pattern
    and halo schedule (a subset of A's pattern: the CommPkg is reused)."""
    return dataclasses.replace(
        A,
        diag_vals=torch.where(mask_d, Fd, torch.zeros_like(Fd)),
        diag_cols=torch.where(mask_d, A.diag_cols,
                              torch.full_like(A.diag_cols, PAD_COL)),
        offd_vals=torch.where(mask_o, Fo, torch.zeros_like(Fo)),
        offd_cols=torch.where(mask_o, A.offd_cols,
                              torch.full_like(A.offd_cols, PAD_COL)))


def par_extend_pattern(A: ParEllMatrix, levels: int,
                       out_k: int | None = None) -> ParEllMatrix:
    """The ILU(k) envelope on a row-sharded operator: ``levels`` rounds of
    distributed symbolic neighbour union (each round ORs every row's
    pattern with its neighbour rows', fetched over the halo), fill
    positions carrying 0 — hypre's Euclid ILU(k) symbolic phase
    (``Euclid/ilu_seq.c``) as slab merges and one neighbour-row fetch."""
    for _ in range(levels):
        lay = ext_layout(A)
        S, n = A.local_shards, A.n_row_local
        kk = lay.sc.shape[1]
        ko = out_k or min(kk * kk + kk, 96)
        valid = lay.valid
        gcols = torch.where(valid, lay.gcols, torch.full_like(lay.gcols,
                                                              PAD_COL))
        nb = fetch_rows(A, gcols)[lay.rsafe].reshape(S * n, kk * kk)
        nb = torch.where(valid.repeat_interleave(kk, dim=1), nb,
                         torch.full_like(nb, PAD_COL))
        cand_c = torch.cat([gcols, nb], dim=1)
        cand_v = torch.cat([torch.where(valid, lay.vals,
                                        torch.zeros_like(lay.vals)),
                            lay.vals.new_zeros((S * n, kk * kk))], dim=1)
        mc, mv, req = merge_slab(cand_c, cand_v, ko)
        # the merge is left-aligned: past the widest row there is padding
        w = min(max(int(A.mesh.comm.max(req.reshape(1).to(
            torch.int32)).item()), 1), ko)
        A = par_from_global_cols(mc[:, :w].reshape(S, n, w),
                                 mv[:, :w].reshape(S, n, w),
                                 A.n_rows, A.n_cols, A.mesh)
    return A


def _apply_factors(L: ParEllMatrix, Us: ParEllMatrix, dinv: torch.Tensor,
                   sweeps: int):
    """M(r) ~ (LU)^{-1} r by Jacobi-iterated triangular solves on
    ``par_spmv`` of L and the strict upper factor."""

    def M(r):
        y = r
        for _ in range(sweeps):
            y = r - par_spmv(L, y)
        x = dinv * y
        for _ in range(sweeps):
            x = dinv * (y - par_spmv(Us, x))
        return x

    return M


@dataclasses.dataclass
class ParILU:
    """Distributed ILU(0) over a row-sharded ParEllMatrix: the working
    core behind ``Euclid``'s distributed path."""

    factor_sweeps: int = 8
    solve_sweeps: int = 6

    L: Optional[ParEllMatrix] = dataclasses.field(default=None, repr=False)
    Us: Optional[ParEllMatrix] = dataclasses.field(default=None, repr=False)
    dinv: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                     repr=False)

    def setup(self, A: ParEllMatrix) -> "ParILU":
        Fd, Fo, dinv, is_l_d, is_l_o, is_diag_d = _par_chow_patel(
            A, self.factor_sweeps)
        is_u_d = (A.diag_cols >= 0) & ~is_l_d & ~is_diag_d
        is_u_o = (A.offd_cols >= 0) & ~is_l_o
        self.L = _masked_par(A, Fd, Fo, is_l_d, is_l_o)
        self.Us = _masked_par(A, Fd, Fo, is_u_d, is_u_o)  # strict upper
        self.dinv = dinv
        return self

    def precond(self):
        if self.L is None:
            raise RuntimeError("call setup(A) first")
        return _apply_factors(self.L, self.Us, self.dinv, self.solve_sweeps)


def _par_global_cols(A: ParEllMatrix):
    """Global column ids aligned with A's diag/offd slabs (``_BIG`` where
    invalid): the shard-independent tie-break key of the truncation."""
    g = _global_cols(A)
    g = torch.where(g >= 0, g, torch.full_like(g, _BIG))
    kd = A.diag_cols.shape[2]
    return g[..., :kd], g[..., kd:]


def _ilut_keep(mag: torch.Tensor, gcols: torch.Tensor,
               side_mask: torch.Tensor, thr: torch.Tensor,
               p: int) -> torch.Tensor:
    """pilut's dual drop per row (``parilut.c``, ``ilut.c``): drop |v| <
    thr, then keep EXACTLY the ``p`` largest survivors, ties broken by
    global column id, so the choice depends on neither the slot order nor
    the shard count. Row-local sorts only."""
    ok = side_mask & (mag >= thr[..., None])
    if p >= mag.shape[-1]:
        return ok
    neg = torch.where(ok, -mag, torch.full_like(mag, float("inf")))
    gk = torch.where(ok, gcols, torch.full_like(gcols, _BIG))
    # lexicographic (neg, gk): a stable sort by the minor key, then by the
    # major one
    o1 = torch.sort(gk, dim=-1, stable=True).indices
    n1, g1 = torch.gather(neg, -1, o1), torch.gather(gk, -1, o1)
    o2 = torch.sort(n1, dim=-1, stable=True).indices
    s_neg, s_g = torch.gather(n1, -1, o2), torch.gather(g1, -1, o2)
    cut_neg = s_neg[..., p - 1: p]
    cut_g = s_g[..., p - 1: p]
    return ok & ((neg < cut_neg) | ((neg == cut_neg) & (gk <= cut_g)))


@dataclasses.dataclass
class ParILUT:
    """Distributed ILUT, the ``distributed_ls/pilut`` capability:
    drop-tolerance and factor-row-size fill control inside a distributed
    factorization, in three parallel stages: (1) the ILU(k) envelope by
    distributed symbolic neighbour union (``par_extend_pattern``), (2) the
    distributed Chow-Patel fixed point on it (``_par_chow_patel``), (3)
    pilut's dual drop on the converged factors: per row drop entries
    below ``drop_tolerance * ||a_i||_2`` (the original row's 2-norm) and
    keep at most ``factor_row_size`` per L/U side (``SetDropTolerance``,
    ``SetFactorRowSize``, ``HYPRE_DistributedMatrixPilutSolver.c``)."""

    fill_levels: int = 1
    drop_tolerance: float = 1e-4
    factor_row_size: int = 20
    factor_sweeps: int = 8
    solve_sweeps: int = 6

    L: Optional[ParEllMatrix] = dataclasses.field(default=None, repr=False)
    Us: Optional[ParEllMatrix] = dataclasses.field(default=None, repr=False)
    dinv: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                     repr=False)

    def setup(self, A: ParEllMatrix) -> "ParILUT":
        Ax = (par_extend_pattern(A, self.fill_levels)
              if self.fill_levels > 0 else A)
        Fd, Fo, dinv, is_l_d, is_l_o, is_diag_d = _par_chow_patel(
            Ax, self.factor_sweeps)
        is_u_d = (Ax.diag_cols >= 0) & ~is_l_d & ~is_diag_d
        is_u_o = (Ax.offd_cols >= 0) & ~is_l_o
        # the relative threshold against the ORIGINAL row 2-norm (fill
        # positions carry 0, so Ax's row norms are A's)
        rn = torch.sqrt((Ax.diag_vals ** 2).sum(dim=2)
                        + (Ax.offd_vals ** 2).sum(dim=2))
        thr = self.drop_tolerance * rn
        mag = torch.cat([Fd, Fo], dim=2).abs()
        gd, go = _par_global_cols(Ax)
        gcols = torch.cat([gd, go], dim=2)
        kd = Fd.shape[2]
        p = self.factor_row_size
        keep_l = _ilut_keep(mag, gcols, torch.cat([is_l_d, is_l_o], dim=2),
                            thr, p)
        keep_u = _ilut_keep(mag, gcols, torch.cat([is_u_d, is_u_o], dim=2),
                            thr, p)
        self.L = _masked_par(Ax, Fd, Fo, keep_l[..., :kd], keep_l[..., kd:])
        self.Us = _masked_par(Ax, Fd, Fo, keep_u[..., :kd], keep_u[..., kd:])
        self.dinv = dinv
        return self

    precond = ParILU.precond
