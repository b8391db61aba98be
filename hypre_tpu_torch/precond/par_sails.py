"""Distributed ParaSails on row-sharded operators.

Counterpart of ``hypre_tpu/precond/par_sails.py``. hypre's ParaSails
(``distributed_ls/ParaSails/ParaSails.c``) gathers the *remote rows* of A
along the pattern (``PrunedRows.c``) so that each rank forms and solves
its rows' least-squares problems locally. Here ONE forward halo exchange
ships the neighbour rows (values and global column ids) over A's
schedule, after which every local row's normal equations

    (A A^T)[J_i, J_i] m_i^T = A[i, J_i]^T,   J_i = pattern(row i)

assemble from pairwise row inner products matched on global column ids
(no A A^T is formed, no second exchange), and one batched dense solve
follows. The apply is one ``par_spmv`` with M over A's halo schedule.

``nlevels=1`` takes the pattern of thresh(A)^2 (ParaSails.c's pattern of
powers), which needs A's rows at graph distance 2: the second halo layer.
One exchange of the pruned pattern rows gives the symbolic square; the
pattern matrix M is then built through the CommPkg builder
(``par_from_global_cols``), whose new halo schedule reaches the
distance-2 owners, and a last exchange ships A's rows along it.

The reference matches row entries with a (k, k, k, k) one-hot tensor per
row; the port looks each column up by a binary search in the other row's
sorted global columns, in row chunks (``precond/common.py::row_chunks``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hypre_tpu_torch.parallel.par_ell import ParEllMatrix, par_spmv
from hypre_tpu_torch.parallel.par_setup import (
    _fetch, _stack, _stacked, par_from_global_cols,
)
from hypre_tpu_torch.precond.common import row_chunks
from hypre_tpu_torch.precond.par_ilu import (
    _BIG, ext_layout, fetch_rows, find_in_rows, sorted_lookup,
)
from hypre_tpu_torch.seq.slabops import merge_slab


def _prune_keep(A: ParEllMatrix, lay, thresh: float) -> torch.Tensor:
    """ParaSails.c's prune of the local pattern: keep the diagonal and
    every |a_ij| >= thresh sqrt(|a_ii a_jj|)."""
    valid = lay.valid
    if thresh <= 0.0:
        return valid
    zero = torch.zeros((), dtype=lay.vals.dtype, device=lay.vals.device)
    is_diag = lay.gcols == lay.grow[:, None]
    diag = torch.where(is_diag, lay.vals, zero).sum(dim=1)
    dj = torch.where(valid, fetch_rows(A, diag)[lay.rsafe].abs(),
                     torch.ones_like(lay.vals))
    return valid & (is_diag | (lay.vals.abs() >= thresh * torch.sqrt(
        diag.abs()[:, None] * dj)))


def _row_products(rows: torch.Tensor, rv: torch.Tensor, rg: torch.Tensor,
                  skey: torch.Tensor, svals: torch.Tensor,
                  row_ok: torch.Tensor) -> torch.Tensor:
    """N[i, a, b] = <row rows[i, a], row rows[i, b]>, matched on global
    columns: row b's entries (rv, rg: (m, kp, kA)) looked up in row a's
    sorted (skey, svals) rows. row_ok (m, kp) zeroes the rows left out."""
    m, kp, kA = rg.shape
    want = rg.reshape(m, 1, kp * kA).expand(m, kp, kp * kA)
    flat = find_in_rows(skey, rows, want)
    got = svals.reshape(-1)[flat.clamp(min=0)]
    zero = torch.zeros((), dtype=rv.dtype, device=rv.device)
    got = torch.where((flat >= 0) & row_ok[:, :, None], got, zero)
    return (got.reshape(m, kp, kp, kA) * rv[:, None, :, :]).sum(dim=3)


def _normal_solve(N: torch.Tensor, rhs: torch.Tensor, reg: float,
                  ok: torch.Tensor) -> torch.Tensor:
    k = N.shape[-1]
    N = N + reg * torch.eye(k, dtype=N.dtype, device=N.device)
    m = torch.linalg.solve(N, rhs[..., None])[..., 0]
    return torch.where(ok, m, torch.zeros_like(m))


def _par_sails_rows(A: ParEllMatrix, thresh: float, reg: float):
    """Level-0 least-squares rows on the pruned pattern of A. Returns
    (md, mo, keep_d, keep_o) aligned with A's diag/offd slabs."""
    lay = ext_layout(A)
    S, n, kd = A.diag_cols.shape
    k = lay.sc.shape[1]
    keep = _prune_keep(A, lay, thresh)
    zero = torch.zeros((), dtype=lay.vals.dtype, device=lay.vals.device)
    ev = fetch_rows(A, lay.vals)
    eg = fetch_rows(A, lay.gcols)
    skey, svals = sorted_lookup(eg, ev)
    out = []
    for lo, hi in row_chunks(S * n, 2 * k * k * k):
        rows = lay.rsafe[lo:hi]
        kp = keep[lo:hi]
        rv = torch.where(kp[:, :, None], ev[rows], zero)
        N = _row_products(rows, rv, eg[rows], skey, svals, kp)
        rhs = torch.where(kp, lay.vals[lo:hi], zero)
        out.append(_normal_solve(N, rhs, reg, kp))
    m = torch.cat(out).reshape(S, n, k)
    keep = keep.reshape(S, n, k)
    return m[..., :kd], m[..., kd:], keep[..., :kd], keep[..., kd:]


def _power_pattern_cols(A: ParEllMatrix, thresh: float, cap: int):
    """Global-column slabs of the level-1 pattern, pattern(thresh(A))^2:
    one exchange of the pruned pattern rows, then a per-row merge of the
    neighbours' patterns (PrunedRows.c's expansion). Returns the (S, n,
    cap) global columns and the width the merge needed (max over the
    mesh)."""
    lay = ext_layout(A)
    S, n = A.local_shards, A.n_row_local
    k = lay.sc.shape[1]
    keep = _prune_keep(A, lay, thresh)
    minus = torch.full_like(lay.gcols, -1)
    pat = torch.where(keep, lay.gcols, minus)
    nb = fetch_rows(A, pat)[lay.rsafe]
    nb = torch.where(keep[:, :, None], nb, torch.full_like(nb, -1))
    cand = torch.cat([pat, nb.reshape(S * n, k * k)], dim=1)
    c2, _, req = merge_slab(cand, lay.vals.new_zeros(cand.shape), cap)
    req = int(A.mesh.comm.max(req.reshape(1).to(torch.int32)).item())
    # the merge is left-aligned: past the widest row there is padding
    c2 = c2[:, :max(min(req, cap), 1)]
    return c2.reshape(S, n, -1), req


def _par_sails_power_rows(A: ParEllMatrix, Mp: ParEllMatrix, reg: float):
    """Least-squares rows over an expanded pattern matrix Mp, whose halo
    schedule reaches the distance-2 owners: A's rows (values, global
    columns) go along Mp's schedule, then every local row's normal
    equations (A A^T)[J_i, J_i] m_i^T = A[i, J_i]^T, J_i = pattern(Mp
    row i), are assembled and solved."""
    lay = ext_layout(A)
    S, n = A.local_shards, A.n_row_local
    kA = lay.sc.shape[1]
    a_valid = lay.valid
    a_g = lay.gcols  # _BIG where invalid
    zero = torch.zeros((), dtype=lay.vals.dtype, device=lay.vals.device)

    def along_m(rows):
        r = rows.reshape((S, n) + tuple(rows.shape[1:]))
        return _stack(r, _fetch(Mp, r))

    ev = along_m(lay.vals)
    eg = along_m(a_g)
    skey, svals = sorted_lookup(eg, ev)

    mcols = torch.cat([Mp.diag_cols, torch.where(
        Mp.offd_cols >= 0, Mp.offd_cols + Mp.n_col_local,
        torch.full_like(Mp.offd_cols, -1))], dim=2)
    k2 = mcols.shape[2]
    msc = _stacked(mcols, Mp.n_col_local, Mp.recv_size).reshape(S * n, k2)
    m_valid = msc >= 0
    msafe = msc.clamp(min=0).long()
    own = lay.grow.reshape(S, n)
    m_gmap = _stack(own, _fetch(Mp, own))
    m_g = torch.where(m_valid, m_gmap[msafe], torch.full_like(msc, _BIG))
    out = []
    for lo, hi in row_chunks(S * n, 2 * k2 * k2 * kA):
        rows = msafe[lo:hi]
        ok = m_valid[lo:hi]
        rv = torch.where(ok[:, :, None], ev[rows], zero)
        rg = torch.where(ok[:, :, None], eg[rows],
                         torch.full_like(eg[rows], _BIG))
        N = _row_products(rows, rv, rg, skey, svals, ok)
        # rhs[a] = A[i, j_a]: row i's own entries matched on the pattern
        match = (a_g[lo:hi][:, None, :] == m_g[lo:hi][:, :, None]) \
            & a_valid[lo:hi][:, None, :]
        rhs = torch.where(match, lay.vals[lo:hi][:, None, :], zero).sum(2)
        out.append(_normal_solve(N, rhs, reg, ok))
    m = torch.cat(out).reshape(S, n, k2)
    kd = Mp.diag_cols.shape[2]
    return m[..., :kd], m[..., kd:]


@dataclasses.dataclass
class ParSails:
    """Distributed sparse approximate inverse: the working core behind
    ``ParaSails`` on a ParEllMatrix.

    nlevels 0: the pattern of thresh(A); 1: that of thresh(A)^2 through
    the second halo layer (ParaSails.c, PrunedRows.c). filter: drop
    |m_ij| < filter * max_j |m_ij| after the solve (hypre's ParaSails
    filter), the diagonal always kept."""

    thresh: float = 0.0
    reg: float = 1e-10
    nlevels: int = 0
    filter: float = 0.0
    pattern_cap: int = 64

    M: Optional[ParEllMatrix] = dataclasses.field(default=None, repr=False)

    def setup(self, A: ParEllMatrix) -> "ParSails":
        if self.nlevels >= 1:
            cap = self.pattern_cap
            for _ in range(4):
                c2, req = _power_pattern_cols(A, self.thresh, cap)
                if req <= cap:
                    break
                cap = int(req)
            Mp = par_from_global_cols(c2, A.diag_vals.new_zeros(c2.shape),
                                      A.n_rows, A.n_cols, A.mesh)
            md, mo = _par_sails_power_rows(A, Mp, self.reg)
            self.M = dataclasses.replace(Mp, diag_vals=md, offd_vals=mo)
        else:
            md, mo, kd, ko = _par_sails_rows(A, self.thresh, self.reg)
            self.M = dataclasses.replace(
                A,
                diag_vals=torch.where(kd, md, torch.zeros_like(md)),
                diag_cols=torch.where(kd, A.diag_cols,
                                      torch.full_like(A.diag_cols, -1)),
                offd_vals=torch.where(ko, mo, torch.zeros_like(mo)),
                offd_cols=torch.where(ko, A.offd_cols,
                                      torch.full_like(A.offd_cols, -1)))
        if self.filter > 0.0:
            self.M = self._filtered(self.M)
        return self

    def _filtered(self, M: ParEllMatrix) -> ParEllMatrix:
        mx = M.diag_vals.abs().amax(dim=2)
        if M.offd_vals.shape[2]:
            mx = torch.maximum(mx, M.offd_vals.abs().amax(dim=2))
        # diag_cols hold shard-local columns: the diagonal of local row r
        # sits at local column r
        rows = torch.arange(M.n_row_local, device=M.device)
        is_diag = M.diag_cols == rows[None, :, None]
        cut = self.filter * mx[..., None]
        keep_d = is_diag | (M.diag_vals.abs() >= cut)
        keep_o = M.offd_vals.abs() >= cut
        return dataclasses.replace(
            M,
            diag_vals=torch.where(keep_d, M.diag_vals,
                                  torch.zeros_like(M.diag_vals)),
            offd_vals=torch.where(keep_o, M.offd_vals,
                                  torch.zeros_like(M.offd_vals)))

    def precond(self):
        M = self.M
        if M is None:
            raise RuntimeError("call setup(A) first")
        return lambda r: par_spmv(M, r)
