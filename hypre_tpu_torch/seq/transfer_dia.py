"""TransferDia — stencil-structured interpolation as fine-space diagonals.

Counterpart of ``hypre_tpu/seq/transfer_dia.py``. The interpolation built on
a stencil level reaches only C points within graph distance <= 2, so in
FINE indexing P is a generalized stencil: its column offsets (fine index of
the C point minus the row index) come from the distance-2 offset set of the
grid. Both transfer products then run through the DIA kernels:

    prolong  u += P e_c  =  DIA(P_fine) . expand(e_c)
    restrict r_c = P^T r =  compress( DIA(P_fine^T) . r )

where ``expand`` scatters the coarse vector to the C-point positions and
``compress`` reads it back: both are monotone selections, run by the banded
gather kernel on width-1 patterns. The diagonal slabs hold zeros where a
row has fewer entries than there are diagonals, so the format trades
storage (D values per fine row) for streams without column indices. The
reference chose it because its device has no gather; whether it beats the
banded route on a card that gathers well is measured, not assumed (see
PERF.md).
"""

from __future__ import annotations

import dataclasses

import torch

from hypre_tpu_torch.core.config import fold_sum, host_tensor, tensors_to
from hypre_tpu_torch.seq.dia import DiaMatrix, _margin_for, _shift1d
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.fastmv import (
    BandedEll, _payload_impl, _sched_impl, _wbucket, _xpad_bucket,
    banded_spmv, try_banded,
)

_C_PT = 1  # coarsen.py / device_setup.py C-point marker
_BIG = 2**30


@dataclasses.dataclass(frozen=True)
class TransferDia:
    """P (n_fine x n_coarse) as fine-space diagonals + selections."""

    P_dia: DiaMatrix  # fine-space forward diagonals
    Pt_dia: DiaMatrix  # fine-space transpose diagonals
    expand: BandedEll  # (n_fine, n_coarse) C-point expansion selection
    compress: BandedEll  # (n_coarse, n_fine) C-point restriction selection
    n_coarse_s: int

    @property
    def n_rows(self) -> int:
        return self.P_dia.n_rows

    @property
    def n_cols(self) -> int:
        return self.n_coarse_s

    @property
    def shape(self):
        return (self.n_rows, self.n_coarse_s)

    @property
    def dtype(self):
        return self.P_dia.dtype

    @property
    def device(self) -> torch.device:
        return self.P_dia.device

    @property
    def vec_len_rows(self) -> int:
        return self.n_rows

    @property
    def vec_len_cols(self) -> int:
        return self.n_coarse_s

    def to(self, device) -> "TransferDia":
        return tensors_to(self, device)

    def mv(self, ec: torch.Tensor) -> torch.Tensor:
        """fine = P @ coarse (prolongation)."""
        return self.P_dia.mv(banded_spmv(self.expand, ec))

    def mv_t(self, r: torch.Tensor) -> torch.Tensor:
        """coarse = P^T @ fine (restriction)."""
        return banded_spmv(self.compress, self.Pt_dia.mv(r))


def _c2f_from_cf(cf: torch.Tensor, nc: int) -> torch.Tensor:
    """Fine rows of the C points in coarse order, padded to ``nc`` entries
    with the sentinel 2^30 (coarse rows beyond the true C count). One
    scatter by the C points' coarse ids, no read-back: C points past
    ``nc`` and the F points land in one spare slot that is cut off."""
    is_c = cf == _C_PT
    idx = torch.cumsum(is_c.to(torch.int32), dim=0, dtype=torch.int32) - 1
    dest = torch.where(is_c & (idx < nc), idx, nc).long()
    rows = torch.arange(cf.shape[0], dtype=torch.int32, device=cf.device)
    out = torch.full((nc + 1,), _BIG, dtype=torch.int32, device=cf.device)
    return out.scatter_(0, dest, rows)[:nc]


def _fine_diffs(pc: torch.Tensor, c2f: torch.Tensor):
    """(valid, fine column minus row) of every slot of P."""
    n = pc.shape[0]
    valid = pc >= 0
    pf = torch.where(valid, c2f[pc.clamp(min=0).long()], 0)
    rows = torch.arange(n, dtype=torch.int32, device=pc.device)[:, None]
    return valid, pf - rows


def _distinct_offsets(pc, c2f, max_offsets: int):
    """Sorted distinct fine-space offsets of P as a host tuple, or None
    when there are more than ``max_offsets``. One read-back."""
    uniq = probe_offsets_device(pc, c2f, max_offsets + 1).cpu().tolist()
    offs = tuple(int(o) for o in uniq if o < _BIG)
    return None if len(offs) > max_offsets else offs


PROBE_SLOTS = 97


def probe_offsets_device(pc, c2f, slots: int = PROBE_SLOTS) -> torch.Tensor:
    """The sorted distinct fine-space offsets of P in a (slots,) int32
    device tensor, the sentinel 2^30 after the last one (the reference's
    ``_probe_offsets_jit``). A sort and a scatter by rank, no read-back:
    more than ``slots`` offsets leave no sentinel."""
    valid, diff = _fine_diffs(pc, c2f)
    s_ = torch.sort(torch.where(valid, diff, _BIG).reshape(-1))[0]
    is_new = torch.ones_like(s_, dtype=torch.bool)
    is_new[1:] = s_[1:] != s_[:-1]
    is_new &= s_ < _BIG
    rank = torch.cumsum(is_new.to(torch.int32), dim=0, dtype=torch.int32) - 1
    dest = torch.where(is_new & (rank < slots), rank, slots).long()
    out = torch.full((slots + 1,), _BIG, dtype=torch.int32, device=pc.device)
    return out.scatter_(0, dest, s_.to(torch.int32))[:slots]


def probe_transfer_offsets(pc, cf, nc: int, max_offsets: int = 96):
    """Distinct fine-space diagonal offsets of P (column slab ``pc``, CF
    split ``cf``, ``nc`` coarse columns), or None if there are more than
    ``max_offsets``. One small read-back."""
    return _distinct_offsets(pc, _c2f_from_cf(cf, nc), max_offsets)


def _planes_scatter(pc, pv, c2f, offs_p, D: int):
    """Diagonal planes of P by one scatter-add over offset ids, every slot
    taking part (no mask, so no read-back): a missed or invalid slot adds
    0. A row holds each column once, so each (plane, row) gets at most one
    value and the added zeros change nothing."""
    n, k = pc.shape
    dev = pc.device
    offs_arr = host_tensor(list(offs_p), torch.int32, dev)
    valid, diff = _fine_diffs(pc, c2f)
    oid = torch.searchsorted(offs_arr, diff.contiguous()).clamp(0, D - 1)
    hit = valid & (offs_arr[oid] == diff)
    rows = torch.arange(n, device=dev)[:, None].expand(n, k)
    dvals = torch.zeros((D, n), dtype=pv.dtype, device=dev)
    return dvals.index_put_((oid, rows), torch.where(hit, pv, 0.0),
                            accumulate=True)


def _transpose_planes(dvals, offs):
    """Planes of P_fine^T: plane d shifted by -offs[d], zero fill."""
    return torch.stack([_shift1d(dvals[d], -int(o))
                        for d, o in enumerate(offs)])


def _pad_to(x, m: int, fill):
    r = x.shape[0]
    if r == m:
        return x
    return torch.cat([x, x.new_full((m - r,) + tuple(x.shape[1:]), fill)])


def build_transfer_dia(P, cf, offs, exact: int = 0,
                       max_window: int = 131072, known_windows=None):
    """TransferDia from P, the CF split and P's fine-space offsets
    (``probe_transfer_offsets``), or None when a selection's window
    exceeds ``max_window``.

    ``offs`` must cover P's pattern. The offset COUNT is padded to a bucket
    of the setup's width ladder by repeating the last offset (the scatter
    resolves duplicates to the first slot, so padded planes stay zero).
    Selection blocks: ``expand`` gathers from the coarse vector in blocks
    of 8192 rows, ``compress`` from the fine vector in blocks of 2048, as
    in the reference.

    known_windows = (W_e, xe, W_c, xc): the selections' window widths and
    padded lengths recorded by an earlier setup (the device setup's
    replay). Nothing is read back then, and the result is ``(T, sc)``,
    ``sc`` the four schedule scalars (expand's window and start, then
    compress's) as a device tensor for the caller's deferred check.
    """
    from hypre_tpu_torch.amg.device_setup import _bucket

    if not isinstance(P, EllMatrix) or P.k < 1 or offs is None:
        return None
    n, nc = P.n_rows, P.n_cols
    dtype = P.dtype
    B_e, B_c = 8192, 2048
    D = _bucket(len(offs))
    offs_p = tuple(offs) + (offs[-1],) * (D - len(offs))
    margin = _margin_for(offs_p, n)
    c2f = _c2f_from_cf(cf, nc)
    dvals = _planes_scatter(P.cols, P.vals, c2f, offs_p, D)
    dvalsT = _transpose_planes(dvals, offs_p)

    is_c_row = cf == _C_PT
    cmap_dense = torch.cumsum(is_c_row.to(torch.int32), dim=0,
                              dtype=torch.int32) - 1
    e_vals = is_c_row.to(dtype)[:, None]
    e_cols = torch.where(is_c_row, cmap_dense, -1).to(torch.int32)[:, None]
    # coarse rows beyond the true C count (bucket padding) carry the
    # sentinel: they become empty selection rows
    c_valid = c2f < _BIG
    c_cols = torch.where(c_valid, c2f, -1).to(torch.int32)[:, None]
    c_vals = c_valid.to(dtype)[:, None]

    n_pad_e = -(-n // B_e) * B_e
    n_pad_c = -(-nc // B_c) * B_c
    e_cols_p, e_vals_p = _pad_to(e_cols, n_pad_e, -1), \
        _pad_to(e_vals, n_pad_e, 0)
    c_cols_p, c_vals_p = _pad_to(c_cols, n_pad_c, -1), \
        _pad_to(c_vals, n_pad_c, 0)
    lo_e, sc_e = _sched_impl(e_cols_p, B_e, n_pad_e)
    ev_t, el_t = _payload_impl(e_vals_p, e_cols_p, lo_e, B_e)
    lo_c, sc_c = _sched_impl(c_cols_p, B_c, n_pad_c)
    cv_t, cl_t = _payload_impl(c_vals_p, c_cols_p, lo_c, B_c)
    sc = torch.cat([sc_e, sc_c])
    if known_windows is not None:
        W_e, xe, W_c, xc = (int(v) for v in known_windows)
    else:
        W_e, xe, W_c, xc = windows_of(sc.cpu().tolist(), n, nc)
        if W_e > max_window or W_c > max_window:
            return None
    P_dia = DiaMatrix(dvals=dvals, offsets=offs_p, n_cols=n, margin=margin)
    Pt_dia = DiaMatrix(dvals=dvalsT, offsets=tuple(-o for o in offs_p),
                       n_cols=n, margin=margin)
    Eb = BandedEll(
        ell=EllMatrix(vals=e_vals, cols=e_cols, n_cols=nc),
        vals_t=ev_t, lcols_t=el_t, starts=lo_e, W=W_e, B=B_e, n_xpad=xe,
        exact=exact, n_rows_s=n, n_cols_s=nc)
    Cb = BandedEll(
        ell=EllMatrix(vals=c_vals, cols=c_cols, n_cols=n),
        vals_t=cv_t, lcols_t=cl_t, starts=lo_c, W=W_c, B=B_c, n_xpad=xc,
        exact=exact, n_rows_s=nc, n_cols_s=n)
    T = TransferDia(P_dia=P_dia, Pt_dia=Pt_dia, expand=Eb, compress=Cb,
                    n_coarse_s=nc)
    return T if known_windows is None else (T, sc)


def windows_of(sc, n: int, nc: int) -> tuple:
    """(W_e, xe, W_c, xc) that ``build_transfer_dia`` derives from the
    four schedule scalars ``sc`` (host ints) of a P with ``n`` rows and
    ``nc`` columns."""
    wm_e, lm_e, wm_c, lm_c = (int(v) for v in sc)
    W_e, W_c = _wbucket(wm_e), _wbucket(wm_c)
    return (W_e, _xpad_bucket(max(lm_e + W_e, nc)),
            W_c, _xpad_bucket(max(lm_c + W_c, n)))


def try_transfer_dia(P, c2f, max_offsets: int = 96, exact: int = 0):
    """Build the fine-space transfer operators, or None if P's pattern
    needs more than ``max_offsets`` distinct fine-space diagonals (or P is
    not float32, which the banded selections need).

    ``c2f`` (n_coarse,) maps coarse ids to their C-point fine rows. The
    planes are masked sums over the slots, one sweep per offset; the
    selections go through ``try_banded`` with its default blocks.
    """
    if not isinstance(P, EllMatrix) or P.k < 1:
        return None
    n, n_c = P.n_rows, P.n_cols
    c2f = c2f.to(torch.int32)
    offs = _distinct_offsets(P.cols, c2f, max_offsets)
    if offs is None:
        return None
    valid, diff = _fine_diffs(P.cols, c2f)
    zero = torch.zeros_like(P.vals)
    dvals = torch.stack([
        fold_sum(torch.where(valid & (diff == o), P.vals, zero))
        for o in offs])
    dvalsT = _transpose_planes(dvals, offs)
    P_dia = DiaMatrix(dvals=dvals, offsets=offs, n_cols=n)
    Pt_dia = DiaMatrix(dvals=dvalsT, offsets=tuple(-o for o in offs),
                       n_cols=n)
    is_c_row = torch.zeros(n, dtype=torch.bool, device=P.device)
    is_c_row[c2f.long()] = True
    cmap_dense = torch.cumsum(is_c_row.to(torch.int32), dim=0,
                              dtype=torch.int32) - 1
    E = EllMatrix(vals=is_c_row.to(P.dtype)[:, None],
                  cols=torch.where(is_c_row, cmap_dense, -1)
                  .to(torch.int32)[:, None], n_cols=n_c)
    C = EllMatrix(vals=torch.ones((n_c, 1), dtype=P.dtype, device=P.device),
                  cols=c2f[:, None], n_cols=n)
    Eb = try_banded(E, exact=exact)
    Cb = try_banded(C, exact=exact)
    if Eb is None or Cb is None:
        return None
    return TransferDia(P_dia=P_dia, Pt_dia=Pt_dia, expand=Eb, compress=Cb,
                       n_coarse_s=n_c)
