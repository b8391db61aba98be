"""BandedEll — windowed-gather SpMV for scattered (AMG coarse) matrices.

Counterpart of ``hypre_tpu/seq/fastmv.py``. AMG coarse operators and
interpolation matrices do not decompose into diagonals, but they stay
banded: a block of B=1024 consecutive rows touches a bounded window of x.
``try_banded`` builds, on the device, the per-block window starts and a
slot-major copy of the matrix: ``vals_t`` and ``lcols_t`` of shape
(k, n_pad), with columns relative to the block's window start. Those are
the operands of

- kernel 3, the gather ``y[r] = sum_s vals_t[s,r] * x[starts[r//B] +
  lcols_t[s,r]]`` (``csrc/banded_spmv.cu``, replacing the reference's
  ``_spmv_kernel``), which carries the coarse ``A.mv`` and ``P.mv``;
- kernel 4, the transpose product ``y = A^T r`` (replacing
  ``_spmv_t_kernel``), which carries restriction on Galerkin levels. It
  reads a transpose schedule that ``with_transpose_schedule`` builds once
  per operator from the same payload: the nonzeros sorted by destination
  column, so that every output is summed in a fixed order and written
  once.

On a CUDA tensor the wrappers launch the kernels; on a CPU tensor they run
the plain PyTorch versions below, computed from the same operands.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hypre_tpu_torch import kernels
from hypre_tpu_torch.core.config import tensors_to
from hypre_tpu_torch.seq.ell import EllMatrix

ALIGN = 1024  # window starts are multiples of this (kept from the reference)
# nonzeros of the transpose schedule per thread block of kernel 4; a block
# stages up to twice as many products in shared memory (16 KB)
T_CHUNK = 2048


def _wbucket(w: int) -> int:
    """Window-size bucket ({1, 1.5} x 2^k, ALIGN multiples), as the
    reference computes it; ``try_banded`` rejects matrices whose bucket
    exceeds ``max_window``."""
    b = ALIGN
    while b < w:
        half = 3 * b // 2
        if half >= w and half % ALIGN == 0:
            return half
        b *= 2
    return b


def _xpad_bucket(m: int) -> int:
    """Padded-x length bucket (same ladder, ALIGN multiples)."""
    return _wbucket(m)


@dataclasses.dataclass(frozen=True)
class BandedEll:
    """ELL matrix + per-block window schedule for the banded kernels.

    ell: the original matrix (structural queries), None once dropped.
    vals_t/lcols_t: (k, n_pad) slot-major copies; lcols are relative to
    the row block's window start. starts: (n_pad/B,) int32 window starts.
    W, n_xpad: the reference's window and padded-x buckets, kept for
    parity; the CUDA kernel reads x in place and needs neither.
    exact: kept for signature parity. The reference picks how x is rounded
    through bf16 on the TPU's matrix unit; the port always gathers in
    exact float32, which is the reference's ``exact=2``.
    t_vals/t_rows/t_colptr/t_chunks/t_cap: the transpose schedule that
    ``mv_t`` needs (``with_transpose_schedule``), None until it is built.
    t_vals and t_rows hold the nonzeros' values and source rows sorted by
    destination column (stable in (row, slot)), zero-padded to a multiple
    of 4; t_colptr (n_cols + 1,) points at each column's segment; t_chunks
    lists the first column of every thread block's chunk, which starts
    inside one run of t_cap nonzeros and of t_cap columns.
    """

    ell: "EllMatrix | None"
    vals_t: torch.Tensor
    lcols_t: torch.Tensor
    starts: torch.Tensor
    W: int
    B: int
    n_xpad: int
    exact: int = 1
    n_rows_s: int = 0
    n_cols_s: int = 0
    t_vals: "torch.Tensor | None" = None
    t_rows: "torch.Tensor | None" = None
    t_colptr: "torch.Tensor | None" = None
    t_chunks: "torch.Tensor | None" = None
    t_cap: int = 0

    # -- operator protocol -----------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.n_rows_s

    @property
    def n_cols(self) -> int:
        return self.n_cols_s

    @property
    def shape(self):
        return (self.n_rows_s, self.n_cols_s)

    @property
    def dtype(self):
        return self.vals_t.dtype

    @property
    def device(self) -> torch.device:
        return self.vals_t.device

    @property
    def vec_len_rows(self) -> int:
        return self.n_rows_s

    @property
    def vec_len_cols(self) -> int:
        return self.n_cols_s

    def to(self, device) -> "BandedEll":
        return tensors_to(self, device)

    def drop_ell(self) -> "BandedEll":
        """Shed the duplicate ELL payload (halves the operator's memory);
        structural queries become unavailable."""
        return dataclasses.replace(self, ell=None)

    def _need_ell(self):
        if self.ell is None:
            raise ValueError(
                "this BandedEll dropped its ELL payload (drop_ell); the "
                "requested operation needs the generic representation"
            )
        return self.ell

    def diagonal(self):
        return self._need_ell().diagonal()

    def row_sums(self):
        return self._need_ell().row_sums()

    def abs_row_sums(self):
        return self._need_ell().abs_row_sums()

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return banded_spmv(self, x)

    def mv_t(self, x: torch.Tensor) -> torch.Tensor:
        return banded_spmv_t(self, x)

    def _masked_apply(self, x: torch.Tensor, sign: int) -> torch.Tensor:
        """The gather's plain version restricted to the slots whose global
        column lies on one side of the row: read from the slot-major
        payload, so it needs no ELL copy. Padding slots point inside the
        window and carry 0."""
        k, n_pad = self.vals_t.shape
        base = _row_base(self.starts, self.B, n_pad)
        rows = torch.arange(n_pad, dtype=torch.int64, device=x.device)
        y = torch.zeros(n_pad, dtype=x.dtype, device=x.device)
        for s in range(k):
            j = base + self.lcols_t[s].to(torch.int64)
            keep = (j - rows) * sign > 0
            g = x[j.clamp(0, max(x.shape[0] - 1, 0))]
            y = y + torch.where(keep, self.vals_t[s],
                                torch.zeros_like(self.vals_t[s])) * g
        return y[: self.n_rows]

    def lower_apply(self, x: torch.Tensor) -> torch.Tensor:
        """L x, L the strict lower triangle (two-stage Gauss-Seidel)."""
        return self._masked_apply(x, -1)

    def upper_apply(self, x: torch.Tensor) -> torch.Tensor:
        """U x, U the strict upper triangle."""
        return self._masked_apply(x, 1)


# ---------------------------------------------------------------------------
# Kernels 3 and 4 and their plain versions
# ---------------------------------------------------------------------------


def _row_base(starts: torch.Tensor, B: int, n_pad: int) -> torch.Tensor:
    return starts.to(torch.int64).repeat_interleave(B)[:n_pad]


def banded_spmv_plain(vals_t, lcols_t, starts, x, n_rows: int,
                      B: int) -> torch.Tensor:
    """Plain version of the gather kernel: slot by slot, same order."""
    k, n_pad = vals_t.shape
    base = _row_base(starts, B, n_pad)
    n_x = x.shape[0]
    y = None
    for s in range(k):
        j = base + lcols_t[s].to(torch.int64)
        inside = (j >= 0) & (j < n_x)
        g = torch.where(inside, x[j.clamp(0, max(n_x - 1, 0))],
                        torch.zeros((), dtype=x.dtype, device=x.device))
        term = vals_t[s] * g
        y = term if y is None else y + term
    if y is None:
        return torch.zeros(n_rows, dtype=x.dtype, device=x.device)
    return y[:n_rows]


def banded_spmv_t_plain(t_vals, t_rows, t_colptr, r) -> torch.Tensor:
    """Plain version of the transpose kernel, from the same schedule: the
    products in destination order, each column's segment summed by
    ``torch.segment_reduce`` (left to right on the CPU; in its own fixed
    order on the card). Columns without a nonzero give 0."""
    n_out = t_colptr.shape[0] - 1
    n_slots = t_vals.shape[0]
    if n_slots == 0 or n_out == 0:
        return torch.zeros(n_out, dtype=r.dtype, device=r.device)
    prod = t_vals * r[t_rows.to(torch.int64)]
    # the padding behind the last nonzero goes into one more segment
    offsets = torch.cat([t_colptr.to(torch.int64),
                         t_colptr.new_full((1,), n_slots, dtype=torch.int64)])
    return torch.segment_reduce(prod, "sum", offsets=offsets,
                                unsafe=True)[:n_out]


def _check_banded(A: BandedEll, vec: torch.Tensor, n_vec: int, name: str):
    k, n_pad = A.vals_t.shape
    dev = vec.device
    kernels.require(vec, name, torch.float32, (n_vec,), dev)
    kernels.require(A.vals_t, "vals_t", torch.float32, (k, n_pad), dev)
    kernels.require(A.lcols_t, "lcols_t", torch.int32, (k, n_pad), dev)
    kernels.require(A.starts, "starts", torch.int32, (n_pad // A.B,), dev)
    if n_pad % A.B or A.n_rows > n_pad:
        raise ValueError(f"payload width {n_pad} does not fit B={A.B}, "
                         f"n_rows={A.n_rows}")


def _check_schedule(A: BandedEll, r: torch.Tensor):
    dev = r.device
    n_slots = A.t_vals.shape[0]
    kernels.require(r, "r", torch.float32, (A.n_rows,), dev)
    kernels.require(A.t_vals, "t_vals", torch.float32, (n_slots,), dev)
    kernels.require(A.t_rows, "t_rows", torch.int32, (n_slots,), dev)
    kernels.require(A.t_colptr, "t_colptr", torch.int32, (A.n_cols + 1,),
                    dev)
    kernels.require(A.t_chunks, "t_chunks", torch.int32,
                    (A.t_chunks.shape[0],), dev)
    if n_slots % 4 or A.t_vals.data_ptr() % 16 or A.t_rows.data_ptr() % 16:
        raise ValueError("t_vals and t_rows must be 16-byte aligned and "
                         "padded to a multiple of 4 entries")
    # the kernel stages 2 * t_cap products in shared memory, of which a
    # block gets 48 KB without asking for more
    if A.t_cap < 8 or A.t_cap % 4 or 2 * A.t_cap * 4 > 48 * 1024:
        raise ValueError(f"t_cap={A.t_cap} is not a multiple of 4 in "
                         "[8, 6144]")
    if A.t_chunks.shape[0] < 2:
        raise ValueError("t_chunks must hold at least one chunk")


def banded_spmv(A: BandedEll, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: the kernel that replaces
    ``hypre_tpu/seq/fastmv.py::_spmv_kernel`` on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.shape[0] != A.n_cols:
        raise ValueError(f"shape mismatch: {A.shape} @ {tuple(x.shape)}")
    if not x.is_cuda:
        return banded_spmv_plain(A.vals_t, A.lcols_t, A.starts, x, A.n_rows,
                                 A.B)
    _check_banded(A, x, A.n_cols, "x")
    k, n_pad = A.vals_t.shape
    y = torch.empty(A.n_rows, dtype=torch.float32, device=x.device)
    err = kernels.library("banded_spmv").hypre_banded_spmv(
        A.vals_t.data_ptr(), A.lcols_t.data_ptr(), A.starts.data_ptr(),
        x.data_ptr(), y.data_ptr(), n_pad, A.n_rows, A.n_cols, k, A.B,
        kernels.stream_of(x))
    kernels.check(err, "banded_spmv")
    kernels.LAUNCHES["banded_spmv"] += 1
    return y


def banded_spmv_t(A: BandedEll, r: torch.Tensor) -> torch.Tensor:
    """y = A.T @ r from A's transpose schedule: the kernel that replaces
    ``hypre_tpu/seq/fastmv.py::_spmv_t_kernel`` on a CUDA tensor, the plain
    version on a CPU tensor. Every output is summed in a fixed order, so
    two calls give the same bits. Raises if the schedule was not built."""
    if r.shape[0] != A.n_rows:
        raise ValueError(f"shape mismatch: {A.shape[::-1]} @ {tuple(r.shape)}")
    if A.t_vals is None:
        raise ValueError(
            "this BandedEll has no transpose schedule: build it once with "
            "fastmv.with_transpose_schedule(band) before calling mv_t "
            "(optimize_hierarchy does so for every P it restricts through)"
        )
    if not r.is_cuda:
        return banded_spmv_t_plain(A.t_vals, A.t_rows, A.t_colptr, r)
    _check_schedule(A, r)
    # the kernel writes every column, those without a nonzero too
    y = torch.empty(A.n_cols, dtype=torch.float32, device=r.device)
    err = kernels.library("banded_spmv").hypre_banded_spmv_t(
        A.t_vals.data_ptr(), A.t_rows.data_ptr(), A.t_colptr.data_ptr(),
        A.t_chunks.data_ptr(), r.data_ptr(), y.data_ptr(),
        A.t_chunks.shape[0] - 1, A.t_cap, kernels.stream_of(r))
    kernels.check(err, "banded_spmv_t")
    kernels.LAUNCHES["banded_spmv_t"] += 1
    return y


# ---------------------------------------------------------------------------
# Schedule and payload construction (on the matrix's device)
# ---------------------------------------------------------------------------


def _sched_impl(cols: torch.Tensor, B: int, n_pad: int):
    """Per-block aligned window starts + [max window span, max start]."""
    valid = cols >= 0
    big = torch.iinfo(torch.int32).max
    nb = n_pad // B
    blk_min = torch.where(valid, cols, torch.full_like(cols, big)) \
        .reshape(nb, -1).amin(dim=1)
    blk_max = torch.where(valid, cols, torch.full_like(cols, -1)) \
        .reshape(nb, -1).amax(dim=1)
    empty = blk_max < 0
    blk_min = torch.where(empty, torch.zeros_like(blk_min), blk_min)
    blk_max = torch.where(empty, torch.zeros_like(blk_max), blk_max)
    lo = ((blk_min // ALIGN) * ALIGN).to(torch.int32)
    sc = torch.stack([(blk_max - lo + 1).max(), lo.max()])
    return lo, sc


def _payload_impl(vals, cols, lo, B: int):
    """Slot-major payload; padded slots point at window slot 0 with value
    0, so whatever they gather contributes nothing."""
    valid = cols >= 0
    lcols = torch.where(valid, cols - lo.repeat_interleave(B)[:, None],
                        torch.zeros_like(cols)).to(torch.int32)
    return vals.T.contiguous(), lcols.T.contiguous()


def _banded_sched_payload(vals, cols, B: int, n_pad: int):
    n, k = cols.shape
    if n_pad != n:
        cols = torch.cat([cols, cols.new_full((n_pad - n, k), -1)])
        vals = torch.cat([vals, vals.new_zeros((n_pad - n, k))])
    lo, sc = _sched_impl(cols, B, n_pad)
    vals_t, lcols_t = _payload_impl(vals, cols, lo, B)
    return vals_t, lcols_t, lo, sc


def banded_from_sched(A: EllMatrix, vals_t, lcols_t, lo_d, wmax: int,
                      lomax: int, exact: int = 1,
                      max_window: int = 131072) -> "BandedEll | None":
    """BandedEll from a ``_banded_sched_payload`` result whose two schedule
    scalars the caller already read back."""
    W = _wbucket(wmax)
    if W > max_window:
        return None
    return BandedEll(
        ell=A, vals_t=vals_t, lcols_t=lcols_t, starts=lo_d, W=W, B=1024,
        n_xpad=_xpad_bucket(max(lomax + W, A.n_cols)), exact=exact,
        n_rows_s=A.n_rows, n_cols_s=A.n_cols,
    )


def try_banded(
    A: EllMatrix,
    block: int | None = None,
    max_window: int = 131072,
    exact: int = 1,
) -> BandedEll | None:
    """Build the window schedule, or None if a window exceeds
    ``max_window`` (matrix not banded enough) or A is not float32."""
    if A.dtype != torch.float32:
        return None
    n, k = A.cols.shape
    B = block or 1024
    n_pad = -(-n // B) * B
    vals_t, lcols_t, lo_d, sc = _banded_sched_payload(A.vals, A.cols, B, n_pad)
    wmax, lomax = (int(v) for v in sc.cpu().tolist())
    W = _wbucket(wmax)
    if W > max_window:
        return None
    return BandedEll(
        ell=A, vals_t=vals_t, lcols_t=lcols_t, starts=lo_d, W=W, B=B,
        n_xpad=_xpad_bucket(max(lomax + W, A.n_cols)), exact=exact,
        n_rows_s=A.n_rows, n_cols_s=A.n_cols,
    )


def with_transpose_schedule(band: BandedEll,
                            cap: int = T_CHUNK) -> BandedEll:
    """``band`` with the schedule that ``mv_t`` reads, built once from the
    forward payload on the payload's device.

    The nonzero slots, taken in (row, slot) order, are sorted by their
    global destination column with a stable integer sort, so the card and
    the CPU build the same schedule. Slots with value 0 (padding) are
    dropped: the schedule holds 8 bytes per nonzero. Chunks are cut on
    column boundaries wherever the running nonzero count or the column
    index passes a multiple of ``cap``; no sum crosses a chunk. A column
    longer than ``cap`` ends its chunk and is summed by the whole block.
    """
    k, n_pad = band.vals_t.shape
    n, m = band.n_rows, band.n_cols
    dev = band.vals_t.device
    vals = band.vals_t[:, :n].T
    dest = (_row_base(band.starts, band.B, n_pad)[:n, None]
            + band.lcols_t[:, :n].T.to(torch.int64))
    keep = (vals != 0) & (dest >= 0) & (dest < m)
    rows = torch.arange(n, dtype=torch.int32, device=dev)[:, None] \
        .expand(n, k)[keep]
    dest, order = torch.sort(dest[keep], stable=True)
    nnz = int(dest.shape[0])
    n_slots = -(-nnz // 4) * 4
    t_vals = torch.zeros(n_slots, dtype=band.vals_t.dtype, device=dev)
    t_rows = torch.zeros(n_slots, dtype=torch.int32, device=dev)
    t_vals[:nnz] = vals[keep][order]
    t_rows[:nnz] = rows[order]
    colptr = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    colptr[1:] = torch.cumsum(torch.bincount(dest, minlength=m), 0)
    run = torch.stack([colptr[:-1] // cap,
                       torch.arange(m, device=dev) // cap])
    cut = (run[:, 1:] != run[:, :-1]).any(dim=0)
    firsts = torch.nonzero(cut)[:, 0] + 1
    chunks = torch.cat([firsts.new_zeros(1), firsts, firsts.new_full((1,), m)])
    return dataclasses.replace(
        band, t_vals=t_vals, t_rows=t_rows,
        t_colptr=colptr.to(torch.int32), t_chunks=chunks.to(torch.int32),
        t_cap=cap)


# below this many stored elements an operator stays a plain ELL matrix,
# as in the reference
MIN_BANDED_ELEMENTS = 262144


def optimize_operator(
    A: EllMatrix, prefer_pallas: bool | None = None, exact: int = 1,
    dia_detect: str = "auto", specialize: bool = False,
):
    """Pick the SpMV representation of one matrix: DIA when it decomposes
    into diagonals, else the banded kernel format when it is large enough
    and the kernels are wanted (default: when A lies on a CUDA device),
    else A itself. The name ``prefer_pallas`` is kept from the reference.

    dia_detect: 'auto' probes for diagonal structure even without a shifts
    annotation (reads the index slab back to the host); 'shifts' trusts
    only the annotation.
    """
    from hypre_tpu_torch.seq.dia import try_dia

    if dia_detect == "shifts" and A.shifts is None:
        dia = None
    else:
        dia = try_dia(A, specialize=specialize)
    if dia is not None:
        return dia
    if A.n_rows * A.k < MIN_BANDED_ELEMENTS:
        return A
    if prefer_pallas is None:
        prefer_pallas = A.device.type == "cuda"
    if prefer_pallas:
        banded = try_banded(A, exact=exact)
        if banded is not None:
            return banded
    return A
