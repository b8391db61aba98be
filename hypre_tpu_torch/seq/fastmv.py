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
- kernel 4, the scatter-transpose ``y = A^T r`` (replacing
  ``_spmv_t_kernel``), which carries restriction on Galerkin levels.

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


def banded_spmv_t_plain(vals_t, lcols_t, starts, r, n_out: int,
                        B: int) -> torch.Tensor:
    """Plain version of the scatter-transpose kernel: every nonzero slot
    adds vals_t[s,row] * r[row] at its window column."""
    k, n_pad = vals_t.shape
    n_rows = r.shape[0]
    base = _row_base(starts, B, n_pad)[:n_rows]
    y = torch.zeros(n_out, dtype=r.dtype, device=r.device)
    for s in range(k):
        v = vals_t[s, :n_rows]
        j = base + lcols_t[s, :n_rows].to(torch.int64)
        keep = (v != 0) & (j >= 0) & (j < n_out)
        y.index_add_(0, j[keep], (v * r)[keep])
    return y


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
    """y = A.T @ r, reusing A's forward window schedule (A's columns are
    the transpose's rows): the kernel that replaces
    ``hypre_tpu/seq/fastmv.py::_spmv_t_kernel`` on a CUDA tensor, the plain
    version on a CPU tensor."""
    if r.shape[0] != A.n_rows:
        raise ValueError(f"shape mismatch: {A.shape[::-1]} @ {tuple(r.shape)}")
    if not r.is_cuda:
        return banded_spmv_t_plain(A.vals_t, A.lcols_t, A.starts, r, A.n_cols,
                                   A.B)
    _check_banded(A, r, A.n_rows, "r")
    k, n_pad = A.vals_t.shape
    y = torch.zeros(A.n_cols, dtype=torch.float32, device=r.device)
    err = kernels.library("banded_spmv").hypre_banded_spmv_t(
        A.vals_t.data_ptr(), A.lcols_t.data_ptr(), A.starts.data_ptr(),
        r.data_ptr(), y.data_ptr(), n_pad, A.n_rows, A.n_cols, k, A.B,
        kernels.stream_of(r))
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
