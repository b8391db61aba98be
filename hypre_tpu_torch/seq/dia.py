"""DiaMatrix — diagonal-offset sparse format for stencil operators.

Counterpart of ``hypre_tpu/seq/dia.py``. A stencil-generated fine-grid
operator decomposes exactly into diagonals,

    y = sum_d  dvals[d] * shift(x, offsets[d]),

so its SpMV needs no column indices: each diagonal is a contiguous stream.
AMG coarse operators do not decompose (PMIS renumbering scatters their
offsets) and use the banded gather of ``fastmv.py``; ``try_dia`` decides.

On a CUDA tensor ``mv`` launches the hand-written kernels of
``csrc/dia_spmv.cu`` — the dynamic one (offsets read from the device
array) or, when ``offsets_static`` is set, the one whose offsets are
compiled in — in float32 and float64. On a CPU tensor it runs the plain
PyTorch versions below, which compute the same sum in the same order.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from hypre_tpu_torch import kernels
from hypre_tpu_torch.core.config import fold_sum, tensors_to
from hypre_tpu_torch.seq.ell import EllMatrix

ALIGN = 1024  # margin granularity, kept from the reference's bucketing


def _shift1d(x: torch.Tensor, o: int) -> torch.Tensor:
    """z[i] = x[i+o], zero fill, static offset."""
    if o == 0:
        return x
    if o > 0:
        return torch.cat([x[o:], x.new_zeros(min(o, x.shape[0]))])[:x.shape[0]]
    return torch.cat([x.new_zeros(min(-o, x.shape[0])), x[:o]])[-x.shape[0]:]


def _shift1d_dyn(x: torch.Tensor, o: torch.Tensor, margin: int) -> torch.Tensor:
    """z[i] = x[i+o] with a device offset |o| <= margin, zero fill."""
    n = x.shape[0]
    xp = torch.cat([x.new_zeros(margin), x, x.new_zeros(margin)])
    idx = torch.arange(n, device=x.device) + (o.to(torch.int64) + margin)
    return xp[idx]


def _margin_for(offsets_host, n: int) -> int:
    """ALIGN-multiple margin covering the offsets: the smallest n>>j
    (j in 6..0) that does."""
    mx = max((abs(int(o)) for o in offsets_host), default=0)
    for j in (6, 5, 4, 3, 2, 1, 0):
        m = -(-max(n >> j, ALIGN) // ALIGN) * ALIGN
        if m >= mx + 1:
            return m
    return -(-(mx + 1) // ALIGN) * ALIGN


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """dvals[d, i] = A[i, i + offsets[d]] (row-indexed diagonal storage).

    offsets: (D,) int32 device tensor; ``margin`` bounds |offset|. Pass
    host offsets (tuple/list/ndarray) and __post_init__ converts them and
    derives the margin. offsets_static: when set (a host tuple equal to
    ``offsets``), SpMV runs the kernel with the offsets compiled in
    (``try_dia(specialize=True)``); when None, the dynamic kernel runs.
    """

    dvals: torch.Tensor  # (D, n_rows)
    offsets: torch.Tensor  # (D,) int32
    n_cols: int
    margin: int = 0
    offsets_static: tuple | None = None

    def __post_init__(self):
        offs = self.offsets
        if isinstance(offs, (tuple, list, np.ndarray)):
            if self.margin == 0:
                object.__setattr__(
                    self, "margin",
                    _margin_for(offs, int(self.dvals.shape[1])),
                )
            object.__setattr__(
                self, "offsets",
                torch.as_tensor(np.asarray(offs, np.int32),
                                device=self.dvals.device),
            )
        elif self.margin == 0:
            raise ValueError(
                "DiaMatrix with device offsets needs an explicit margin")

    @property
    def D(self) -> int:
        return self.dvals.shape[0]

    @property
    def n_rows(self) -> int:
        return self.dvals.shape[1]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.dvals.dtype

    @property
    def device(self) -> torch.device:
        return self.dvals.device

    @property
    def vec_len_rows(self) -> int:
        return self.n_rows

    @property
    def vec_len_cols(self) -> int:
        return self.n_cols

    def to(self, device) -> "DiaMatrix":
        return tensors_to(self, device)

    def diagonal(self) -> torch.Tensor:
        sel = (self.offsets == 0).to(self.dtype)
        return fold_sum(self.dvals * sel[:, None], dim=0)

    def row_sums(self) -> torch.Tensor:
        return fold_sum(self.dvals, dim=0)

    def abs_row_sums(self) -> torch.Tensor:
        return fold_sum(self.dvals.abs(), dim=0)

    def pack_blocked(self) -> "DiaMatrix":
        """No-op here: the reference copies dvals block-major so each TPU
        grid step is one contiguous DMA instead of D strided segments (a
        DMA-descriptor cost). The CUDA kernel reads each diagonal row with
        coalesced loads straight from the (D, n) layout, so the copy would
        only cost memory."""
        return self

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.n_cols:
            raise ValueError(f"shape mismatch: {self.shape} @ {tuple(x.shape)}")
        if self.offsets_static is not None:
            return dia_spmv_static(self.dvals, self.offsets_static, x,
                                   self.n_cols)
        return dia_spmv(self.dvals, self.offsets, x, self.n_cols, self.margin)

    def mv_t(self, x: torch.Tensor) -> torch.Tensor:
        """A^T x: entry (i, i+o) of A contributes at output row i+o."""
        y = None
        for d in range(self.D):
            if self.offsets_static is not None:
                term = _shift1d(self.dvals[d] * x, -self.offsets_static[d])
            else:
                term = _shift1d_dyn(self.dvals[d] * x, -self.offsets[d],
                                    self.margin)
            y = term if y is None else y + term
        return y

    def _masked_apply(self, x: torch.Tensor, sign: int) -> torch.Tensor:
        y = torch.zeros_like(x)
        for d in range(self.D):
            if self.offsets_static is not None:
                o = self.offsets_static[d]
                if o * sign > 0:
                    y = y + self.dvals[d] * _shift1d(x, o)
            else:
                mask = (self.offsets[d] * sign > 0).to(self.dtype)
                y = y + mask * self.dvals[d] * _shift1d_dyn(
                    x, self.offsets[d], self.margin)
        return y

    def lower_apply(self, x: torch.Tensor) -> torch.Tensor:
        return self._masked_apply(x, -1)

    def upper_apply(self, x: torch.Tensor) -> torch.Tensor:
        return self._masked_apply(x, 1)


# ---------------------------------------------------------------------------
# Kernels 1 and 2: DIA SpMV, dynamic and static offsets
# ---------------------------------------------------------------------------


def dia_spmv_plain(dvals, offsets, x, margin: int) -> torch.Tensor:
    """Plain version of the dynamic kernel: the same sum, same order."""
    y = None
    for d in range(dvals.shape[0]):
        term = dvals[d] * _shift1d_dyn(x, offsets[d], margin)
        y = term if y is None else y + term
    return y


def dia_spmv_static_plain(dvals, offsets_static, x) -> torch.Tensor:
    """Plain version of the static kernel: the same sum, same order."""
    y = None
    for d, o in enumerate(offsets_static):
        term = dvals[d] * _shift1d(x, int(o))
        y = term if y is None else y + term
    return y


_DTYPE_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# Diagonal counts csrc/dia_spmv.cu instantiates the static kernel for: every
# count up to try_dia's max_offsets, and the widths TransferDia pads to
MAX_STATIC_D = 96
STATIC_D_LADDER = (56, 64, 80, 96)


@functools.lru_cache(maxsize=64)
def _host_offsets(offsets: tuple):
    """The static kernel's offsets as a host int32 array, built once per
    offset family (the launch copies it into the kernel's arguments)."""
    return (ctypes.c_int * len(offsets))(*offsets)


def _check_dia_operands(dvals, x, n_cols):
    if dvals.dtype not in _DTYPE_SUFFIX:
        raise ValueError(f"DIA kernel takes float32/float64, got {dvals.dtype}")
    kernels.require(dvals, "dvals", dvals.dtype, dvals.shape, x.device)
    kernels.require(x, "x", dvals.dtype, (n_cols,), x.device)


def dia_spmv(dvals, offsets, x, n_cols: int, margin: int) -> torch.Tensor:
    """y = A @ x for A = DIA(dvals, offsets): the kernel that replaces
    ``hypre_tpu/seq/dia.py::_dia_kernel`` on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not x.is_cuda:
        return dia_spmv_plain(dvals, offsets, x, margin)
    _check_dia_operands(dvals, x, n_cols)
    D, n = dvals.shape
    kernels.require(offsets, "offsets", torch.int32, (D,), x.device)
    y = torch.empty(n, dtype=dvals.dtype, device=x.device)
    fn = getattr(kernels.library("dia_spmv"),
                 f"hypre_dia_spmv_{_DTYPE_SUFFIX[dvals.dtype]}")
    err = fn(dvals.data_ptr(), offsets.data_ptr(), x.data_ptr(), y.data_ptr(),
             n, n_cols, D, kernels.stream_of(x))
    kernels.check(err, "dia_spmv")
    kernels.LAUNCHES["dia_spmv"] += 1
    return y


def dia_spmv_static(dvals, offsets_static, x, n_cols: int) -> torch.Tensor:
    """y = A @ x with the offsets compiled into the kernel: replaces
    ``hypre_tpu/seq/dia.py::_dia_kernel_static`` on a CUDA tensor, the
    plain version on a CPU tensor."""
    if not x.is_cuda:
        return dia_spmv_static_plain(dvals, offsets_static, x)
    _check_dia_operands(dvals, x, n_cols)
    D, n = dvals.shape
    if len(offsets_static) != D:
        raise ValueError(f"{len(offsets_static)} static offsets for {D} "
                         "diagonals")
    if not 1 <= D <= MAX_STATIC_D or (D > 48 and D not in STATIC_D_LADDER):
        raise ValueError("static DIA kernel takes 1..48 diagonals or one of "
                         f"{STATIC_D_LADDER}, got {D}")
    offs = _host_offsets(tuple(int(o) for o in offsets_static))
    y = torch.empty(n, dtype=dvals.dtype, device=x.device)
    fn = getattr(kernels.library("dia_spmv"),
                 f"hypre_dia_spmv_static_{_DTYPE_SUFFIX[dvals.dtype]}")
    err = fn(dvals.data_ptr(), ctypes.addressof(offs), x.data_ptr(),
             y.data_ptr(), n, n_cols, D, kernels.stream_of(x))
    kernels.check(err, "dia_spmv_static")
    kernels.LAUNCHES["dia_spmv_static"] += 1
    return y


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def make_dia(dvals, offsets_host, n_cols: int) -> DiaMatrix:
    """DiaMatrix from HOST offsets (margin derived, offsets go to the
    device of dvals)."""
    return DiaMatrix(dvals=dvals, offsets=tuple(int(o) for o in offsets_host),
                     n_cols=n_cols)


def _dia_planes(vals, cols, offs: torch.Tensor) -> torch.Tensor:
    """Diagonal planes from a shift-annotated ELL: one searchsorted and one
    scatter-add (offs sorted)."""
    n, k = cols.shape
    D = offs.shape[0]
    rows = torch.arange(n, dtype=cols.dtype, device=cols.device)[:, None]
    diff = (cols - rows).contiguous()
    oid = torch.searchsorted(offs, diff).clamp(0, D - 1)
    hit = (cols >= 0) & (offs[oid] == diff)
    rows_b = rows.expand(n, k)
    out = torch.zeros((D, n), dtype=vals.dtype, device=vals.device)
    return out.index_put_((oid.long(), rows_b.long()),
                          torch.where(hit, vals, torch.zeros_like(vals)),
                          accumulate=True)


def try_dia(A: EllMatrix, max_offsets: int = 48,
            specialize: bool = False) -> DiaMatrix | None:
    """Exact DIA decomposition, or None if A has too many distinct offsets.

    Square matrices only. With a ``shifts`` annotation the decomposition is
    slot arithmetic on the device; without one the index slab is read back
    to the host.
    """
    if A.n_rows != A.n_cols:
        return None
    if A.shifts is not None and len(set(A.shifts)) <= max_offsets:
        offs = sorted(set(int(s) for s in A.shifts))
        offs_t = torch.tensor(offs, dtype=torch.int32, device=A.device)
        return DiaMatrix(
            dvals=_dia_planes(A.vals, A.cols, offs_t),
            offsets=tuple(offs),
            n_cols=A.n_cols,
            offsets_static=tuple(offs) if specialize else None,
        )
    cols = A.cols.cpu().numpy()
    vals = A.vals.cpu().numpy()
    n, k = cols.shape
    rows = np.arange(n)[:, None]
    valid = cols >= 0
    offs = np.unique((cols - rows)[valid])
    if len(offs) > max_offsets:
        return None
    dvals = np.zeros((len(offs), n), vals.dtype)
    for d, o in enumerate(offs):
        m = valid & ((cols - rows) == o)
        np.add.at(dvals[d], np.nonzero(m)[0], vals[m])
    offs_t = tuple(int(o) for o in offs)
    return DiaMatrix(
        dvals=torch.from_numpy(dvals).to(A.device),
        offsets=offs_t,
        n_cols=A.n_cols,
        offsets_static=offs_t if specialize else None,
    )
