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
compiled in — in float32 and float64. Planes that are mostly zero (a
``TransferDia``'s fine-space transfer planes, a semi-structured U's
coupling view) also carry a row-list layout
of their nonzeros (``compact_dia``), and the card then runs the row-list
kernel instead, whichever of the two offset kinds the matrix has. On a
CPU tensor ``mv`` runs the plain PyTorch versions of the dense kernels,
which compute the same sum in the same order; all three routes give the
same bits for finite x.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from hypre_tpu_torch import kernels
from hypre_tpu_torch.core.config import fold_sum, host_tensor, tensors_to
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
    # row-list layout of the nonzeros of dvals (``compact_dia``): the
    # listed rows' entries in ascending plane order; None when the planes
    # are kept dense only
    r_ptr: torch.Tensor | None = None  # (n_list + 1,) int32
    r_ids: torch.Tensor | None = None  # (nnz,) uint8 plane ids
    r_vals: torch.Tensor | None = None  # (nnz,) dvals.dtype
    # the listed (non-empty) rows, ascending, and their bitmask; None when
    # every row is listed (n_list == n_rows)
    r_rows: torch.Tensor | None = None  # (n_list,) int32
    r_mask: torch.Tensor | None = None  # (ceil(n_rows / 32),) int32
    r_lanes: int = 1  # lanes per listed row (1: one thread per row)

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
                host_tensor(np.asarray(offs, np.int32).tolist(), torch.int32,
                            self.dvals.device),
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
        if x.is_cuda and self.r_ptr is not None:
            return dia_rows(self.r_ptr, self.r_ids, self.r_vals, self.offsets,
                            x, self.n_rows, self.n_cols, self.r_rows,
                            self.r_mask, self.r_lanes)
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
STATIC_D_LADDER = (56, 64, 80, 96)


def on_static_ladder(D: int) -> bool:
    """Whether the static kernel is instantiated for D diagonals."""
    return 1 <= D <= 48 or D in STATIC_D_LADDER


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
    if not on_static_ladder(D):
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
# Kernels 1 and 2 on mostly-zero planes: the row-list route
# ---------------------------------------------------------------------------

MAX_ROWS_D = 255  # plane ids are stored as uint8
ROW_LANES = (1, 4)
# compact when the row list takes at most this share of the planes' bytes:
# the 7-pt A (every slot a nonzero) stays dense; a TransferDia's planes
# (~2 % nonzeros at D = 64) and a semi-structured U's coupling view (a few
# thousand nonzeros over millions of rows) compact
ROWS_MAX_SHARE = 0.25
# one thread a listed row while the listed rows hold at most this many
# entries on average, else 4 lanes a listed row: P of the bench hierarchy
# (1.5 a row) and U (1) get one thread a row, P^T (25 a row) 4 lanes. On
# an H100 the 4 lanes overtake one thread between 12 and 16 entries a row
# (chip_smoke.py's row_lanes_sweep, PERF.md).
ROWS_PER_LANE = 12


def row_list_bytes(nnz: int, n_rows: int, n_list: int,
                   itemsize: int) -> int:
    """Bytes of the row-list layout: a value and a plane id per nonzero,
    the pointer over the listed rows and, when not every row is listed,
    the listed rows and their bitmask."""
    entries = nnz * (itemsize + 1)
    if n_list == n_rows:
        return entries + (n_rows + 1) * 4
    return entries + (n_list + 1) * 4 + n_list * 4 + -(-n_rows // 32) * 4


def _row_bitmask(rows: torch.Tensor, n: int) -> torch.Tensor:
    """int32 words whose bit i % 32 of word i // 32 is set for each row i
    in ``rows``."""
    bits = torch.zeros(-(-n // 32) * 32, dtype=torch.int64,
                       device=rows.device)
    bits[rows.long()] = 1
    words = (bits.view(-1, 32) << torch.arange(32, device=rows.device)).sum(1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def compact_dia(M: DiaMatrix) -> DiaMatrix:
    """M with the row-list layout of its nonzeros, or M as it is when that
    layout would take more than ``ROWS_MAX_SHARE`` of the planes' bytes.

    The layout: ``r_ptr`` over the non-empty rows' entries, ``r_ids``
    (uint8 plane ids) and ``r_vals`` in ascending plane order per row,
    and, where listing the non-empty rows costs fewer bytes than a pointer
    per row, ``r_rows`` (the listed rows, ascending) with ``r_mask``
    (their bitmask, from which the kernel writes the other rows' zeros);
    else every row is listed and ``r_rows`` is None. ``r_lanes`` is 1 (a
    thread a row) or 4 (lanes a row, for a mean above ``ROWS_PER_LANE``
    entries).

    One pass over ``dvals.T != 0``: ``nonzero`` on the (n, D) view lists
    the nonzeros row by row, planes ascending within a row, which is the
    order in which the dense kernels add them. The same on the card and
    the CPU. ``dvals`` stays: the plain versions, ``mv_t`` and the masked
    applies read it.
    """
    if M.r_ptr is not None:
        return M
    D, n = M.dvals.shape
    if D > MAX_ROWS_D:
        raise ValueError(f"row-list layout takes at most {MAX_ROWS_D} "
                         f"diagonals (uint8 plane ids), got {D}")
    nz = (M.dvals != 0).T.contiguous()
    counts = nz.sum(1)
    nnz = int(counts.sum())
    listed = torch.nonzero(counts)[:, 0].to(torch.int32)
    n_list = int(listed.shape[0])
    itemsize = M.dvals.element_size()
    if row_list_bytes(nnz, n, n, itemsize) <= row_list_bytes(
            nnz, n, n_list, itemsize):
        listed, n_list = None, n
    if row_list_bytes(nnz, n, n_list, itemsize) > \
            ROWS_MAX_SHARE * D * n * itemsize:
        return M
    rows, ids = torch.nonzero(nz, as_tuple=True)
    per_slot = counts if listed is None else counts[listed.long()]
    r_ptr = torch.zeros(n_list + 1, dtype=torch.int32, device=rows.device)
    torch.cumsum(per_slot, 0, out=r_ptr[1:])
    lanes = 1 if nnz <= ROWS_PER_LANE * max(n_list, 1) else ROW_LANES[-1]
    return dataclasses.replace(
        M, r_ptr=r_ptr, r_ids=ids.to(torch.uint8),
        r_vals=M.dvals[ids, rows].contiguous(), r_rows=listed,
        r_mask=None if listed is None else _row_bitmask(listed, n),
        r_lanes=lanes)


def dia_rows_plain(r_ptr, r_ids, r_vals, offsets, x, n_rows: int,
                   n_cols: int, r_rows=None) -> torch.Tensor:
    """Plain version of the row-list kernel: each listed row's products
    added left to right in entry order, as the kernel adds them, and a
    zero in every other row. ``offsets`` is the device table or the
    static tuple."""
    dev = x.device
    n_list = r_ptr.shape[0] - 1
    counts = (r_ptr[1:] - r_ptr[:-1]).long()
    slots = torch.repeat_interleave(torch.arange(n_list, device=dev), counts)
    listed = (torch.arange(n_list, device=dev) if r_rows is None
              else r_rows.long())
    rows = listed[slots]
    cols = rows + torch.as_tensor(offsets, device=dev).long()[r_ids.long()]
    inside = (cols >= 0) & (cols < n_cols)
    xv = torch.where(inside, x[cols.clamp(0, max(n_cols - 1, 0))],
                     x.new_zeros(()))
    pos = torch.arange(slots.shape[0], device=dev) - r_ptr[:-1].long()[slots]
    width = int(counts.max()) if n_list else 0
    slab = x.new_zeros((n_list, max(width, 1)))
    slab[slots, pos] = r_vals * xv
    y = x.new_zeros(n_rows)
    y[listed] = fold_sum(slab, dim=1)
    return y


def dia_rows(r_ptr, r_ids, r_vals, offsets, x, n_rows: int, n_cols: int,
             r_rows=None, r_mask=None, lanes: int = 1) -> torch.Tensor:
    """y = A @ x from A's row-list layout (``compact_dia``): the row-list
    kernel that replaces ``hypre_tpu/seq/dia.py::_dia_kernel`` (and, on
    mostly-zero planes, ``_dia_kernel_static``) on a CUDA tensor, the
    plain version on a CPU tensor. ``offsets``: the device table, or the
    static tuple (copied to the device). ``r_rows`` and ``r_mask`` come
    together, or neither when every row is listed."""
    if not x.is_cuda:
        return dia_rows_plain(r_ptr, r_ids, r_vals, offsets, x, n_rows,
                              n_cols, r_rows)
    dev = x.device
    if r_vals.dtype not in _DTYPE_SUFFIX:
        raise ValueError(f"DIA kernel takes float32/float64, got "
                         f"{r_vals.dtype}")
    if lanes not in ROW_LANES:
        raise ValueError(f"lanes must be one of {ROW_LANES}, got {lanes}")
    if (r_rows is None) != (r_mask is None):
        raise ValueError("r_rows and r_mask come together")
    n_list = n_rows if r_rows is None else r_rows.numel()
    kernels.require(r_ptr, "r_ptr", torch.int32, (n_list + 1,), dev)
    kernels.require(r_vals, "r_vals", r_vals.dtype, (r_vals.numel(),), dev)
    kernels.require(r_ids, "r_ids", torch.uint8, r_vals.shape, dev)
    kernels.require(x, "x", r_vals.dtype, (n_cols,), dev)
    if r_rows is not None:
        kernels.require(r_rows, "r_rows", torch.int32, (n_list,), dev)
        kernels.require(r_mask, "r_mask", torch.int32, (-(-n_rows // 32),),
                        dev)
    if not isinstance(offsets, torch.Tensor):
        offsets = torch.tensor(offsets, dtype=torch.int32, device=dev)
    D = offsets.shape[0]
    if not 1 <= D <= MAX_ROWS_D:
        raise ValueError(f"row-list kernel takes 1..{MAX_ROWS_D} "
                         f"diagonals, got {D}")
    kernels.require(offsets, "offsets", torch.int32, (D,), dev)
    y = torch.empty(n_rows, dtype=r_vals.dtype, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = getattr(kernels.library("dia_spmv"),
                 f"hypre_dia_rows_{_DTYPE_SUFFIX[r_vals.dtype]}")
    err = fn(ptr(r_rows), r_ptr.data_ptr(), r_ids.data_ptr(),
             r_vals.data_ptr(), ptr(r_mask), offsets.data_ptr(),
             x.data_ptr(), y.data_ptr(), n_rows, n_cols, D, n_list, lanes,
             kernels.stream_of(x))
    kernels.check(err, "dia_rows")
    kernels.LAUNCHES["dia_rows"] += 1
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
