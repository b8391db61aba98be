"""StructMatrix and the stencil matvec — hypre's struct_mv on the card.

Counterpart of ``hypre_tpu/struct/matrix.py``. hypre stores a StructMatrix
as per-box coefficient arrays over a padded data space and applies it with
BoxLoop stencil kernels (``struct_mv/struct_matvec.c:92-531``); the
reference applies it as a pad and S static slices,

    y[i] = sum_s  coeffs[s, i] * x[i + offset_s]   (zero fill off the grid).

Here the hot path is the operator's DIA view (``dia_view``), built once per
operator and kept with it: every stencil entry becomes a row-major flat
diagonal ``sum_d o_d * stride_d`` whose plane is the coefficient (broadcast
when it is constant) zeroed wherever ``i + o`` leaves the box — the
reference's zero-filled ghost read. An entry that moves along a periodic
dim becomes one plane per landing position (in the box, or wrapped by
``n_d``), with complementary masks. The planes keep the stencil order, so
the sum runs in the reference's order of ``s``. ``StructMatrix.mv`` runs
``seq/dia.py::DiaMatrix.mv``: on a CUDA tensor the hand-written DIA kernel
(the static one when the plane count is on its ladder), on a CPU tensor
its plain version. ``struct_matvec`` is the reference's shift-and-add on
CPU tensors only (the tests' oracle); on a CUDA tensor it raises.

Constant-coefficient matrices (hypre's ``constant_coefficient`` mode)
store ``coeffs`` of shape ``(S,)``.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import torch

from hypre_tpu_torch.core.config import resolve_device, tensors_to
from hypre_tpu_torch.seq.dia import DiaMatrix, on_static_ladder
from hypre_tpu_torch.struct.stencil import StructStencil


def shift(x: torch.Tensor, offset, periodic=None) -> torch.Tensor:
    """z[..., i] = x[..., i + offset] over the last ``len(offset)`` dims,
    zero-filled (periodic dims wrap instead); leading dims are a batch."""
    nd = len(offset)
    lead = x.dim() - nd
    periodic = periodic or (False,) * nd
    z = x
    for d, o in enumerate(offset):
        o = int(o)
        if o == 0:
            continue
        dim = lead + d
        n = z.shape[dim]
        if periodic[d]:
            z = torch.roll(z, -o, dims=dim)
            continue
        out = torch.zeros_like(z)
        if abs(o) < n:
            if o > 0:
                out.narrow(dim, 0, n - o).copy_(z.narrow(dim, o, n - o))
            else:
                out.narrow(dim, -o, n + o).copy_(z.narrow(dim, 0, n + o))
        z = out
    return z


@dataclasses.dataclass(frozen=True)
class StructMatrix:
    """Stencil matrix over a single logical box.

    coeffs: (S, *shape) variable-coefficient or (S,) constant-coefficient.
    """

    coeffs: torch.Tensor
    stencil: StructStencil
    shape: tuple[int, ...]
    periodic: tuple[bool, ...] = None

    def __post_init__(self):
        periodic = self.periodic or (False,) * len(self.shape)
        object.__setattr__(self, "periodic", tuple(bool(p) for p in periodic))
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def is_constant(self) -> bool:
        return self.coeffs.dim() == 1

    @property
    def n_rows(self) -> int:
        return int(np.prod(self.shape))

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def device(self) -> torch.device:
        return self.coeffs.device

    def to(self, device) -> "StructMatrix":
        return tensors_to(self, device)

    def cached(self, key, build):
        """``build()`` once per operator, kept with it (the DIA view, the
        line solves' coefficients): a StructMatrix never changes."""
        store = self.__dict__.setdefault("_cache", {})
        if key not in store:
            store[key] = build()
        return store[key]

    def coeff(self, s: int) -> torch.Tensor:
        c = self.coeffs[s]
        return c.expand(self.shape) if self.is_constant else c

    def diagonal(self) -> torch.Tensor:
        return self.coeff(self.stencil.center_index())

    @property
    def dia(self) -> DiaMatrix:
        """The DIA view that ``mv`` runs, built at first use."""
        return self.cached(("dia", True), lambda: dia_view(self))

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x through the DIA view. x is grid-shaped or flat, with
        any leading batch dims (one kernel launch per vector); y has x's
        shape."""
        return per_vector(self.dia.mv, x, self.shape)

    def mv_t(self, x: torch.Tensor) -> torch.Tensor:
        """y = A.T @ x through the DIA view's transpose; shapes as ``mv``."""
        return per_vector(self.dia.mv_t, x, self.shape)

    # -- flattened-operator views for the Krylov layer ------------------------

    def as_linear_op(self):
        """1-D operator on raveled vectors (struct_ls/pcg_struct.c glue)."""
        return self.mv

    def to_dense(self) -> torch.Tensor:
        """Materialize as a dense (n, n) matrix — coarse direct solves and
        test oracles — from the DIA view's planes."""
        return dia_dense(self.dia)


def per_vector(apply, x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``apply`` (a flat DIA product) on x, which is ``shape``-shaped or
    flat with any leading batch dims: one product per vector, the result
    in x's shape."""
    n = int(np.prod(shape))
    if tuple(x.shape[x.dim() - len(shape):]) == tuple(shape):
        lead = x.shape[:x.dim() - len(shape)]
    elif x.shape[-1] == n:
        lead = x.shape[:-1]
    else:
        raise ValueError(f"shape mismatch: {tuple(shape)} @ "
                         f"{tuple(x.shape)}")
    if not lead:
        return apply(x.reshape(-1).contiguous()).reshape(x.shape)
    xb = x.reshape(-1, n)
    return torch.stack([apply(xb[k].contiguous())
                        for k in range(xb.shape[0])]).reshape(x.shape)


def dia_dense(view: DiaMatrix) -> torch.Tensor:
    """A square DIA view's (n, n) dense matrix."""
    n = view.n_rows
    dense = torch.zeros((n, n), dtype=view.dtype, device=view.device)
    rows = torch.arange(n, device=view.device)
    for d, o in enumerate(view.offsets.tolist()):
        cols = rows + o
        ok = (cols >= 0) & (cols < n)
        dense.index_put_((rows[ok], cols[ok]), view.dvals[d][ok],
                         accumulate=True)
    return dense


def _landings(o: int, n: int, periodic: bool):
    """[(delta, mask)] for one dim: where i + o lands, as a shift ``delta``
    of i and the (n,) mask of the i that land there. In the box first;
    a periodic dim adds the wrapped landings."""
    i = np.arange(n)
    if not periodic:
        inside = (i + o >= 0) & (i + o < n)
        return [(o, inside)] if inside.any() else []
    delta = np.mod(i + o, n) - i
    return [(int(v), delta == v)
            for v in sorted(set(delta.tolist()), key=lambda v: v != o)]


@functools.lru_cache(maxsize=256)
def plane_layout(offsets: tuple, shape: tuple, periodic: tuple):
    """For each plane of the DIA view: (stencil entry, flat offset, per-dim
    masks as numpy bool arrays), in stencil order."""
    strides = [int(np.prod(shape[d + 1:])) for d in range(len(shape))]
    layout = []
    for s, off in enumerate(offsets):
        dims = [_landings(int(off[d]), shape[d], periodic[d])
                for d in range(len(shape))]
        for combo in itertools.product(*dims):
            flat = sum(delta * strides[d] for d, (delta, _) in
                       enumerate(combo))
            layout.append((s, flat, tuple(m for _, m in combo)))
    return tuple(layout)


def dia_view(A: StructMatrix, specialize: bool = True) -> DiaMatrix:
    """A as flat diagonals (see the module docstring). ``specialize``:
    give the view its offsets as static, so the card runs the kernel with
    the offsets compiled in, when the plane count is on that kernel's
    ladder; else the dynamic kernel runs."""
    layout = plane_layout(A.stencil.offsets, A.shape, A.periodic)
    ndim = A.ndim
    planes, offsets = [], []
    for s, flat, masks in layout:
        mask = None
        for d, m in enumerate(masks):
            if m.all():
                continue
            md = torch.from_numpy(m).to(A.device).reshape(
                [-1 if e == d else 1 for e in range(ndim)])
            mask = md if mask is None else mask & md
        c = A.coeff(s)
        plane = c if mask is None else torch.where(mask, c, torch.zeros(
            (), dtype=A.dtype, device=A.device))
        planes.append(plane.expand(A.shape).reshape(-1))
        offsets.append(int(flat))
    if not planes:  # an operator with no entry in the box
        planes, offsets = [torch.zeros(A.n_rows, dtype=A.dtype,
                                       device=A.device)], [0]
    offs = tuple(offsets)
    return DiaMatrix(
        dvals=torch.stack(planes), offsets=offs,
        n_cols=A.n_rows,
        offsets_static=offs if specialize and on_static_ladder(len(offs))
        else None)


def struct_matvec(A: StructMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x as the reference computes it (hypre_StructMatvecCompute,
    ``struct_matvec.c:92``): shifted copies of x summed in stencil order.
    CPU tensors only — on the card the DIA view runs (``A.mv``)."""
    if x.is_cuda:
        raise ValueError("struct_matvec is the plain version for CPU "
                         "tensors; on a CUDA tensor use A.mv (the DIA "
                         "kernels)")
    y = None
    for s, off in enumerate(A.stencil.offsets):
        term = A.coeffs[s] * shift(x, off, A.periodic)
        y = term if y is None else y + term
    return y


def struct_matvec_t(A: StructMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A.T @ x: scatter form — shift(coeff*x, -offset) summed.
    CPU tensors only — on the card the DIA view runs (``A.mv_t``)."""
    if x.is_cuda:
        raise ValueError("struct_matvec_t is the plain version for CPU "
                         "tensors; on a CUDA tensor use A.mv_t (the DIA "
                         "view)")
    y = None
    for s, off in enumerate(A.stencil.offsets):
        term = shift(A.coeffs[s] * x, tuple(-o for o in off), A.periodic)
        y = term if y is None else y + term
    return y


def struct_from_dense_coeffs(
    coeff_map: dict, shape: tuple[int, ...], periodic=None, dtype=None,
    device=None,
) -> StructMatrix:
    """Build from {offset: coefficient (scalar or array)} — the analogue of
    HYPRE_StructMatrixSetBoxValues over the whole grid — on ``device``
    (CUDA unless the caller names another), float32 unless ``dtype``."""
    device = resolve_device(device)
    dtype = dtype or torch.float32
    offsets = tuple(coeff_map.keys())
    constant = all(np.ndim(c) == 0 for c in coeff_map.values())
    arrs = []
    for off in offsets:
        c = coeff_map[off]
        c = torch.as_tensor(c if isinstance(c, torch.Tensor)
                            else np.asarray(c), dtype=dtype).to(device)
        arrs.append(c if constant else c.expand(tuple(shape)))
    return StructMatrix(
        coeffs=torch.stack(arrs),
        stencil=StructStencil(offsets),
        shape=tuple(shape),
        periodic=periodic,
    )
