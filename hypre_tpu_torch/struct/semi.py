"""Semicoarsening transfer operators (hypre struct_ls/semi*.c).

Counterpart of ``hypre_tpu/struct/semi.py``. Stride-2 coarsening in one
direction ``cdir``: coarse points are fine points with even index in
``cdir``. Interpolation at an odd fine point uses the two coarse neighbors
with operator-induced weights from collapsing the fine stencil
perpendicular to ``cdir`` (hypre_PFMGSetupInterpOp,
``struct_ls/pfmg_setup_interp.c``):

    w_lo = -(sum of coefficients with offset_cdir < 0) / (sum with offset_cdir = 0)
    w_hi = -(sum of coefficients with offset_cdir > 0) / (same)

Application is injection + two shifted multiplies; restriction is the
exact transpose, taken by a strided slice. Vectors may carry leading batch
dims (the probes).
"""

from __future__ import annotations

import dataclasses

import torch

from hypre_tpu_torch.struct.matrix import StructMatrix, shift


def coarse_shape(shape: tuple[int, ...], cdir: int) -> tuple[int, ...]:
    """C-points sit at even indices: coarse size = ceil(n/2)."""
    return tuple(-(-n // 2) if d == cdir else n for d, n in enumerate(shape))


def axis_parity(shape, axis: int, device) -> torch.Tensor:
    """(shape) int tensor: the index along ``axis``, mod 2."""
    iota = torch.arange(shape[axis], device=device).reshape(
        [-1 if e == axis else 1 for e in range(len(shape))])
    return (iota % 2).expand(tuple(shape))


@dataclasses.dataclass(frozen=True)
class SemiInterp:
    """P: coarse -> fine for stride-2 semicoarsening in ``cdir``.

    w_lo/w_hi: (fine_shape) weights, nonzero only at odd-in-cdir points.
    periodic: the grid's periodicity; interpolation at the wrap seam reads
    the coarse neighbor on the other side.
    """

    w_lo: torch.Tensor
    w_hi: torch.Tensor
    cdir: int
    periodic: tuple[bool, ...] = None

    @property
    def fine_shape(self) -> tuple[int, ...]:
        return tuple(self.w_lo.shape)

    @property
    def coarse_shape(self) -> tuple[int, ...]:
        return coarse_shape(self.fine_shape, self.cdir)

    def _unit(self) -> tuple[int, ...]:
        e = [0] * self.w_lo.dim()
        e[self.cdir] = 1
        return tuple(e)

    def _cslices(self):
        return (Ellipsis,) + tuple(
            slice(None, None, 2) if d == self.cdir else slice(None)
            for d in range(self.w_lo.dim()))

    def apply(self, xc: torch.Tensor) -> torch.Tensor:
        """fine = P @ coarse (hypre_SemiInterp, semi_interp.c)."""
        lead = tuple(xc.shape[:xc.dim() - self.w_lo.dim()])
        xe = xc.new_zeros(lead + self.fine_shape)
        xe[self._cslices()] = xc
        e = self._unit()
        ne = tuple(-v for v in e)
        p = self.periodic
        return xe + self.w_lo * shift(xe, ne, p) + self.w_hi * shift(xe, e, p)

    def apply_t(self, r: torch.Tensor) -> torch.Tensor:
        """coarse = P.T @ fine (hypre_SemiRestrict, semi_restrict.c)."""
        e = self._unit()
        ne = tuple(-v for v in e)
        p = self.periodic
        acc = r + shift(self.w_lo * r, e, p) + shift(self.w_hi * r, ne, p)
        return acc[self._cslices()].contiguous()


def semi_interp_from_matrix(A: StructMatrix, cdir: int) -> SemiInterp:
    """Operator-induced weights (hypre_PFMGSetupInterpOp,
    pfmg_setup_interp.c): collapse A perpendicular to cdir."""
    if A.periodic[cdir] and A.shape[cdir] % 2 != 0:
        raise NotImplementedError(
            "semicoarsening a periodic dim requires an even grid size "
            f"(dim {cdir} has {A.shape[cdir]})"
        )
    zero = torch.zeros(A.shape, dtype=A.dtype, device=A.device)
    lo, hi, center = zero, zero, zero
    for s, off in enumerate(A.stencil.offsets):
        c = A.coeff(s)
        if off[cdir] < 0:
            lo = lo + c
        elif off[cdir] > 0:
            hi = hi + c
        else:
            center = center + c
    nz = center != 0
    safe = torch.where(nz, center, torch.ones_like(center))
    w_lo = torch.where(nz, -lo / safe, zero)
    w_hi = torch.where(nz, -hi / safe, zero)
    # zero the weights at C-points (even index in cdir) — P injects there
    odd = axis_parity(A.shape, cdir, A.device) == 1
    return SemiInterp(
        w_lo=torch.where(odd, w_lo, zero),
        w_hi=torch.where(odd, w_hi, zero),
        cdir=cdir,
        periodic=A.periodic,
    )
