"""SMG — semicoarsening multigrid with plane/line relaxation.

Counterpart of ``hypre_tpu/struct/smg.py`` (hypre's SMG,
``struct_ls/smg.c``, ``smg_setup.c:17``, ``smg_relax.c``): coarsen the last
dimension by 2 each level; smooth with zebra plane relaxation — solve all
same-parity planes perpendicular to the coarsening direction at once,
alternately for even and odd parity.

Plane solves:
- 1-D grids: parallel cyclic reduction, an exact tridiagonal solve;
- 2-D grids: each plane is a line along axis 0 -> batched exact PCR solves
  over all lines of one parity at once;
- 3-D grids: each plane is a 2-D problem, solved with one recursive 2-D SMG
  V-cycle (``smg_relax.c``), batched over all planes of one parity: the
  within-plane operator (the stencil entries with zero cdir-offset) is
  block-diagonal over planes, so one 2-D SMG hierarchy built on it
  (``PlaneSMG``) serves every plane (``plane_relax='smg'``, the default);
  ``plane_relax='lines'`` keeps the cheaper alternating-line approximation.

Interpolation weights come from plane solves as in hypre
(``smg_setup_interp.c``, ``_plane_interp``), or from the collapsed operator
(``interp='collapsed'``). Post-smoothing runs the parities in reverse
order, so the V-cycle is symmetric (``smg.py:472-510`` of the reference).
Every matvec runs the operator's DIA view (one DIA kernel launch on the
card); the line solves and masks are PyTorch ops.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from hypre_tpu_torch.core.config import ConvergenceInfo, make_convergence_info
from hypre_tpu_torch.struct.cycred import cyclic_reduction_solve, pcr_solve
from hypre_tpu_torch.struct.jacobi import stationary_solve
from hypre_tpu_torch.struct.matrix import StructMatrix, shift
from hypre_tpu_torch.struct.pfmg import (
    coarse_pinv, mg_precond, pruned, read_flags,
)
from hypre_tpu_torch.struct.probe import probe_core, probe_plan, semi_rap_apply
from hypre_tpu_torch.struct.semi import (
    SemiInterp, axis_parity, coarse_shape, semi_interp_from_matrix,
)
from hypre_tpu_torch.struct.stencil import StructStencil


def _line_perm(ndim: int, axis: int):
    """The permutation that moves ``axis`` last (PCR solves along the last
    axis) and its inverse."""
    perm = [d for d in range(ndim) if d != axis] + [axis]
    inv = [perm.index(d) for d in range(ndim)]
    return perm, inv


def _tridiag_along(A: StructMatrix, axis: int):
    """(lo, di, hi) line coefficients along ``axis`` from the stencil
    entries whose offsets vanish off ``axis``."""
    zero = torch.zeros(A.shape, dtype=A.dtype, device=A.device)
    lo, di, hi = zero, zero, zero
    for s, off in enumerate(A.stencil.offsets):
        if any(off[d] != 0 for d in range(A.ndim) if d != axis):
            continue
        c = A.coeff(s)
        if off[axis] == -1:
            lo = lo + c
        elif off[axis] == 0:
            di = di + c
        elif off[axis] == 1:
            hi = hi + c
        else:
            raise ValueError("SMG line relaxation needs extent-1 stencils")
    return lo, di, hi


def _line_system(A: StructMatrix, axis: int):
    """A's tridiagonal part along ``axis``: (lo, di, hi) on the grid and
    the same moved to PCR's layout, built once per operator."""
    def build():
        lo, di, hi = _tridiag_along(A, axis)
        perm, _ = _line_perm(A.ndim, axis)
        return (lo, di, hi), tuple(t.permute(perm).contiguous()
                                   for t in (lo, di, hi))

    return A.cached(("line", axis), build)


def _pcr_along(lines, rhs: torch.Tensor, axis: int) -> torch.Tensor:
    perm, inv = _line_perm(rhs.dim(), axis)
    return pcr_solve(*lines, rhs.permute(perm)).permute(inv)


def _line_solve_update(A: StructMatrix, u, f, line_axis: int, mask):
    """Solve the line systems along ``line_axis`` at points where mask is
    set, holding the rest of u fixed (one colored line-relax half-sweep)."""
    (lo, di, hi), lines = _line_system(A, line_axis)
    # rhs = f - (A - T) u with T the tridiagonal part along line_axis, which
    # PCR solves exactly as a non-wrapping tridiagonal: on a periodic line
    # axis the wraparound couplings stay in the (A - T) u remainder
    no_wrap = tuple(p and d != line_axis for d, p in enumerate(A.periodic))
    e = [0] * A.ndim
    e[line_axis] = 1
    Tu = (di * u + lo * shift(u, tuple(-v for v in e), no_wrap)
          + hi * shift(u, tuple(e), no_wrap))
    rhs = f - A.mv(u) + Tu
    sol = _pcr_along(lines, rhs, line_axis)
    return sol if mask is True else torch.where(mask, sol, u)


def _inplane_operator(A: StructMatrix, cdir: int) -> StructMatrix:
    """The within-plane part of A: stencil entries with zero cdir-offset.
    Block-diagonal over the planes perpendicular to cdir — the matrix each
    zebra plane solve inverts (hypre smg_relax.c's residual splitting)."""
    keep = [s for s, off in enumerate(A.stencil.offsets) if off[cdir] == 0]
    return StructMatrix(
        coeffs=A.coeffs[keep],
        stencil=StructStencil(tuple(A.stencil.offsets[s] for s in keep)),
        shape=A.shape,
        periodic=A.periodic,
    )


def _plane_interp(A: StructMatrix, cdir: int, plane) -> SemiInterp:
    """Interpolation weights from PLANE SOLVES (hypre_SMGSetupInterpOp,
    smg_setup_interp.c:54-71): for each transfer direction, mask out A's
    couplings in the opposite cdir direction, set the neighboring coarse
    planes to 1, and solve the in-plane system exactly (batched PCR) or
    with one batched 2-D SMG V-cycle from an all-ones initial guess:

        w_dir = T^{-1} ( -sum of A's coefficients pointing in ``dir`` )
    """
    if any(p for d, p in enumerate(A.periodic) if d != cdir):
        # the exact in-plane solves assume non-wrapping lines; a periodic
        # in-plane axis keeps the operator-collapsed weights
        return semi_interp_from_matrix(A, cdir)
    zero = torch.zeros(A.shape, dtype=A.dtype, device=A.device)
    lo, hi = zero, zero
    for s, off in enumerate(A.stencil.offsets):
        c = A.coeff(s)
        if off[cdir] < 0:
            lo = lo + c
        elif off[cdir] > 0:
            hi = hi + c
    T = _inplane_operator(A, cdir)
    act = [d for d in range(A.ndim)
           if any(off[d] != 0 for off in T.stencil.offsets)]
    if len(act) <= 1:
        # the in-plane system is (at most) tridiagonal along one axis:
        # batched PCR is the exact plane solve
        la = act[0] if act else (1 - cdir if A.ndim > 1 else 0)
        lines = _line_system(T, la)[1]
        w_lo = _pcr_along(lines, -lo, la)
        w_hi = _pcr_along(lines, -hi, la)
    elif plane is not None:
        ones = torch.ones(A.shape, dtype=A.dtype, device=A.device)
        w_lo = plane_smg_vcycle(plane, -lo, ones)
        w_hi = plane_smg_vcycle(plane, -hi, ones)
    else:
        return semi_interp_from_matrix(A, cdir)
    odd = axis_parity(A.shape, cdir, A.device) == 1
    return SemiInterp(
        w_lo=torch.where(odd, w_lo, zero),
        w_hi=torch.where(odd, w_hi, zero),
        cdir=cdir,
        periodic=A.periodic,
    )


def _smg_coarsen(A: StructMatrix, cdir: int, zero_dims: tuple = (),
                 plane=None, plane_interp: bool = False):
    """Interpolation, the probed (unpruned) Galerkin coarse operator, the
    cdir-parity zebra masks and the prune flags of one level. ``zero_dims``:
    dims whose extent is structurally 0 (the plane-SMG batch dim)."""
    cshape = coarse_shape(A.shape, cdir)
    ext = tuple(0 if d in zero_dims
                else max(1 if d == cdir else A.stencil.extent[d], 0)
                for d in range(A.ndim))
    mods, offsets = probe_plan(cshape, ext, A.periodic)
    P = (_plane_interp(A, cdir, plane) if plane_interp
         else semi_interp_from_matrix(A, cdir))
    C, flags = probe_core(semi_rap_apply, cshape, mods, offsets, A.dtype,
                          (A, P), A.device)
    par = axis_parity(A.shape, cdir, A.device)
    Ac = StructMatrix(coeffs=C, stencil=StructStencil(offsets), shape=cshape,
                      periodic=A.periodic)
    return P, Ac, par == 0, par == 1, flags


@dataclasses.dataclass(frozen=True)
class PlaneLevel:
    T: StructMatrix  # batched within-plane operator at this in-plane level
    P: Optional[SemiInterp]  # in-plane semicoarsening interp (None at base)
    even: Optional[torch.Tensor]  # in-plane zebra line masks (None at base)
    odd: Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PlaneSMG:
    """Batched recursive 2-D SMG over all planes perpendicular to cdir: one
    hierarchy holds every plane, the cdir axis riding along as a batch dim
    through the stencil and PCR passes (all offsets are zero in cdir)."""

    levels: List[PlaneLevel]
    line_axis: int
    exact_base: bool


def build_plane_smg(A: StructMatrix, cdir: int,
                    max_levels: int = 25) -> PlaneSMG:
    inplane = [d for d in range(A.ndim) if d != cdir]
    if len(inplane) != 2:
        raise ValueError("plane SMG is the 3-D path")
    line_axis, coarse_axis = inplane
    T = _inplane_operator(A, cdir)
    levels: List[PlaneLevel] = []
    flags_list = []
    while len(levels) < max_levels - 1 and T.shape[coarse_axis] > 1:
        if T.periodic[coarse_axis] and T.shape[coarse_axis] % 2:
            break  # odd periodic dim: stop; the base takes line sweeps
        P, Tc, even, odd, flags = _smg_coarsen(
            T, coarse_axis, zero_dims=(cdir,), plane_interp=True)
        flags_list.append(flags)
        levels.append(PlaneLevel(T=T, P=P, even=even, odd=odd))
        T = Tc
    exact = T.shape[coarse_axis] == 1
    par = axis_parity(T.shape, coarse_axis, T.device)
    levels.append(PlaneLevel(T=T, P=None, even=None if exact else par == 0,
                             odd=None if exact else par == 1))
    for i, fl in zip(range(1, len(levels)), read_flags(flags_list)):
        levels[i] = dataclasses.replace(levels[i], T=pruned(levels[i].T, fl))
    return PlaneSMG(levels=levels, line_axis=line_axis, exact_base=exact)


def _zebra_lines(T: StructMatrix, u, f, la: int, masks) -> torch.Tensor:
    """Colored line half-sweeps, one per mask in order."""
    for m in masks:
        u = _line_solve_update(T, u, f, la, m)
    return u


def plane_smg_vcycle(ps: PlaneSMG, f: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """One batched 2-D SMG V-cycle on the within-plane systems T u = f
    (every plane at once; the caller masks which planes' updates to keep)."""
    la = ps.line_axis

    def descend(lvl: int, f, u):
        lev = ps.levels[lvl]
        if lev.P is None:
            if ps.exact_base:
                # coarsened axis has size 1: T is exactly tridiagonal along
                # the line axis -> one PCR solve is the exact plane solve
                return _line_solve_update(lev.T, u, f, la, True)
            return _zebra_lines(lev.T, u, f, la,
                                (lev.even, lev.odd, lev.odd, lev.even))
        u = _zebra_lines(lev.T, u, f, la, (lev.even, lev.odd))
        r = f - lev.T.mv(u)
        rc = lev.P.apply_t(r)
        ec = descend(lvl + 1, rc, torch.zeros_like(rc))
        u = u + lev.P.apply(ec)
        return _zebra_lines(lev.T, u, f, la, (lev.odd, lev.even))

    return descend(0, f, u)


@dataclasses.dataclass(frozen=True)
class SMGLevel:
    A: StructMatrix
    P: Optional[SemiInterp]
    even: torch.Tensor  # plane-parity masks for zebra relaxation
    odd: torch.Tensor
    plane: Optional[PlaneSMG] = None  # 3-D plane solver (plane_relax='smg')


@dataclasses.dataclass(frozen=True)
class SMGHierarchy:
    levels: List[SMGLevel]
    coarse_inv: torch.Tensor
    coarse_shape: tuple[int, ...]
    coarse_A: StructMatrix

    @property
    def cdirs(self) -> list:
        return [lev.P.cdir for lev in self.levels]


@dataclasses.dataclass
class SMG:
    """HYPRE_StructSMG* object protocol (HYPRE_struct_ls.h)."""

    max_levels: int = 25
    max_coarse_size: int = 32
    num_pre_relax: int = 1
    num_post_relax: int = 1
    # 3-D zebra plane solves: 'smg' = hypre's recursive 2-D SMG per plane
    # (batched over planes, smg_relax.c), 'lines' = alternating-line
    # approximation (cheaper cycles, weaker on strong in-plane coupling)
    plane_relax: str = "smg"
    # 'plane' = interpolation weights from plane solves (hypre's
    # smg_setup_interp.c, the default); 'collapsed' = operator-collapsed
    # semicoarsening weights (cheaper setup, weaker on anisotropy)
    interp: str = "plane"

    hierarchy: Optional[SMGHierarchy] = dataclasses.field(default=None,
                                                          repr=False)

    def setup(self, A: StructMatrix) -> "SMG":
        levels: List[SMGLevel] = []
        flags_list = []
        while (len(levels) < self.max_levels - 1
               and A.n_rows > self.max_coarse_size):
            def can_coarsen(d: int) -> bool:
                if A.shape[d] < 3:
                    return False
                # periodic dims only coarsen while even
                return not (A.periodic[d] and A.shape[d] % 2)

            cdir = A.ndim - 1  # SMG semicoarsens the last dim (smg_setup.c)
            if not can_coarsen(cdir):
                coarsenable = [d for d in range(A.ndim) if can_coarsen(d)]
                if not coarsenable:
                    break
                cdir = coarsenable[-1]
            plane = (build_plane_smg(A, cdir)
                     if A.ndim == 3 and self.plane_relax == "smg" else None)
            P, Ac, even, odd, flags = _smg_coarsen(
                A, cdir, plane=plane, plane_interp=(self.interp == "plane"))
            flags_list.append(flags)
            levels.append(SMGLevel(A=A, P=P, even=even, odd=odd,
                                   plane=plane))
            A = Ac
        # deferred pruning: one read of every level's flags, then the trims
        for i, fl in enumerate(read_flags(flags_list)):
            if i + 1 < len(levels):
                levels[i + 1] = dataclasses.replace(
                    levels[i + 1], A=pruned(levels[i + 1].A, fl))
            else:
                A = pruned(A, fl)
        self.hierarchy = SMGHierarchy(
            levels=levels, coarse_inv=coarse_pinv(A), coarse_shape=A.shape,
            coarse_A=A)
        return self

    # -- zebra plane relaxation (smg_relax.c) ---------------------------------

    def _relax(self, lev: SMGLevel, u, f, sweeps: int,
               reverse: bool = False):
        """reverse=True flips the zebra parity order (post-smoothing runs
        odd->even so the V-cycle is symmetric — hypre's pre/post RegSpace
        orderings in smg_relax.c; without it SMG-PCG stalls)."""
        A = lev.A
        cdir = lev.P.cdir if lev.P is not None else A.ndim - 1
        par = (lev.odd, lev.even) if reverse else (lev.even, lev.odd)
        for _ in range(sweeps):
            if A.ndim == 1:
                return cyclic_reduction_solve(A, f)  # tridiagonal: exact
            if A.ndim == 2:
                # plane = exact line solve along the other axis
                u = _zebra_lines(A, u, f, 1 - cdir, par)
            elif lev.plane is not None:
                # true plane solve: rhs freezes the off-plane coupling, one
                # batched 2-D SMG V-cycle inverts T on every plane, and the
                # zebra mask keeps this parity's planes only
                T0 = lev.plane.levels[0].T
                for mask in par:
                    rhs = f - A.mv(u) + T0.mv(u)
                    u_new = plane_smg_vcycle(lev.plane, rhs, u)
                    u = torch.where(mask, u_new, u)
            else:
                # alternating in-plane line relaxation per plane parity
                axes = [d for d in range(A.ndim) if d != cdir]
                for mask in par:
                    for la in axes:
                        u = _line_solve_update(A, u, f, la, mask)
        return u

    def cycle(self, f: torch.Tensor,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
        hier = self.hierarchy
        assert hier is not None, "call setup(A) first"

        def descend(level: int, f, u):
            if level == len(hier.levels):
                xc = hier.coarse_inv @ f.reshape(-1)
                return xc.reshape(hier.coarse_shape)
            lev = hier.levels[level]
            u = self._relax(lev, u, f, self.num_pre_relax)
            r = f - lev.A.mv(u)
            rc = lev.P.apply_t(r)
            ec = descend(level + 1, rc, torch.zeros_like(rc))
            u = u + lev.P.apply(ec)
            return self._relax(lev, u, f, self.num_post_relax, reverse=True)

        if u is None:
            u = torch.zeros_like(f)
        return descend(0, f, u)

    def precond(self):
        hier = self.hierarchy
        shape = hier.levels[0].A.shape if hier.levels else hier.coarse_shape
        return mg_precond(self.cycle, shape)

    def solve(
        self,
        b: torch.Tensor,
        x0: Optional[torch.Tensor] = None,
        rtol: float = 1e-6,
        maxiter: int = 200,
    ) -> tuple[torch.Tensor, ConvergenceInfo]:
        hier = self.hierarchy
        assert hier is not None, "call setup(A) first"
        if not hier.levels:
            x = (hier.coarse_inv @ b.reshape(-1)).reshape(hier.coarse_shape)
            return x, make_convergence_info(1, 0.0, True)
        return stationary_solve(lambda x: self.cycle(b, x), hier.levels[0].A,
                                b, x0, rtol, maxiter)
