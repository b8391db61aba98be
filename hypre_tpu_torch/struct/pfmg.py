"""PFMG — semicoarsening multigrid for structured grids.

Counterpart of ``hypre_tpu/struct/pfmg.py`` (hypre's PFMG,
``struct_ls/pfmg_setup.c:63``, ``pfmg_solve.c:31``): per level, pick the
coarsening direction with the smallest effective mesh size
(hypre_PFMGComputeDxyz, ``pfmg_setup.c:174``), build operator-induced
semicoarsening interpolation (``pfmg_setup_interp.c``), form the Galerkin
coarse operator by lattice probing (replacing ``pfmg_setup_rap*.c``) and
V-cycle with weighted-Jacobi or red-black Gauss-Seidel smoothing.

Setup runs every level unpruned (zero fill coefficients are numerically
inert) and reads all levels' prune flags back once at the end; the solve is
a host loop with one read per iteration. Every operator applies through
its DIA view, so on the card each matvec is one DIA kernel launch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from hypre_tpu_torch.core.config import ConvergenceInfo, make_convergence_info
from hypre_tpu_torch.struct.jacobi import stationary_solve
from hypre_tpu_torch.struct.matrix import StructMatrix
from hypre_tpu_torch.struct.probe import (
    probe_core, probe_plan, prune_keep, semi_rap_apply,
)
from hypre_tpu_torch.struct.relax import (
    diag_inverse, parity_mask, red_black_gs, weighted_jacobi,
)
from hypre_tpu_torch.struct.semi import (
    SemiInterp, coarse_shape, semi_interp_from_matrix,
)
from hypre_tpu_torch.struct.stencil import StructStencil


def coarse_pinv(A: StructMatrix) -> torch.Tensor:
    """Pseudo-inverse of the coarsest operator, computed on the host (so
    the card and the CPU get the same bits) with the reference's cutoff:
    JAX's ``pinv`` drops singular values below 10 * max(m, n) * eps times
    the largest (torch's default is max(m, n) * eps); a singular coarsest
    operator, such as a periodic Laplacian's, depends on it."""
    dense = A.to_dense().cpu()
    rtol = 10 * max(dense.shape) * torch.finfo(dense.dtype).eps
    return torch.linalg.pinv(dense, rtol=rtol).to(A.device)


def compute_cxyz(A: StructMatrix) -> torch.Tensor:
    """Per-dim coupling strengths c_d = sum over the offsets that move in d
    of mean |coefficient|, in A's dtype and the reference's order (offsets
    summed in stencil order, each a mean)."""
    acc = []
    for d in range(A.ndim):
        terms = [torch.mean(torch.abs(A.coeffs[s]))
                 for s, off in enumerate(A.stencil.offsets) if off[d] != 0]
        acc.append(sum(terms) if terms else torch.zeros(
            (), dtype=A.dtype, device=A.device))
    return torch.stack(acc)


def compute_dxyz(A: StructMatrix) -> np.ndarray:
    """Effective mesh sizes from matrix coefficients
    (hypre_PFMGComputeDxyz, pfmg_setup.c:768): dxyz_d = 1/sqrt(c_d)."""
    cxyz = compute_cxyz(A).cpu().numpy().astype(np.float64)
    cmax = cxyz.max() if cxyz.max() > 0 else 1.0
    cxyz = np.where(cxyz > 0, cxyz, 1e-30 * cmax)
    return 1.0 / np.sqrt(cxyz)


def pruned(M: StructMatrix, flags) -> StructMatrix:
    """M without the stencil entries whose prune flag (host array) is
    clear; the centre always stays."""
    keep = prune_keep(M.stencil.offsets, flags)
    if len(keep) == len(M.stencil.offsets):
        return M
    return StructMatrix(
        coeffs=M.coeffs[keep],
        stencil=StructStencil(tuple(M.stencil.offsets[s] for s in keep)),
        shape=M.shape,
        periodic=M.periodic,
    )


def read_flags(flags_list) -> list:
    """One read of a list of per-level flag vectors."""
    if not flags_list:
        return []
    lens = [int(f.shape[0]) for f in flags_list]
    allf = torch.cat([f.to(torch.int8) for f in flags_list]).cpu().numpy()
    return np.split(allf, np.cumsum(lens)[:-1])


def mg_precond(cycle, shape):
    """Krylov M from a cycle: works on grid-shaped or raveled vectors."""
    def M(r):
        flat = r.dim() == 1
        z = cycle(r.reshape(shape) if flat else r)
        return z.reshape(-1) if flat else z

    return M


@dataclasses.dataclass(frozen=True)
class PFMGLevel:
    A: StructMatrix
    P: Optional[SemiInterp]  # None on the coarsest level
    dinv: torch.Tensor
    red: torch.Tensor  # checkerboard mask for RB-GS


@dataclasses.dataclass(frozen=True)
class PFMGHierarchy:
    levels: List[PFMGLevel]
    coarse_inv: torch.Tensor  # dense pseudo-inverse of the coarsest operator
    coarse_shape: tuple[int, ...]
    coarse_A: StructMatrix

    @property
    def cdirs(self) -> list:
        return [lev.P.cdir for lev in self.levels]


@dataclasses.dataclass
class PFMG:
    """HYPRE_StructPFMG* object protocol (HYPRE_struct_ls.h)."""

    max_levels: int = 25
    max_coarse_size: int = 32
    relax_type: str = "rb-gs"  # 'jacobi' | 'rb-gs'  (hypre 1 | 2)
    jacobi_weight: float = 2.0 / 3.0
    num_pre_relax: int = 1
    num_post_relax: int = 1

    hierarchy: Optional[PFMGHierarchy] = dataclasses.field(default=None,
                                                           repr=False)

    def setup(self, A: StructMatrix) -> "PFMG":
        levels: List[PFMGLevel] = []
        dxyz = compute_dxyz(A)
        flags_list = []
        while (len(levels) < self.max_levels - 1
               and A.n_rows > self.max_coarse_size):
            # coarsen the dim with the smallest effective mesh size that can
            # still coarsen (pfmg_setup.c:224-235); x2 per coarsening (:328);
            # periodic dims coarsen only while even
            candidates = [
                d for d in range(A.ndim)
                if A.shape[d] >= 3 and not (A.periodic[d] and A.shape[d] % 2)
            ]
            if not candidates:
                break
            cdir = min(candidates, key=lambda d: dxyz[d])
            dxyz = dxyz.copy()
            dxyz[cdir] *= 2

            cshape = coarse_shape(A.shape, cdir)
            ext = tuple(max(1 if d == cdir else A.stencil.extent[d], 0)
                        for d in range(A.ndim))
            mods, offsets = probe_plan(cshape, ext, A.periodic)
            P = semi_interp_from_matrix(A, cdir)
            C, flags = probe_core(semi_rap_apply, cshape, mods, offsets,
                                  A.dtype, (A, P), A.device)
            flags_list.append(flags)
            levels.append(PFMGLevel(A=A, P=P, dinv=diag_inverse(A),
                                    red=parity_mask(A.shape, A.device)))
            A = StructMatrix(coeffs=C, stencil=StructStencil(offsets),
                             shape=cshape, periodic=A.periodic)

        # the single read: every level's flags, then the trims
        for i, fl in enumerate(read_flags(flags_list)):
            if i + 1 < len(levels):
                levels[i + 1] = dataclasses.replace(
                    levels[i + 1], A=pruned(levels[i + 1].A, fl))
            else:
                A = pruned(A, fl)
        self.hierarchy = PFMGHierarchy(
            levels=levels, coarse_inv=coarse_pinv(A), coarse_shape=A.shape,
            coarse_A=A)
        return self

    # -- cycle ---------------------------------------------------------------

    def _smooth(self, lev: PFMGLevel, u, f, sweeps: int):
        for _ in range(sweeps):
            if self.relax_type == "jacobi":
                u = weighted_jacobi(lev.A, lev.dinv, u, f, self.jacobi_weight)
            else:
                u = red_black_gs(lev.A, lev.dinv, lev.red, u, f)
        return u

    def cycle(self, f: torch.Tensor,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One V-cycle (hypre_PFMGSolve's inner cycle, pfmg_solve.c:31)."""
        hier = self.hierarchy
        assert hier is not None, "call setup(A) first"

        def descend(level: int, f, u):
            if level == len(hier.levels):
                xc = hier.coarse_inv @ f.reshape(-1)
                return xc.reshape(hier.coarse_shape)
            lev = hier.levels[level]
            u = self._smooth(lev, u, f, self.num_pre_relax)
            r = f - lev.A.mv(u)
            rc = lev.P.apply_t(r)
            ec = descend(level + 1, rc, torch.zeros_like(rc))
            u = u + lev.P.apply(ec)
            return self._smooth(lev, u, f, self.num_post_relax)

        if u is None:
            u = torch.zeros_like(f)
        return descend(0, f, u)

    def precond(self):
        """Plug into Krylov M (HYPRE_StructPCGSetPrecond analogue). Works on
        either grid-shaped or raveled vectors."""
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
