"""SparseMSG — multiple semicoarsened grids (``struct_ls/sparse_msg*.c``).

Counterpart of ``hypre_tpu/struct/sparse_msg.py``. PFMG picks ONE
semicoarsening direction per level; MSG (Schaffer/Mulder) keeps the whole
*lattice* of semicoarsened grids — grid (l_0..l_{d-1}) is the original box
coarsened l_i times in direction i — restricting residuals down every
direction and averaging the prolonged corrections back
(hypre_SparseMSGSetup ``sparse_msg_setup.c``, cycle ``sparse_msg_solve.c``).

The lattice is a dict of grids; each edge (g -> g+e_d) carries PFMG's
operator-induced SemiInterp, and each grid's operator is the Galerkin RAP
recovered by stencil probing (every operator applies through its DIA
view). One cycle sweeps the lattice in topological order (by total
coarsening depth), relaxing and restricting with 1/num_parents averaging
on the way down, direct-solving the deepest corner, and prolonging with
1/num_children averaging on the way up.

``jump`` is hypre's SparseMSG knob (``HYPRE_StructSparseMSGSetJump``,
driver flag ``-jump``): relaxation is skipped on intermediate grids with
total depth <= jump.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple

import torch

from hypre_tpu_torch.core.config import ConvergenceInfo, make_convergence_info
from hypre_tpu_torch.struct.jacobi import stationary_solve
from hypre_tpu_torch.struct.matrix import StructMatrix
from hypre_tpu_torch.struct.pfmg import coarse_pinv, mg_precond
from hypre_tpu_torch.struct.probe import probe_stencil, semi_rap_apply
from hypre_tpu_torch.struct.relax import (
    diag_inverse, parity_mask, red_black_gs, weighted_jacobi,
)
from hypre_tpu_torch.struct.semi import (
    SemiInterp, coarse_shape, semi_interp_from_matrix,
)

Key = Tuple[int, ...]


@dataclasses.dataclass
class SparseMSG:
    """HYPRE_StructSparseMSG* object protocol (HYPRE_struct_ls.h)."""

    max_depth: int = 25          # per-direction semicoarsening limit
    jump: int = 0                # skip relaxation on grids with depth <= jump
    relax_type: str = "rb-gs"    # 'jacobi' | 'rb-gs'
    jacobi_weight: float = 2.0 / 3.0
    num_pre_relax: int = 1
    num_post_relax: int = 1

    A: Dict[Key, StructMatrix] = dataclasses.field(default=None, repr=False)
    P: Dict[Tuple[Key, int], SemiInterp] = dataclasses.field(
        default=None, repr=False)
    dinv: Dict[Key, torch.Tensor] = dataclasses.field(default=None,
                                                      repr=False)
    red: Dict[Key, torch.Tensor] = dataclasses.field(default=None,
                                                     repr=False)
    coarse_inv: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                           repr=False)
    _order: list = dataclasses.field(default=None, repr=False)

    def setup(self, A: StructMatrix) -> "SparseMSG":
        ndim = A.ndim
        # per-direction depth: halve until the dim can't coarsen
        depths = []
        for d in range(ndim):
            n, lv = A.shape[d], 0
            while n >= 3 and lv < self.max_depth:
                n = -(-n // 2)
                lv += 1
            depths.append(lv)
        self.A, self.P, self.dinv, self.red = {}, {}, {}, {}
        origin = (0,) * ndim
        self.A[origin] = A
        lattice = list(itertools.product(*(range(lv + 1) for lv in depths)))
        lattice.sort(key=sum)
        self._order = lattice
        for g in lattice:
            if g != origin:
                # A_g by semicoarsening from the first nonzero dim's parent
                # (sparse_msg_setup.c builds the same directional RAPs)
                d = next(i for i in range(ndim) if g[i] > 0)
                parent = tuple(v - (1 if i == d else 0)
                               for i, v in enumerate(g))
                Ap = self.A[parent]
                ext = tuple(1 if i == d else max(Ap.stencil.extent[i], 0)
                            for i in range(ndim))
                self.A[g] = probe_stencil(
                    semi_rap_apply, coarse_shape(Ap.shape, d), ext,
                    Ap.dtype, periodic=Ap.periodic,
                    operands=(Ap, self.P[(parent, d)]), device=Ap.device)
            Ag = self.A[g]
            self.dinv[g] = diag_inverse(Ag)
            self.red[g] = parity_mask(Ag.shape, Ag.device)
            for d in range(ndim):
                child = tuple(v + (1 if i == d else 0)
                              for i, v in enumerate(g))
                if all(c <= lv for c, lv in zip(child, depths)):
                    self.P[(g, d)] = semi_interp_from_matrix(Ag, d)
        self.coarse_inv = coarse_pinv(self.A[tuple(depths)])
        return self

    # -- cycle ----------------------------------------------------------------

    def _smooth(self, g: Key, u, f, sweeps: int):
        if sum(g) != 0 and sum(g) <= self.jump:
            return u  # hypre's jump: no relaxation on the skipped band
        A, dinv, red = self.A[g], self.dinv[g], self.red[g]
        for _ in range(sweeps):
            if self.relax_type == "jacobi":
                u = weighted_jacobi(A, dinv, u, f, self.jacobi_weight)
            else:
                u = red_black_gs(A, dinv, red, u, f)
        return u

    def _nparents(self, g: Key) -> int:
        return sum(1 for v in g if v > 0)

    def _children(self, g: Key):
        for d in range(len(g)):
            child = tuple(v + (1 if i == d else 0) for i, v in enumerate(g))
            if (g, d) in self.P:
                yield d, child

    def cycle(self, f: torch.Tensor,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One MSG lattice cycle (hypre_SparseMSGSolve inner loop)."""
        assert self.A is not None, "call setup(A) first"
        origin = self._order[0]
        corner = self._order[-1]
        fmap: Dict[Key, torch.Tensor] = {origin: f}
        umap: Dict[Key, torch.Tensor] = {
            origin: torch.zeros_like(f) if u is None else u}
        # descend in topological order
        for g in self._order:
            if g == corner:
                continue
            ug = self._smooth(g, umap[g], fmap[g], self.num_pre_relax)
            umap[g] = ug
            r = fmap[g] - self.A[g].mv(ug)
            for d, child in self._children(g):
                contrib = self.P[(g, d)].apply_t(r) / self._nparents(child)
                if child in fmap:
                    fmap[child] = fmap[child] + contrib
                else:
                    fmap[child] = contrib
                    umap[child] = torch.zeros_like(contrib)
        # deepest corner: dense direct solve
        umap[corner] = (self.coarse_inv @ fmap[corner].reshape(-1)).reshape(
            self.A[corner].shape)
        # ascend: children fully corrected before parents read them
        for g in reversed(self._order):
            if g == corner:
                continue
            kids = list(self._children(g))
            ug = umap[g]
            for d, child in kids:
                ug = ug + self.P[(g, d)].apply(umap[child]) / len(kids)
            umap[g] = self._smooth(g, ug, fmap[g], self.num_post_relax)
        return umap[origin]

    def precond(self):
        return mg_precond(self.cycle, self.A[self._order[0]].shape)

    def solve(
        self,
        b: torch.Tensor,
        x0: Optional[torch.Tensor] = None,
        rtol: float = 1e-6,
        maxiter: int = 100,
    ) -> tuple[torch.Tensor, ConvergenceInfo]:
        x, info = stationary_solve(lambda x: self.cycle(b, x),
                                   self.A[self._order[0]], b, x0, rtol,
                                   maxiter)
        rel = float(info.relative_residual)
        return x, make_convergence_info(int(info.iterations), rel,
                                        rel <= rtol)
