"""GSMG — geometrically smooth multigrid (smoothed-vector interpolation).

Counterpart of ``hypre_tpu/amg/gsmg.py`` (hypre's ``parcsr_ls/par_gsmg.c``,
solvers 13-15 of its IJ test program): instead of deriving the weights from
matrix entries, sample the near-nullspace by relaxing A x = 0 from
pseudo-random starts (the "smooth vectors") and fit each F row's weights
by least squares, so that interpolation reproduces the smooth vectors on
the strong-C pattern:

    min_w  sum_s ( v_s[i] - sum_{j in C_i} w_j v_s[j] )^2

hypre solves the per-row problem with LAPACK ``dgels``
(par_gsmg.c:708); here every row solves at once as one batched (n, k, k)
normal-equations system on the hierarchy's device. PMIS, the Galerkin
product and the cycles are the facade's.
"""

from __future__ import annotations

import dataclasses

import torch

from hypre_tpu_torch.amg.boomeramg import BoomerAMG
from hypre_tpu_torch.amg.coarsen import C_PT, coarse_map, pmis
from hypre_tpu_torch.amg.hierarchy import (
    AMGHierarchy, Level, _coarse_pinv, _level_vectors, _reciprocal,
)
from hypre_tpu_torch.amg.interp import truncate_interp
from hypre_tpu_torch.amg.strength import strength_mask
from hypre_tpu_torch.core.config import PAD_COL, hash_rand01
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.spgemm import ell_filter, ell_spgemm, ell_transpose


def smooth_vectors(A: EllMatrix, num: int = 6,
                   sweeps: int = 10) -> torch.Tensor:
    """(n, num) near-nullspace samples: damped Jacobi (weight 0.7) on
    A x = 0 from the hash starts ``hash_rand01(i + 7919 s) - 0.5``, with
    unit-norm columns (par_gsmg.c's smooth vector generation)."""
    n = A.n_rows
    dinv = _reciprocal(A.diagonal())
    idx = torch.arange(n, dtype=torch.int32, device=A.device)
    V = torch.stack([hash_rand01(idx + 7919 * s).to(A.dtype) - 0.5
                     for s in range(num)], dim=1)
    for _ in range(sweeps):
        V = V - 0.7 * dinv[:, None] * torch.stack(
            [A.mv(V[:, s].contiguous()) for s in range(num)], dim=1)
    norms = torch.linalg.vector_norm(V, dim=0)
    return V / torch.clamp(norms, min=1e-30)[None, :]


def ls_interp(A: EllMatrix, S: torch.Tensor, cf: torch.Tensor,
              cmap: torch.Tensor, n_coarse: int, V: torch.Tensor,
              ridge: float = 1e-8) -> EllMatrix:
    """Least-squares interpolation over the strong-C pattern fitted to the
    smooth vectors V (hypre_BoomerAMGBuildInterpLS). Masked slots reduce
    to ``ridge * I`` and solve to w = 0."""
    n, k = A.cols.shape
    cols_c = A.cols.clamp(min=0).long()
    patt_mask = S & (cf[cols_c] == C_PT)
    # per row: G w = rhs with G = Vc Vc^T (k x k), rhs = Vc v_i
    Vc = torch.where(patt_mask[..., None], V[cols_c],
                     torch.zeros((), dtype=V.dtype, device=V.device))
    G = torch.einsum("nks,nls->nkl", Vc, Vc)
    G = G + ridge * torch.eye(k, dtype=A.dtype, device=A.device)[None]
    rhs = torch.einsum("nks,ns->nk", Vc, V)
    w = torch.linalg.solve(G, rhs[..., None])[..., 0]
    w = torch.where(patt_mask, w, torch.zeros_like(w))

    is_c = cf == C_PT
    is_f = ~is_c
    p_cols = torch.where(is_f[:, None] & patt_mask, cmap[cols_c],
                         PAD_COL).to(torch.int32)
    p_vals = torch.where(is_f[:, None], w, torch.zeros_like(w))
    own = torch.where(is_c, cmap, PAD_COL).to(torch.int32)[:, None]
    ones = is_c.to(A.dtype)[:, None]
    P = EllMatrix(vals=torch.cat([p_vals, ones], dim=1),
                  cols=torch.cat([p_cols, own], dim=1),
                  n_cols=int(n_coarse))
    P = ell_filter(P, P.structural_mask())
    width = max(int(P.structural_mask().sum(dim=1).max()), 1)
    return EllMatrix(vals=P.vals[:, :width], cols=P.cols[:, :width],
                     n_cols=P.n_cols)


@dataclasses.dataclass
class GSMG(BoomerAMG):
    """HYPRE_BoomerAMGSetGSMG: a BoomerAMG whose interpolation is the
    smoothed-vector least-squares fit. Every other knob is the facade's
    (optimize, weights, Chebyshev, cycles, solve)."""

    num_smooth_vectors: int = 6
    smooth_sweeps: int = 10

    def _do_setup(self, A: EllMatrix, where: torch.device) -> None:
        need_cheby = self.relax == "chebyshev"
        levels = []
        V = smooth_vectors(A, self.num_smooth_vectors, self.smooth_sweeps)
        while (len(levels) < self.max_levels - 1
               and A.n_rows > self.max_coarse_size):
            S = strength_mask(A, self.strength_threshold)
            cf = pmis(A, S)
            cmap, n_c = coarse_map(cf)
            n_coarse = int(n_c)
            if n_coarse == 0 or n_coarse >= 0.9 * A.n_rows:
                break
            P = ls_interp(A, S, cf, cmap, n_coarse, V)
            P = truncate_interp(P, max_elmts=self.p_max_elmts,
                                trunc_factor=self.trunc_factor)
            Pt = ell_transpose(P)
            A_c = ell_spgemm(Pt, ell_spgemm(A, P))
            dinv, l1inv, lmax = _level_vectors(A, need_cheby)
            levels.append(Level(A=A, P=P, Pt=Pt, dinv=dinv, l1inv=l1inv,
                                lmax=lmax))
            # the smooth vectors restrict to the coarse grid by injection
            V = V[cf == C_PT]
            A = A_c
        self.hierarchy = AMGHierarchy(levels=levels,
                                      coarse_inv=_coarse_pinv(A))
