"""Smoothed-aggregation AMG — the MLI (femli) layer of hypre.

Counterpart of ``hypre_tpu/amg/smoothed_agg.py`` (hypre's
``FEI_mv/femli/mli_method_amgsa.cxx``): group the unknowns into
aggregates over the symmetrized strength graph, build a tentative
prolongator whose columns are the near-nullspace B restricted to each
aggregate (orthonormalized per aggregate), and smooth it with one damped
Jacobi sweep,

    P = (I - omega D^{-1} A) P0,   omega = 4/3 / lambda_max(D^{-1} A)

(Vanek/Mandel/Brezina). The coarse operator is the Galerkin product
Pt A P; the cycles and smoothers are the facade's.

The aggregation is a sequential greedy pass on the host, as in the
reference, over the same Python sets built by the same insertions in the
same order: a straggler joins the first aggregated neighbour in set
iteration order, so the order decides the aggregates, and equal sets give
the reference's aggregates exactly. The tentative prolongator, its
smoothing and the Galerkin product run on the hierarchy's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hypre_tpu_torch.amg.boomeramg import BoomerAMG
from hypre_tpu_torch.amg.hierarchy import (
    AMGHierarchy, Level, _coarse_pinv, _level_vectors, _reciprocal,
)
from hypre_tpu_torch.amg.relax import max_eig_estimate
from hypre_tpu_torch.amg.strength import strength_mask
from hypre_tpu_torch.core.config import PAD_COL, fold_sum
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.spgemm import ell_spgemm, ell_transpose


def aggregate_graph(nbr: list) -> tuple[np.ndarray, int]:
    """Greedy aggregation over a symmetric adjacency (a list of neighbour
    sets): VMB phases 1-3 (mli_amgsa_coarsen1.cxx coarsenLocal). Returns
    (agg_id (n,) int64, n_aggregates); every node is assigned, isolated
    nodes as singletons, so P keeps full rank."""
    n = len(nbr)
    agg = np.full(n, -1, np.int64)
    n_agg = 0
    # phase 1: roots whose whole neighbourhood is free
    for i in range(n):
        if agg[i] >= 0 or not nbr[i]:
            continue
        if all(agg[j] < 0 for j in nbr[i]):
            agg[i] = n_agg
            for j in nbr[i]:
                agg[j] = n_agg
            n_agg += 1
    # phase 2: attach stragglers to a neighbouring aggregate
    for i in range(n):
        if agg[i] < 0:
            for j in nbr[i]:
                if agg[j] >= 0:
                    agg[i] = agg[j]
                    break
    # phase 3: aggregates from what is left (isolated singletons included)
    for i in range(n):
        if agg[i] < 0:
            agg[i] = n_agg
            for j in nbr[i]:
                if agg[j] < 0:
                    agg[j] = n_agg
            n_agg += 1
    return agg, n_agg


def strength_graph(A: EllMatrix, S: torch.Tensor) -> list:
    """The symmetrized strength graph as neighbour sets: row i's strong
    columns in slot order, then i added to each of its neighbours' sets in
    that order. One read-back and one ``tolist`` of the strong columns
    instead of a numpy slice per row; the insertions are the reference's,
    so are the sets and their iteration order."""
    Sh = S.cpu().numpy()
    flat = A.cols.cpu().numpy()[Sh].tolist()
    ends = np.cumsum(Sh.sum(axis=1)).tolist()
    nbr, start = [], 0
    for end in ends:
        nbr.append(set(flat[start:end]))
        start = end
    for i, row in enumerate(nbr):  # symmetrize
        for j in row:
            nbr[j].add(i)
    return nbr


def aggregate(A: EllMatrix, S: torch.Tensor) -> tuple[np.ndarray, int]:
    """Greedy aggregation over the symmetrized matrix strength graph."""
    return aggregate_graph(strength_graph(A, S))


def tentative_prolongator(agg: np.ndarray, n_agg: int, B: torch.Tensor
                          ) -> tuple[EllMatrix, torch.Tensor]:
    """P0 from the near-nullspace B (n, nb): column block c of P0 carries B
    restricted to aggregate c, orthonormalized per aggregate (MLI's
    tentative prolongator). Returns (P0, Bc), Bc (n_agg*nb, nb) the coarse
    near-nullspace (the R factors), both on B's device."""
    n, nb = B.shape
    dev = B.device
    agg_t = torch.as_tensor(agg, device=dev)
    if nb == 1:
        # per-aggregate sums of squares over the members in row order (the
        # transpose's rows), not by atomics: the card gives the CPU's bits
        cols = agg_t[:, None].to(torch.int32)
        norms2 = fold_sum(ell_transpose(EllMatrix(
            vals=B[:, :1] ** 2, cols=cols, n_cols=n_agg)).vals)
        norms = torch.sqrt(torch.clamp(norms2, min=1e-300))
        P0 = EllMatrix(vals=(B[:, 0] / norms[agg_t])[:, None], cols=cols,
                       n_cols=n_agg)
        return P0, norms[:, None]
    # general nb: one Householder QR per aggregate on the host, batched
    # over the aggregates of one size (numpy loops LAPACK over the stack,
    # so each factor is the one a lone call gives)
    Bh = B.cpu().numpy()
    order = np.argsort(agg, kind="stable")  # members of each, ascending
    sizes = np.bincount(agg, minlength=n_agg)
    first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    vals = np.zeros((n, nb), Bh.dtype)
    colsP = np.full((n, nb), PAD_COL, np.int32)
    Bc = np.zeros((n_agg * nb, nb), Bh.dtype)
    for m in np.unique(sizes):
        aggs = np.nonzero(sizes == m)[0]
        rows = order[first[aggs][:, None] + np.arange(m)[None, :]]
        Q, R = np.linalg.qr(Bh[rows])  # (count, m, K), (count, K, nb)
        K = Q.shape[2]
        vals[rows, :K] = Q
        colsP[rows, :K] = (aggs[:, None] * nb + np.arange(K))[:, None, :]
        Bc.reshape(n_agg, nb, nb)[aggs, :K, :] = R
    P0 = EllMatrix(vals=torch.from_numpy(vals).to(dev),
                   cols=torch.from_numpy(colsP).to(dev), n_cols=n_agg * nb)
    return P0, torch.from_numpy(Bc).to(dev)


def smooth_prolongator(A: EllMatrix, P0: EllMatrix,
                       omega_scale: float = 4.0 / 3.0) -> EllMatrix:
    """P = (I - omega D^{-1} A) P0 as one ELL SpGEMM; omega = omega_scale /
    lambda_max(D^{-1} A) from the power estimate."""
    dinv = _reciprocal(A.diagonal())
    omega = omega_scale / torch.clamp(max_eig_estimate(A, dinv), min=1e-30)
    isdiag = A.cols == A._row_ids()
    jvals = torch.where(A.cols >= 0, -omega * dinv[:, None] * A.vals,
                        torch.zeros_like(A.vals))
    jvals = jvals + isdiag.to(A.dtype)
    return ell_spgemm(EllMatrix(vals=jvals, cols=A.cols, n_cols=A.n_rows),
                      P0)


@dataclasses.dataclass
class SmoothedAggAMG(BoomerAMG):
    """MLI's "AMGSA" method: a BoomerAMG whose setup builds aggregates and
    smoothed prolongators; every solve-side knob (cycle, smoother, Krylov
    use) is the facade's."""

    null_space: Optional[torch.Tensor] = None  # (n, nb); None -> constants
    prolongator_smoothing: float = 4.0 / 3.0  # omega scale; 0 = P0
    # a precomputed fine-level aggregation (agg_id (n,), n_agg): the FEI
    # element-graph coarsening (mli_amgsa_calib.cxx); coarser levels fall
    # back to matrix-strength aggregation
    agg0: Optional[tuple] = None

    def _do_setup(self, A: EllMatrix, where: torch.device) -> None:
        need_cheby = self.relax == "chebyshev"
        levels = []
        B = self.null_space
        if B is None:
            B = torch.ones((A.n_rows, 1), dtype=A.dtype, device=where)
        B = B.to(device=where, dtype=A.dtype)
        while (len(levels) < self.max_levels - 1
               and A.n_rows > self.max_coarse_size):
            if not levels and self.agg0 is not None:
                agg, n_agg = self.agg0
                agg = np.asarray(agg)
                if agg.shape[0] != A.n_rows:
                    raise ValueError(
                        f"agg0 covers {agg.shape[0]} rows, A has {A.n_rows}")
            else:
                agg, n_agg = aggregate(
                    A, strength_mask(A, self.strength_threshold))
            nb = B.shape[1]
            if n_agg * nb == 0 or n_agg * nb >= 0.9 * A.n_rows:
                break
            P0, Bc = tentative_prolongator(agg, n_agg, B)
            if self.prolongator_smoothing > 0:
                P = smooth_prolongator(A, P0, self.prolongator_smoothing)
            else:
                P = P0
            Pt = ell_transpose(P)
            A_c = ell_spgemm(Pt, ell_spgemm(A, P))
            dinv, l1inv, lmax = _level_vectors(A, need_cheby)
            levels.append(Level(A=A, P=P, Pt=Pt, dinv=dinv, l1inv=l1inv,
                                lmax=lmax))
            A, B = A_c, Bc
        self.hierarchy = AMGHierarchy(levels=levels,
                                      coarse_inv=_coarse_pinv(A))
