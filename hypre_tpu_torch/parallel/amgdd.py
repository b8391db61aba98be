"""AMG-DD: communication-avoiding AMG on per-device composite grids.

Counterpart of ``hypre_tpu/parallel/amgdd.py``, hypre's AMG-DD
(``parcsr_ls/par_amgdd*.c``, ``HYPRE_parcsr_ls.h:1384``). At setup every
device assembles a *composite grid*: its owned rows plus ``padding``
layers of neighbours on every level of an existing AMG hierarchy, so that
a solve cycle needs exactly ONE residual communication
(``hypre_BoomerAMGDD_ResidualCommunication``, ``par_amgdd_solve.c:221``)
followed by communication-free local FAC cycles.

The composite grids of all devices are padded to a common size per level
and stacked with a leading device axis, so the "each device cycles
locally" phase is one batch of gathers and scatters over every composite
at once, with no collective inside; the residual is one global product
and a gather of the composite residuals. Owned-row masks make the
correction additive (hypre masks to owned DOFs the same way). The
composite sets are built on the host in numpy, from the hierarchy the
facade's default setup gives (the host C++ one, as the reference's
``"auto"`` takes), so they equal the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from hypre_tpu_torch.amg.boomeramg import BoomerAMG
from hypre_tpu_torch.core.config import (
    PAD_COL, ConvergenceInfo, make_convergence_info, resolve_device,
)
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.fastmv import optimize_operator


def _expand(owned: np.ndarray, cols: np.ndarray, rounds: int) -> np.ndarray:
    """Grow a row set by ``rounds`` graph-neighbour layers (hypre's
    padding, ``num_ghost_layers``). Each round adds the neighbours of the
    rows the last one added: the older rows' are in the set already."""
    sel, frontier = owned.copy(), owned
    for _ in range(rounds):
        touched = cols[frontier]
        nbr = np.zeros_like(sel)
        nbr[touched[touched >= 0]] = True
        frontier = nbr & ~sel
        sel |= nbr
    return sel


def _extract_rows(vals, cols, rows, gmap):
    """The local block of an ELL matrix (tensors) on the rows ``rows``:
    columns outside the set map to padding (a zero Dirichlet boundary).
    ``gmap`` maps a global column to its local one, -1 outside the set;
    its extra last entry (-1) serves the padding columns (PAD_COL indexes
    it)."""
    mapped = gmap[cols[rows].long()]
    keep = mapped >= 0
    return (torch.where(keep, vals[rows], torch.zeros_like(vals[:1])),
            torch.where(keep, mapped, torch.full_like(mapped, PAD_COL)))


def _stacked_index(cols: torch.Tensor, width: int) -> torch.Tensor:
    """(P, n, k) per-device columns -> flat indices into a (P, width)
    stack (padding to the device's column 0; its value is 0)."""
    base = torch.arange(cols.shape[0], device=cols.device)[:, None, None]
    return (cols.clamp(min=0) + base * width).reshape(-1)


@dataclasses.dataclass
class AMGDD:
    """HYPRE_BoomerAMGDDCreate analogue (the ij driver's ids 90/91)."""

    padding: int = 2  # neighbour layers per level (hypre SetPadding)
    num_devices: int = 1
    fac_relax_weight: float = 0.7
    fac_num_relax: int = 2
    amg: Optional[BoomerAMG] = None

    def setup(self, A: EllMatrix, num_devices: int,
              device=None) -> "AMGDD":
        """Set up the AMG hierarchy (``BoomerAMG(max_coarse_size=min(64,
        n))`` unless one is given) on ``device`` (CUDA unless the caller
        names another), then every device's composite grid
        (``par_amgdd_setup.c``)."""
        device = resolve_device(device)
        self.num_devices = num_devices
        self.amg = self.amg or BoomerAMG(max_coarse_size=min(64, A.n_rows))
        if self.amg.hierarchy is None:
            self.amg.setup(A, optimize=False, device=device)
        hier = self.amg.ell_hierarchy
        levels = hier.levels
        host = [(lev.A.cols.cpu().numpy(), lev.P.cols.cpu().numpy(),
                 lev.P.n_cols) for lev in levels]
        n0, P = A.n_rows, num_devices
        block = -(-n0 // P)

        # per device, per level: the owned + padded row sets
        sets: List[List[np.ndarray]] = []
        for d in range(P):
            owned = np.zeros(n0, bool)
            owned[d * block: min((d + 1) * block, n0)] = True
            per = []
            for cols, pcols, nc in host:
                sel = _expand(owned, cols, self.padding)
                per.append(sel)
                # owned on the next level: the coarse points the padded
                # set interpolates from
                touched = pcols[sel]
                owned = np.zeros(nc, bool)
                owned[touched[touched >= 0]] = True
            sets.append(per)
        # static composite sizes: the largest over the devices, per level
        self.composite_sizes = [
            max(int(sets[d][l].sum()) for d in range(P))
            for l in range(len(levels))]

        # the composites are gathered on ``device`` from the hierarchy's
        # levels; gmaps[l]: global -> composite row of the device in hand
        # (-1 outside), reset after each device; the coarsest composite is
        # the WHOLE coarse grid
        coarse_n = hier.coarse_inv.shape[0]
        i64 = dict(dtype=torch.int64, device=device)
        gmaps = [torch.full((lev.A.n_rows + 1,), -1, **i64)
                 for lev in levels]
        gmaps.append(torch.cat([torch.arange(coarse_n, **i64),
                                torch.full((1,), -1, **i64)]))
        self._levels = []
        for l, lev in enumerate(levels):
            vals, cols = lev.A.vals, lev.A.cols
            pvals, pcols = lev.P.vals, lev.P.cols
            nl = self.composite_sizes[l]
            n_next = (self.composite_sizes[l + 1] if l + 1 < len(levels)
                      else coarse_n)
            # the inverse diagonal, once per level: a composite keeps its
            # rows' diagonal entries
            on_diag = cols == torch.arange(len(cols), device=device)[:, None]
            diag = torch.where(on_diag, vals, torch.zeros_like(vals)).sum(1)
            nz = diag != 0
            dinv = torch.where(nz, 1.0 / torch.where(nz, diag, torch.ones_like(
                diag)), torch.zeros_like(diag))
            # every device's composite, padded to nl rows
            AV = vals.new_zeros((P, nl, cols.shape[1]))
            AC = torch.full(AV.shape, PAD_COL, **i64)
            PV = pvals.new_zeros((P, nl, pcols.shape[1]))
            PC = torch.full(PV.shape, PAD_COL, **i64)
            DI, OWN = vals.new_zeros((P, nl)), vals.new_zeros((P, nl))
            GIDX = torch.zeros((P, nl), **i64)
            for d in range(P):
                rows = torch.from_numpy(np.flatnonzero(sets[d][l])).to(device)
                m = len(rows)
                gmaps[l][rows] = torch.arange(m, **i64)
                if l + 1 < len(levels):
                    rows_c = torch.from_numpy(np.flatnonzero(
                        sets[d][l + 1])).to(device)
                    gmaps[l + 1][rows_c] = torch.arange(len(rows_c), **i64)
                AV[d, :m], AC[d, :m] = _extract_rows(vals, cols, rows,
                                                     gmaps[l])
                PV[d, :m], PC[d, :m] = _extract_rows(pvals, pcols, rows,
                                                     gmaps[l + 1])
                gmaps[l][rows] = -1
                if l + 1 < len(levels):
                    gmaps[l + 1][rows_c] = -1
                DI[d, :m] = dinv[rows]
                if l == 0:
                    OWN[d, :m] = ((rows >= d * block)
                                  & (rows < (d + 1) * block)).to(vals.dtype)
                GIDX[d, :m] = rows
            self._levels.append(dict(
                av=AV, a_idx=_stacked_index(AC, nl), pv=PV, pc=PC,
                p_idx=_stacked_index(PC, n_next), dinv=DI, own=OWN,
                gidx=GIDX, n_next=n_next))
        self._coarse_inv_t = hier.coarse_inv.to(device).T.contiguous()
        A0 = levels[0].A if levels else A.to(device)
        self._A0 = optimize_operator(A0) if device.type == "cuda" else A0
        return self

    # -- the communication-free local FAC cycles, every device at once ------

    @staticmethod
    def _lmv(av, idx, x):
        P, n, k = av.shape
        return (av * x.reshape(-1)[idx].reshape(P, n, k)).sum(dim=2)

    @staticmethod
    def _lmv_t(pv, pc, x, n_out):
        P = pv.shape[0]
        contrib = torch.where(pc >= 0, pv * x[:, :, None],
                              torch.zeros_like(pv)).reshape(P, -1)
        out = torch.zeros((P, n_out), dtype=x.dtype, device=x.device)
        return out.scatter_add_(1, pc.clamp(min=0).reshape(P, -1), contrib)

    def _local_cycle(self, f: torch.Tensor) -> torch.Tensor:
        """f: (P, n_comp0) composite residuals -> the corrections."""
        w, nu = self.fac_relax_weight, self.fac_num_relax

        def descend(l, f):
            if l == len(self._levels):
                return f @ self._coarse_inv_t
            lv = self._levels[l]
            u = torch.zeros_like(f)
            for _ in range(nu):
                u = u + w * lv["dinv"] * (f - self._lmv(lv["av"], lv["a_idx"],
                                                         u))
            r = f - self._lmv(lv["av"], lv["a_idx"], u)
            ec = descend(l + 1, self._lmv_t(lv["pv"], lv["pc"], r,
                                            lv["n_next"]))
            u = u + self._lmv(lv["pv"], lv["p_idx"], ec)
            for _ in range(nu):
                u = u + w * lv["dinv"] * (f - self._lmv(lv["av"], lv["a_idx"],
                                                         u))
            return u

        return descend(0, f)

    def cycle(self, b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One AMG-DD cycle: ONE global residual, then the local composite
        cycles (``par_amgdd_solve.c``)."""
        r = b - self._A0.mv(u)  # the single communication point
        lev0 = self._levels[0]
        e = self._local_cycle(r[lev0["gidx"]])
        # the owned rows' corrections, added back to the global vector
        return u.index_add(0, lev0["gidx"].reshape(-1),
                           (lev0["own"] * e).reshape(-1))

    def solve(self, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
              rtol: float = 1e-8, maxiter: int = 200,
              ) -> tuple[torch.Tensor, ConvergenceInfo]:
        """Cycles until ||b - A x|| <= rtol ||b|| (one read per cycle)."""
        b = b.to(self._levels[0]["av"].device)
        x = torch.zeros_like(b) if x0 is None else x0.to(b.device)
        b2 = torch.sum(b * b)
        eps = rtol * rtol * b2
        r = b - self._A0.mv(x)
        r2 = torch.sum(r * r)
        it = 0
        while it < maxiter and bool((r2 > eps) & torch.isfinite(r2)):
            x = self.cycle(b, x)
            r = b - self._A0.mv(x)
            r2 = torch.sum(r * r)
            it += 1
        safe = torch.where(b2 > 0, b2, torch.ones_like(b2))
        rel = torch.sqrt(torch.clamp(r2, min=0.0) / safe)
        return x, make_convergence_info(it, rel, (r2 <= eps) | (b2 == 0))

    def precond(self):
        return lambda r: self.cycle(r, torch.zeros_like(r))
