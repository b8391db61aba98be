"""MGR — multigrid reduction with user-tagged C-points.

Counterpart of ``hypre_tpu/amg/mgr.py``, hypre's MGR (``parcsr_ls/
par_mgr.c``, ``par_mgr.h:16-109``, HYPRE_parcsr_ls.h:3798): the user says
which unknowns form the coarse grid at each level (e.g. pressure in CPR),
and each level does F-relaxation plus a coarse-grid correction with
reduction-style transfers:

    P = [ W ]   W = -D_FF^{-1} A_FC   ("jacobi" interp, hypre interp_type 2)
        [ I ]   or W = 0              ("injection")
    R = [0 I]  (injection restriction, hypre restrict_type 0)
    A_H = R A P

The coarsest reduced system is solved with BoomerAMG. P and R are built
in host numpy at setup, as in the reference; A_H = R (A P) runs the
port's ``ell_spgemm`` on the device (the reference calls its C++ SpGEMM).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from hypre_tpu_torch.amg.boomeramg import BoomerAMG
from hypre_tpu_torch.core.config import (
    ConvergenceInfo, make_convergence_info, resolve_device,
)
from hypre_tpu_torch.seq.csr import HostCSR
from hypre_tpu_torch.seq.ell import EllMatrix, csr_to_ell, ell_to_csr
from hypre_tpu_torch.seq.fastmv import optimize_operator
from hypre_tpu_torch.seq.spgemm import ell_spgemm
from hypre_tpu_torch.seq.vector import dot


@dataclasses.dataclass
class MGRLevel:
    A: EllMatrix
    P: EllMatrix
    R: EllMatrix
    f_mask: torch.Tensor  # 1.0 on F-points
    dinv: torch.Tensor
    op: object = None  # A, or its kernel format on the card


@dataclasses.dataclass
class MGR:
    """HYPRE_MGRCreate / SetCpointsByBlock analogue."""

    interp_type: str = "jacobi"  # 'jacobi' | 'injection'
    num_relax_sweeps: int = 1
    coarse_amg: Optional[BoomerAMG] = None
    # global smoothing on the FULL fine system each cycle, the step that
    # turns plain reduction into CPR (HYPRE_MGRSetGlobalSmoothType/Iters):
    # '' | 'jacobi' | 'ilu'
    global_smooth_type: str = ""
    global_smooth_iters: int = 1

    levels: Optional[List[MGRLevel]] = dataclasses.field(default=None,
                                                         repr=False)
    _gsm: object = dataclasses.field(default=None, init=False, repr=False)

    def setup(self, A: EllMatrix, cpoints_per_level: Sequence[np.ndarray],
              optimize="auto", device=None) -> "MGR":
        """cpoints_per_level[l]: indices (into level-l unknowns) that form
        level l+1 (hypre's block C-point prescription). Runs on ``device``
        (CUDA unless the caller names another); optimize: apply each
        level's A and the coarse BoomerAMG hierarchy through the kernel
        formats, 'auto' = on CUDA."""
        if self.global_smooth_type not in ("", "jacobi", "ilu"):
            raise ValueError(
                f"unknown global_smooth_type {self.global_smooth_type!r}")
        target = resolve_device(device)
        if optimize == "auto":
            optimize = target.type == "cuda"
        A = A.to(target)
        levels: List[MGRLevel] = []
        for cpts in cpoints_per_level:
            n = A.n_rows
            is_c = np.zeros(n, bool)
            is_c[np.asarray(cpts, dtype=np.int64)] = True
            nc = int(is_c.sum())
            cmap = np.where(is_c, np.cumsum(is_c) - 1, -1)

            csr = ell_to_csr(A)
            dense_rows = np.repeat(np.arange(n), csr.row_nnz())
            diag = np.zeros(n)
            dm = csr.indices == dense_rows
            np.add.at(diag, dense_rows[dm], csr.data[dm])
            dsafe = np.where(diag != 0, diag, 1.0)

            # P = [W; I]: W = -D_FF^{-1} A_FC on F-rows (or empty)
            c_rows = np.nonzero(is_c)[0]
            rows, cols, vals = [c_rows], [cmap[c_rows]], [np.ones(nc)]
            if self.interp_type == "jacobi":
                m = (~is_c[dense_rows]) & is_c[csr.indices]
                rows.append(dense_rows[m])
                cols.append(cmap[csr.indices[m]])
                vals.append(-csr.data[m] / dsafe[dense_rows[m]])
            P = csr_to_ell(
                HostCSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                                 np.concatenate(vals), (n, nc)),
                dtype=A.dtype, device=target)
            # R = [0 I] injection
            R = csr_to_ell(
                HostCSR.from_coo(cmap[c_rows], c_rows, np.ones(nc), (nc, n)),
                dtype=A.dtype, device=target)
            A_H = ell_spgemm(R, ell_spgemm(A, P))
            levels.append(MGRLevel(
                A=A, P=P, R=R,
                f_mask=torch.from_numpy((~is_c).astype(np.float64)).to(
                    target, A.dtype),
                dinv=torch.from_numpy(1.0 / dsafe).to(target, A.dtype),
                op=optimize_operator(A) if optimize else A))
            A = A_H
        self.levels = levels
        self.coarse_amg = (self.coarse_amg or BoomerAMG()).setup(
            A, optimize=optimize, device=target)
        A0 = levels[0].A if levels else A
        if self.global_smooth_type == "ilu":
            from hypre_tpu_torch.precond.ilu import ILU

            self._gsm = ILU().setup(A0, device=target).precond()
        elif self.global_smooth_type == "jacobi":
            d = A0.diagonal()
            nz = d != 0
            dinv0 = torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(
                d)), torch.zeros_like(d))
            self._gsm = lambda r: dinv0 * r
        else:
            self._gsm = None
        return self

    def _f_relax(self, lev: MGRLevel, u, f):
        """Jacobi sweeps restricted to F-points (par_mgr.c F-relaxation)."""
        for _ in range(self.num_relax_sweeps):
            r = f - lev.op.mv(u)
            u = u + lev.f_mask * lev.dinv * r
        return u

    def cycle(self, f: torch.Tensor,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.levels is None:
            raise RuntimeError("call setup first")

        def descend(level, f, u):
            if level == len(self.levels):
                return self.coarse_amg.cycle(f)
            lev = self.levels[level]
            u = self._f_relax(lev, u, f)
            rc = lev.R.mv(f - lev.op.mv(u))
            ec = descend(level + 1, rc, torch.zeros_like(rc))
            u = u + lev.P.mv(ec)
            return self._f_relax(lev, u, f)

        if u is None:
            u = torch.zeros_like(f)
        if self._gsm is not None:
            # hypre applies the global smoother ahead of the reduction cycle
            # (par_mgr_solve.c global relaxation)
            op0 = self.levels[0].op
            for _ in range(self.global_smooth_iters):
                u = u + self._gsm(f - op0.mv(u))
        return descend(0, f, u)

    def precond(self):
        return lambda r: self.cycle(r)

    def solve(
        self,
        b: torch.Tensor,
        x0: Optional[torch.Tensor] = None,
        rtol: float = 1e-8,
        maxiter: int = 100,
    ) -> tuple[torch.Tensor, ConvergenceInfo]:
        """Standalone MGR iteration to ||b - A x|| <= rtol ||b||, one host
        read per cycle."""
        op = self.levels[0].op
        b = b.to(self.levels[0].A.device)
        x = torch.zeros_like(b) if x0 is None else x0.to(b.device)
        b2 = dot(b, b)
        eps = rtol * rtol * b2
        r = b - op.mv(x)
        r2 = dot(r, r)
        it = 0
        while it < maxiter and bool((r2 > eps) & torch.isfinite(r2)):
            x = self.cycle(b, x)
            r = b - op.mv(x)
            r2 = dot(r, r)
            it += 1
        safe = torch.where(b2 > 0, b2, torch.ones_like(b2))
        rel = torch.sqrt(torch.clamp(r2, min=0.0) / safe)
        return x, make_convergence_info(it, rel, (r2 <= eps) | (b2 == 0))
