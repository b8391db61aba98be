"""FAC — fast adaptive composite multigrid for AMR grids.

Counterpart of ``hypre_tpu/sstruct/fac.py`` (hypre's FAC,
``sstruct_ls/fac*.c``): a composite grid made of a global coarse level
plus refined patches (arbitrarily nested), solved by cycling between
patch-local relaxation and coarse-grid corrections on the successively
derefined composite grids.

FAC stays algebraic, as in the reference: each hierarchy level derefines
the deepest patch through piecewise-constant AMR transfers (fine-patch
cells average onto their parent cell, other cells inject), so every
level's operator is a Galerkin R (A P), formed here in float64 by the
port's SpGEMM and cast to A's type (the reference calls its C++ SpGEMM).
Relaxation is Jacobi masked to the deepest-patch DOFs of each level
(``fac_relax.c``), and the base grid is solved by one BoomerAMG cycle
(``fac_cycle.c``). Every level's A, P and R apply through the format
``seq/fastmv.py::optimize_operator`` picks (banded where the windows fit,
else the ELL product itself).

``composite_poisson_2d`` assembles with numpy array operations what the
reference assembles in dict loops, to the same matrix, DOF numbering,
fine mask and parents; ``composite_poisson_nested`` is the reference's
loop.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from hypre_tpu_torch.amg.ams import product_f64
from hypre_tpu_torch.amg.boomeramg import BoomerAMG
from hypre_tpu_torch.core.config import ConvergenceInfo, resolve_device
from hypre_tpu_torch.seq.csr import HostCSR
from hypre_tpu_torch.seq.ell import EllMatrix, csr_to_ell
from hypre_tpu_torch.struct.jacobi import stationary_solve


@dataclasses.dataclass
class _FACLevel:
    A: EllMatrix
    P: EllMatrix
    R: EllMatrix
    dinv: torch.Tensor
    fmask: torch.Tensor
    # the product formats of A, P and R (``optimize_operator``)
    A_op: object = None
    P_op: object = None
    R_op: object = None


def galerkin(A: EllMatrix, P: EllMatrix, R: EllMatrix) -> EllMatrix:
    """R (A P), formed in float64 on A's device and cast to A's type."""
    return product_f64(R, product_f64(A, P, torch.float64), A.dtype)


def product_format(M: EllMatrix, optimize: bool):
    """M's product format: ``optimize_operator`` with the kernel formats
    wanted (the CPU then runs their plain versions), or M itself."""
    from hypre_tpu_torch.seq.fastmv import optimize_operator

    return optimize_operator(M, prefer_pallas=True) if optimize else M


@dataclasses.dataclass
class FAC:
    """HYPRE_SStructFAC* object protocol. One refined level (the classic
    two-level FAC) or a full nested-patch stack (pass lists to setup)."""

    num_relax: int = 2
    relax_weight: float = 0.7
    coarse_amg: Optional[BoomerAMG] = None

    A: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    levels: Optional[List[_FACLevel]] = dataclasses.field(default=None,
                                                         repr=False)
    # the base grid's Galerkin operator, which coarse_amg was set up on
    coarse_A: Optional[EllMatrix] = dataclasses.field(default=None,
                                                      repr=False)

    def setup(self, A: EllMatrix, fine_mask, parent, device=None,
              optimize="auto") -> "FAC":
        """A: composite operator on the finest composite DOF set, moved to
        ``device`` (CUDA unless the caller names another).

        Single refined level: ``fine_mask[i]`` marks the fine-patch DOFs
        and ``parent[i]`` is the coarse-grid index each composite DOF maps
        to. Nested patches: lists, ``fine_mask[l]``/``parent[l]`` for the
        l-th derefinement step (level 0 = deepest patch). ``optimize``:
        the kernel formats for A, P, R and the base BoomerAMG ('auto':
        on CUDA)."""
        dev = resolve_device(device)
        if optimize == "auto":
            optimize = dev.type == "cuda"
        if not isinstance(fine_mask, (list, tuple)):
            fine_mask, parent = [fine_mask], [parent]
        A = A.to(dev)
        self.A = A
        self.levels = []
        A_l = A
        for mask_l, parent_l in zip(fine_mask, parent):
            n = A_l.n_rows
            parent_l = np.asarray(parent_l, np.int64)
            nc = int(parent_l.max()) + 1
            # prolongation: piecewise-constant injection from the parent
            P = HostCSR.from_coo(np.arange(n), parent_l, np.ones(n), (n, nc))
            # restriction: volume-weighted average onto parents
            counts = np.bincount(parent_l, minlength=nc).astype(float)
            R = HostCSR.from_coo(parent_l, np.arange(n),
                                 1.0 / counts[parent_l], (nc, n))
            P_e = csr_to_ell(P, dtype=A_l.dtype, device=dev)
            R_e = csr_to_ell(R, dtype=A_l.dtype, device=dev)
            diag = A_l.diagonal()
            nz = diag != 0
            dinv = torch.where(nz, 1.0 / torch.where(nz, diag,
                                                     torch.ones_like(diag)),
                               torch.zeros_like(diag))
            fmask = torch.from_numpy(np.asarray(mask_l)).to(dev, A_l.dtype)
            self.levels.append(_FACLevel(
                A=A_l, P=P_e, R=R_e, dinv=dinv, fmask=fmask,
                A_op=product_format(A_l, optimize),
                P_op=product_format(P_e, optimize),
                R_op=product_format(R_e, optimize)))
            A_l = galerkin(A_l, P_e, R_e)
        self.coarse_A = A_l
        self.coarse_amg = (self.coarse_amg or BoomerAMG(
            max_coarse_size=256)).setup(A_l, device=dev, optimize=optimize)
        return self

    @property
    def A_op(self):
        return self.levels[0].A_op

    def _patch_relax(self, lev: _FACLevel, u, f):
        for _ in range(self.num_relax):
            r = f - lev.A_op.mv(u)
            u = u + self.relax_weight * lev.fmask * lev.dinv * r
        return u

    def cycle(self, f: torch.Tensor,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One FAC cycle: per level patch relax -> restrict -> recurse ->
        correct -> patch relax; the base grid takes one AMG cycle
        (fac_cycle.c)."""

        def descend(l: int, f, u):
            if l == len(self.levels):
                return self.coarse_amg.cycle(f)
            lev = self.levels[l]
            u = self._patch_relax(lev, u, f)
            r = f - lev.A_op.mv(u)
            rc = lev.R_op.mv(r)
            ec = descend(l + 1, rc, torch.zeros_like(rc))
            u = u + lev.P_op.mv(ec)
            return self._patch_relax(lev, u, f)

        if u is None:
            u = torch.zeros_like(f)
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
        assert self.levels is not None, "call setup(A) first"
        return stationary_solve(lambda x: self.cycle(b, x), self.A_op, b,
                                x0, rtol, maxiter)


def composite_poisson_2d(Nc: int, patch_lo: tuple, patch_hi: tuple,
                         dtype=None, device=None):
    """2-D composite-grid Poisson operator (FV, refinement 2): the Nc x Nc
    coarse grid with the cells in [patch_lo, patch_hi) replaced by 2x
    refined cells; conservative flux coupling at the coarse-fine interface
    (face length / centre distance weights). DOFs: the fine cells first
    (row-major over the refined patch), then the coarse cells outside the
    patch (row-major). Returns (A EllMatrix on ``device`` in ``dtype``,
    fine_mask, parent, (nfine, n)) for FAC.setup.

    The reference's dict loops as array operations: each row's
    off-diagonal entries and diagonal terms in the same order (+x, -x, +y,
    -y; a coarse cell's two fine neighbours across one face one after the
    other), so the diagonal sums round alike."""
    lo0, lo1 = patch_lo
    hi0, hi1 = patch_hi
    w = 1.0 / 1.5
    dirs = ((1, 0), (-1, 0), (0, 1), (0, -1))
    fw = 2 * (hi1 - lo1)
    nfine = 4 * (hi0 - lo0) * (hi1 - lo1)
    in_patch = np.zeros((Nc, Nc), bool)
    in_patch[lo0:hi0, lo1:hi1] = True
    cid = np.full((Nc, Nc), -1, np.int64)
    cid[~in_patch] = nfine + np.arange(int((~in_patch).sum()))
    n = nfine + int((~in_patch).sum())

    def fine_id(fi, fj):
        return (fi - 2 * lo0) * fw + (fj - 2 * lo1)

    rows, cols, vals = [], [], []

    # fine-fine and fine-coarse couplings (h = 1 for the fine spacing)
    fi, fj = (a.reshape(-1) for a in np.meshgrid(
        np.arange(2 * lo0, 2 * hi0), np.arange(2 * lo1, 2 * hi1),
        indexing="ij"))
    idx = fine_id(fi, fj)
    diag = np.zeros(nfine)
    for di, dj in dirs:
        gi, gj = fi + di, fj + dj
        fine = ((gi >= 2 * lo0) & (gi < 2 * hi0)
                & (gj >= 2 * lo1) & (gj < 2 * hi1))
        I, J = gi // 2, gj // 2
        inside = (I >= 0) & (I < Nc) & (J >= 0) & (J < Nc)
        coarse = ~fine & inside
        rows += [idx[fine], idx[coarse]]
        cols += [fine_id(gi[fine], gj[fine]), cid[I[coarse], J[coarse]]]
        vals += [np.full(int(fine.sum()), -1.0), np.full(int(coarse.sum()),
                                                         -w)]
        diag = diag + np.where(fine, 1.0, np.where(coarse, w, 2.0))
    rows.append(idx)
    cols.append(idx)
    vals.append(diag)

    # coarse-coarse and coarse-fine couplings (coarse spacing 2h)
    I, J = np.nonzero(~in_patch)
    idx = cid[I, J]
    diag = np.zeros(idx.shape[0])
    for di, dj in dirs:
        GI, GJ = I + di, J + dj
        inside = (GI >= 0) & (GI < Nc) & (GJ >= 0) & (GJ < Nc)
        GIc, GJc = np.clip(GI, 0, Nc - 1), np.clip(GJ, 0, Nc - 1)
        coarse = inside & ~in_patch[GIc, GJc]
        patch = inside & in_patch[GIc, GJc]
        rows.append(idx[coarse])
        cols.append(cid[GI[coarse], GJ[coarse]])
        vals.append(np.full(int(coarse.sum()), -1.0))
        # two fine cells across the interface (each face h, distance 1.5h)
        for t in (0, 1):
            if di != 0:
                ffi = 2 * GI + (0 if di > 0 else 1)
                ffj = 2 * J + t
            else:
                ffi = 2 * I + t
                ffj = 2 * GJ + (0 if dj > 0 else 1)
            rows.append(idx[patch])
            cols.append(fine_id(ffi[patch], ffj[patch]))
            vals.append(np.full(int(patch.sum()), -w))
        diag = diag + np.where(coarse, 1.0, np.where(patch, w, 2.0))
        diag = diag + np.where(patch, w, 0.0)
    rows.append(idx)
    cols.append(idx)
    vals.append(diag)

    A = csr_to_ell(HostCSR.from_coo(np.concatenate(rows),
                                    np.concatenate(cols),
                                    np.concatenate(vals), (n, n)),
                   dtype=dtype, device=resolve_device(device))
    fine_mask = np.zeros(n, bool)
    fine_mask[:nfine] = True
    parent = np.zeros(n, np.int64)
    parent[fine_id(fi, fj)] = (fi // 2) * Nc + (fj // 2)
    parent[idx] = I * Nc + J
    return A, fine_mask, parent, (nfine, n)


def composite_poisson_nested(Nc: int, patches: list, dtype=None,
                             device=None):
    """Nested-patch composite Poisson (refinement 2 per patch level), the
    reference's loop assembly.

    ``patches``: (lo, hi) boxes in coarse cell coordinates, each strictly
    nested inside the previous. A coarse cell inside the first l patches
    carries 2^l x 2^l leaf cells of size 2^-l (unless a deeper patch
    refines it further). Conservative FV fluxes: face length = the smaller
    cell side, centre distance = half-side sums.

    Returns (A on ``device`` in ``dtype``, masks, parents, n): the
    per-level lists FAC.setup consumes (level 0 derefines the deepest
    patch)."""
    L = len(patches)
    S = 1 << L  # finest resolution per coarse cell

    def depth(I, J):
        d = 0
        for lo, hi in patches:
            if lo[0] <= I < hi[0] and lo[1] <= J < hi[1]:
                d += 1
            else:
                break
        return d

    def leaves_at(trunc: int):
        """Leaf cells with the refinement depth capped at ``trunc``: dict
        (x0, y0, size) -> id in finest-resolution integer coords."""
        ids = {}
        for I in range(Nc):
            for J in range(Nc):
                d = min(depth(I, J), trunc)
                s = S >> d
                for a in range(1 << d):
                    for b in range(1 << d):
                        ids[(I * S + a * s, J * S + b * s, s)] = len(ids)
        return ids

    full = leaves_at(L)
    n = len(full)
    max_d = {(I, J): depth(I, J) for I in range(Nc) for J in range(Nc)}

    def owner(x, y):
        if not (0 <= x < Nc * S and 0 <= y < Nc * S):
            return None
        s = S >> max_d[(x // S, y // S)]
        return (x - x % s, y - y % s, s)

    rows, cols, vals = [], [], []
    for (x0, y0, s), idx in full.items():
        diag = 0.0
        # walk each face in steps of the smallest neighbour size
        for side in range(4):
            if side == 0:  # +x
                probes = [(x0 + s, y0 + t) for t in range(s)]
            elif side == 1:  # -x
                probes = [(x0 - 1, y0 + t) for t in range(s)]
            elif side == 2:  # +y
                probes = [(x0 + t, y0 + s) for t in range(s)]
            else:  # -y
                probes = [(x0 + t, y0 - 1) for t in range(s)]
            seen = set()
            boundary_faces = 0
            for px, py in probes:
                nb = owner(px, py)
                if nb is None:
                    boundary_faces += 1
                    continue
                if nb in seen:
                    continue
                seen.add(nb)
                s2 = nb[2]
                wgt = (min(s, s2) / S) / ((s + s2) / (2 * S))
                rows.append(idx)
                cols.append(full[nb])
                vals.append(-wgt)
                diag += wgt
            if boundary_faces:
                # Dirichlet wall: 2/s per finest-resolution probe
                diag += boundary_faces * 2.0 / s
        rows.append(idx)
        cols.append(idx)
        vals.append(diag)

    A = csr_to_ell(HostCSR.from_coo(rows, cols, vals, (n, n)), dtype=dtype,
                   device=resolve_device(device))
    masks, parents = [], []
    cur = full
    for l in range(L):
        trunc = L - 1 - l
        nxt = leaves_at(trunc)
        min_s = min(s for (_, _, s) in cur)
        mask = np.zeros(len(cur), bool)
        parent = np.zeros(len(cur), np.int64)
        for (x0, y0, s), idx in cur.items():
            mask[idx] = s == min_s  # the deepest-patch cells relax
            sp = S >> min(max_d[(x0 // S, y0 // S)], trunc)
            parent[idx] = nxt[(x0 - x0 % sp, y0 - y0 % sp, sp)]
        masks.append(mask)
        parents.append(parent)
        cur = nxt
    return A, masks, parents, n
