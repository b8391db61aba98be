"""SysPFMG — PFMG for multi-variable structured systems.

Counterpart of ``hypre_tpu/sstruct/syspfmg.py`` (hypre's SysPFMG,
``sstruct_ls/sys_pfmg*.c``): one structured part, nvars coupled
variables, stencil blocks A[vi][vj]. The semicoarsening direction and the
interpolation come from the variable-diagonal blocks
(``sys_pfmg_setup_interp.c`` builds P block-diagonally); the Galerkin
coarse operator is recovered by lattice probing per source variable, the
probes batched on a leading axis as in ``struct/probe.py``.

The system matvec is the hot path. The reference sums nvars^2 * S shifted
products; here every operator carries one flat DIA view of the whole
system (``sys_dia_view``), built once: for each block difference
Δ = vj - vi (ascending) and each stencil entry s (stencil order) one plane
at offset Δ·N + flat(off_s), holding coeffs[vi, vi+Δ, s] in row block vi
(masked at the box edges as ``struct/matrix.py::dia_view`` masks) and
zero where vi+Δ is out of range. One matvec is one DIA kernel launch
(the static kernel when the plane count is on its ladder: D = 15 for two
variables on a 5-pt stencil, 27 on the probed 9-pt levels), and each row
block sums over vj ascending, then s: the reference's order.
``sys_matvec`` is the reference's shift-and-add on CPU tensors only; on a
CUDA tensor it raises.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional

import numpy as np
import torch

from hypre_tpu_torch.core.config import ConvergenceInfo, make_convergence_info
from hypre_tpu_torch.seq.dia import DiaMatrix, on_static_ladder
from hypre_tpu_torch.struct.jacobi import stationary_solve
from hypre_tpu_torch.struct.matrix import (
    StructMatrix, dia_dense, per_vector, plane_layout, shift,
)
from hypre_tpu_torch.struct.pfmg import coarse_pinv, compute_dxyz
from hypre_tpu_torch.struct.probe import _lattice_class
from hypre_tpu_torch.struct.relax import parity_mask
from hypre_tpu_torch.struct.semi import coarse_shape, semi_interp_from_matrix
from hypre_tpu_torch.struct.stencil import StructStencil


@dataclasses.dataclass(frozen=True)
class SysStructMatrix:
    """coeffs[vi, vj, s, ...]: coupling of variable vj into vi's equation."""

    coeffs: torch.Tensor  # (nvars, nvars, S, *shape)
    stencil: StructStencil
    shape: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    @property
    def nvars(self) -> int:
        return self.coeffs.shape[0]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def n_rows(self) -> int:
        return self.nvars * int(np.prod(self.shape))

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def device(self) -> torch.device:
        return self.coeffs.device

    def to(self, device) -> "SysStructMatrix":
        return dataclasses.replace(self, coeffs=self.coeffs.to(device))

    def block(self, vi: int, vj: int) -> StructMatrix:
        return StructMatrix(coeffs=self.coeffs[vi, vj], stencil=self.stencil,
                            shape=self.shape)

    @property
    def dia(self) -> DiaMatrix:
        """The flat DIA view that ``mv`` runs, built at first use."""
        store = self.__dict__.setdefault("_cache", {})
        if "dia" not in store:
            store["dia"] = sys_dia_view(self)
        return store["dia"]

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x through the DIA view. x is (nvars, *shape) or flat,
        with any leading batch dims (one kernel launch per vector); y has
        x's shape."""
        return per_vector(self.dia.mv, x, (self.nvars,) + self.shape)

    def as_linear_op(self):
        nv, shape = self.nvars, self.shape
        return lambda v: self.mv(v.reshape((nv,) + shape)).reshape(-1)

    def to_dense(self) -> torch.Tensor:
        """(n, n) dense matrix from the DIA view's planes."""
        return dia_dense(self.dia)


def sys_dia_view(A: SysStructMatrix) -> DiaMatrix:
    """A as flat diagonals over the (nvars * N) vector (see the module
    docstring): the static kernel when the plane count is on its ladder,
    else the dynamic one."""
    layout = plane_layout(A.stencil.offsets, A.shape, (False,) * A.ndim)
    nv, N, ndim = A.nvars, int(np.prod(A.shape)), A.ndim
    zero = torch.zeros(N, dtype=A.dtype, device=A.device)
    masks = []
    for _, _, dim_masks in layout:
        mask = None
        for d, m in enumerate(dim_masks):
            if m.all():
                continue
            md = torch.from_numpy(m).to(A.device).reshape(
                [-1 if e == d else 1 for e in range(ndim)])
            mask = md if mask is None else mask & md
        masks.append(mask)
    planes, offsets = [], []
    for delta in range(-(nv - 1), nv):
        for (s, flat, _), mask in zip(layout, masks):
            blocks = []
            for vi in range(nv):
                vj = vi + delta
                if not 0 <= vj < nv:
                    blocks.append(zero)
                    continue
                c = A.coeffs[vi, vj, s].expand(A.shape)
                if mask is not None:
                    c = torch.where(mask, c, torch.zeros((), dtype=A.dtype,
                                                         device=A.device))
                blocks.append(c.reshape(-1))
            planes.append(torch.cat(blocks))
            offsets.append(delta * N + int(flat))
    offs = tuple(offsets)
    return DiaMatrix(
        dvals=torch.stack(planes), offsets=offs, n_cols=A.n_rows,
        offsets_static=offs if on_static_ladder(len(offs)) else None)


def sys_matvec(A: SysStructMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x as the reference computes it: nvars^2 * S shifted products
    summed over vj, then s, per row variable. x: (nvars, *shape). CPU
    tensors only — on the card the DIA view runs (``A.mv``)."""
    if x.is_cuda:
        raise ValueError("sys_matvec is the plain version for CPU tensors; "
                         "on a CUDA tensor use A.mv (the DIA kernels)")
    ys = []
    for vi in range(A.nvars):
        acc = None
        for vj in range(A.nvars):
            for s, off in enumerate(A.stencil.offsets):
                term = A.coeffs[vi, vj, s] * shift(x[vj], off)
                acc = term if acc is None else acc + term
        ys.append(acc)
    return torch.stack(ys)


def sys_rap_apply(xc: torch.Tensor, A: SysStructMatrix, Ps) -> torch.Tensor:
    """The composed coarse operator P^T A P with the block-diagonal P;
    xc: (batch, nvars, *coarse shape)."""
    xf = torch.stack([P.apply(xc[:, v]) for v, P in enumerate(Ps)], dim=1)
    yf = A.mv(xf)
    return torch.stack([P.apply_t(yf[:, v]) for v, P in enumerate(Ps)],
                       dim=1)


def _probe_sys(apply_fn, nvars, shape, extent, dtype, device,
               operands=()) -> SysStructMatrix:
    """Recover a SysStructMatrix from a linear map on (batch, nvars,
    *shape): the lattice indicator probes of every (source variable,
    class) in one batch, each offset's coefficients by one gather on the
    probe class, and the reference's ``keep`` rule (drop an offset whose
    coefficients are all zero, unless it is the centre) after one read."""
    ndim = len(shape)
    mods = tuple(2 * e + 1 for e in extent)
    n_class = int(np.prod(mods))
    N = int(np.prod(shape))
    cls = _lattice_class(shape, mods, (0,) * ndim, device)
    pid = torch.arange(n_class, device=device).reshape(
        (n_class,) + (1,) * ndim)
    ind = (cls[None] == pid).to(dtype)
    probes = torch.zeros((nvars, n_class, nvars) + tuple(shape), dtype=dtype,
                         device=device)
    for v in range(nvars):
        probes[v, :, v] = ind
    Y = apply_fn(probes.reshape((nvars * n_class, nvars) + tuple(shape)),
                 *operands).reshape(nvars, n_class, nvars, N)  # [vj, c, vi]
    offsets = list(itertools.product(*(range(-e, e + 1) for e in extent)))
    cols = []
    for off in offsets:
        idx = _lattice_class(shape, mods, off, device).reshape(1, 1, 1, N)
        g = Y.gather(1, idx.expand(nvars, 1, nvars, N))[:, 0]  # [vj, vi, i]
        cols.append(g.transpose(0, 1))  # [vi, vj, i]
    C = torch.stack(cols, dim=2)  # (vi, vj, S, N)
    flags = (C != 0).any(dim=3).any(dim=1).any(dim=0).cpu().numpy()
    keep = [s for s, off in enumerate(offsets)
            if off == (0,) * ndim or bool(flags[s])]
    return SysStructMatrix(
        coeffs=C[:, :, keep].reshape((nvars, nvars, len(keep))
                                     + tuple(shape)).contiguous(),
        stencil=StructStencil(tuple(offsets[s] for s in keep)),
        shape=tuple(shape))


@dataclasses.dataclass(frozen=True)
class SysPFMGLevel:
    A: SysStructMatrix
    P: tuple  # per-variable SemiInterp
    dinv: torch.Tensor  # (nvars, *shape)
    # per-point inverse of the (nvars, nvars) centre block — nodal
    # relaxation (sstruct_ls/node_relax.c); None when relax is pointwise
    node_dinv: Optional[torch.Tensor] = None  # (nvars, nvars, *shape)
    red: Optional[torch.Tensor] = None  # checkerboard mask (node-rbgs)


def _node_block_inverse(A: SysStructMatrix) -> torch.Tensor:
    """Per-grid-point inverse of the nvars x nvars centre-coefficient
    block (node_relax.c solves these little systems per node; here one
    batched inverse over the grid). A singular node (|det| <= 1e-30, a
    Dirichlet-eliminated dof) takes the identity."""
    c = A.stencil.center_index()
    nv = A.nvars
    blocks = A.coeffs[:, :, c].expand((nv, nv) + A.shape)
    flat = torch.movedim(blocks.reshape(nv, nv, -1), -1, 0)  # (npts, nv, nv)
    eye = torch.eye(nv, dtype=A.dtype, device=A.device)
    det_ok = torch.abs(torch.linalg.det(flat)) > 1e-30
    safe = torch.where(det_ok[:, None, None], flat, eye)
    inv = torch.linalg.inv(safe)
    return torch.movedim(inv, 0, -1).reshape((nv, nv) + A.shape)


def _block_apply(B: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j B[i, j] * r[j] per grid point, j ascending."""
    nv = B.shape[0]
    out = []
    for i in range(nv):
        acc = B[i, 0] * r[0]
        for j in range(1, nv):
            acc = acc + B[i, j] * r[j]
        out.append(acc)
    return torch.stack(out)


@dataclasses.dataclass
class SysPFMG:
    """HYPRE_SStructSysPFMG* object protocol (HYPRE_sstruct_ls.h:92)."""

    max_levels: int = 25
    max_coarse_size: int = 512
    jacobi_weight: float = 0.7
    num_pre_relax: int = 1
    num_post_relax: int = 1
    # 'jacobi' = pointwise weighted Jacobi on the variable diagonals;
    # 'node-jacobi' / 'node-rbgs' = nodal relaxation solving the coupled
    # nvars x nvars block per grid point (node_relax.c; rbgs sweeps the
    # red/black checkerboard)
    relax_type: str = "jacobi"

    levels: Optional[List[SysPFMGLevel]] = dataclasses.field(default=None,
                                                            repr=False)
    coarse_inv: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                           repr=False)
    coarse_meta: Optional[tuple] = None
    coarse_A: Optional[SysStructMatrix] = dataclasses.field(default=None,
                                                            repr=False)

    def setup(self, A: SysStructMatrix) -> "SysPFMG":
        """Build the hierarchy on A's device."""
        levels: List[SysPFMGLevel] = []
        dxyz = sum(compute_dxyz(A.block(v, v)) for v in range(A.nvars))
        node = self.relax_type.startswith("node")
        while (len(levels) < self.max_levels - 1
               and A.n_rows > self.max_coarse_size):
            candidates = [d for d in range(A.ndim) if A.shape[d] >= 3]
            if not candidates:
                break
            cdir = min(candidates, key=lambda d: dxyz[d])
            dxyz = np.asarray(dxyz, float).copy()
            dxyz[cdir] *= 2
            # block-diagonal interpolation (sys_pfmg_setup_interp.c)
            Ps = tuple(semi_interp_from_matrix(A.block(v, v), cdir)
                       for v in range(A.nvars))
            cshape = coarse_shape(A.shape, cdir)
            ext = tuple(1 if d == cdir else A.stencil.extent[d]
                        for d in range(A.ndim))
            Ac = _probe_sys(sys_rap_apply, A.nvars, cshape, ext, A.dtype,
                            A.device, (A, Ps))
            ci = A.stencil.center_index()
            diag = torch.stack([A.coeffs[v, v, ci].expand(A.shape)
                                for v in range(A.nvars)])
            nz = diag != 0
            dinv = torch.where(nz, 1.0 / torch.where(nz, diag,
                                                     torch.ones_like(diag)),
                               torch.zeros_like(diag))
            levels.append(SysPFMGLevel(
                A=A, P=Ps, dinv=dinv,
                node_dinv=_node_block_inverse(A) if node else None,
                red=parity_mask(A.shape, A.device) if node else None))
            A = Ac
        self.coarse_inv = coarse_pinv(A)
        self.coarse_meta = (A.nvars, A.shape)
        self.coarse_A = A
        self.levels = levels
        return self

    @property
    def cdirs(self) -> list:
        return [lev.P[0].cdir for lev in self.levels]

    def _relax(self, lev: SysPFMGLevel, u, f, sweeps):
        if self.relax_type == "node-jacobi":
            for _ in range(sweeps):
                r = f - lev.A.mv(u)
                u = u + self.jacobi_weight * _block_apply(lev.node_dinv, r)
            return u
        if self.relax_type == "node-rbgs":
            # full node solves on the red checkerboard, then the black,
            # each against a fresh residual (node_relax.c's nodal GS
            # ordering; no damping)
            for _ in range(sweeps):
                for red in (True, False):
                    r = f - lev.A.mv(u)
                    du = _block_apply(lev.node_dinv, r)
                    on = lev.red if red else ~lev.red
                    u = u + torch.where(on, du, torch.zeros_like(du))
            return u
        for _ in range(sweeps):
            u = u + self.jacobi_weight * lev.dinv * (f - lev.A.mv(u))
        return u

    def cycle(self, f: torch.Tensor,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
        assert self.levels is not None, "call setup(A) first"

        def descend(level, f, u):
            if level == len(self.levels):
                nv, shp = self.coarse_meta
                return (self.coarse_inv @ f.reshape(-1)).reshape((nv,) + shp)
            lev = self.levels[level]
            u = self._relax(lev, u, f, self.num_pre_relax)
            r = f - lev.A.mv(u)
            rc = torch.stack([P.apply_t(r[v]) for v, P in enumerate(lev.P)])
            ec = descend(level + 1, rc, torch.zeros_like(rc))
            u = u + torch.stack([P.apply(ec[v])
                                 for v, P in enumerate(lev.P)])
            return self._relax(lev, u, f, self.num_post_relax)

        if u is None:
            u = torch.zeros_like(f)
        return descend(0, f, u)

    def precond(self):
        nv, shp = ((self.levels[0].A.nvars, self.levels[0].A.shape)
                   if self.levels else self.coarse_meta)

        def M(r):
            flat = r.dim() == 1
            z = self.cycle(r.reshape((nv,) + shp) if flat else r)
            return z.reshape(-1) if flat else z

        return M

    def solve(
        self,
        b: torch.Tensor,
        x0: Optional[torch.Tensor] = None,
        rtol: float = 1e-6,
        maxiter: int = 200,
    ) -> tuple[torch.Tensor, ConvergenceInfo]:
        assert self.levels is not None, "call setup(A) first"
        if not self.levels:  # the problem fit in the coarse solve
            nv, shp = self.coarse_meta
            x = (self.coarse_inv @ b.reshape(-1)).reshape((nv,) + shp)
            return x, make_convergence_info(1, 0.0, True)
        return stationary_solve(lambda x: self.cycle(b, x),
                                self.levels[0].A, b, x0, rtol, maxiter)
