"""Multi-shard structured grids: slabs with explicit ghost planes.

Counterpart of ``hypre_tpu/struct/par_struct.py``. hypre distributes a
struct grid's boxes over ranks and fills their ghost layers by explicit
exchanges (``struct_mv/struct_communication.c``: CommInfo box lists, a
CommType per peer, strided pack and unpack); the reference leaves the
halos to XLA's SPMD partitioner. The port does hypre's exchange on the
shard mesh of ``parallel/``:

- a sharded grid is split along ``axis`` into one slab per shard (a
  tensor ``(S,) + local_shape``, S the shards this process holds); a
  product pads each slab with ghost planes as deep as the stencil reaches
  along ``axis``, filled by ``comm.shift`` of the neighbours' boundary
  planes (the ring wraps, so a non-periodic grid's end ghosts are zeroed);
- the sharded matvec runs the DIA kernel (kernel 2, ``dia_static_kernel``,
  when the plane count is on its ladder) on the stacked ghosted slabs as
  ONE DIA view: the ghost rows carry zero coefficients and every plane's
  offset stays inside its slab, so one launch serves every shard held.
  The view is built for the ghosted layout (never the one an unsharded
  StructMatrix keeps), its planes masked by the global box as the
  unsharded view's are, in the same order: the sums are the same adds;
- PFMG's interpolation and restriction shift along ``cdir``; when
  ``cdir`` is the sharded axis they read one ghost plane. Red-black
  relaxation takes its colours from global coordinates (the global mask,
  sliced);
- a level whose grid does not split into equal slabs of at least the
  ghost depth is replicated (the reference's ``_placeable`` rule; hypre
  coalesces small grids onto fewer ranks): the transfer into it gathers
  the fine residual, and the one out of it keeps this process's slab.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional

import numpy as np
import torch

from hypre_tpu_torch.core.config import ConvergenceInfo, make_convergence_info
from hypre_tpu_torch.seq.dia import DiaMatrix, on_static_ladder
from hypre_tpu_torch.seq.vector import global_sum
from hypre_tpu_torch.struct.matrix import StructMatrix, _landings, shift
from hypre_tpu_torch.struct.pfmg import PFMG
from hypre_tpu_torch.struct.relax import red_black_gs, weighted_jacobi


@dataclasses.dataclass(frozen=True)
class SlabLayout:
    """A grid of ``shape`` split along ``axis`` into ``mesh.num_shards``
    equal slabs; this process holds ``mesh.local_shards`` of them."""

    shape: tuple
    axis: int
    mesh: object

    @property
    def num_shards(self) -> int:
        return self.mesh.num_shards

    @property
    def local_shape(self) -> tuple:
        s = list(self.shape)
        s[self.axis] //= self.num_shards
        return tuple(s)

    @property
    def slab_dim(self) -> int:
        """The sharded axis in a ``(S,) + local_shape`` tensor."""
        return 1 + self.axis

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """A global grid array (any leading dims after none) -> this
        process's slabs ``(S,) + local_shape``."""
        P, ax = self.num_shards, self.axis
        nl = self.local_shape[ax]
        xs = x.reshape(self.shape[:ax] + (P, nl) + self.shape[ax + 1:])
        xs = xs.movedim(ax, 0)
        m = self.mesh
        return xs[m.first_shard: m.first_shard + m.local_shards].contiguous()

    def gather(self, xs: torch.Tensor) -> torch.Tensor:
        """This process's slabs -> the global grid array, on every
        process (an all-gather on a ``dist`` mesh)."""
        if self.mesh.comm.backend == "dist":
            xs = self.mesh.comm.all_gather(xs.contiguous())
        return xs.movedim(0, self.axis).reshape(self.shape)

    def ghosted(self, xs: torch.Tensor, g: int,
                periodic: bool) -> torch.Tensor:
        """The slabs padded with ``g`` ghost planes on both sides of the
        sharded axis, filled from the neighbouring slabs by two ring
        shifts (zero beyond a non-periodic grid's ends)."""
        if g == 0:
            return xs
        d, nl = self.slab_dim, self.local_shape[self.axis]
        comm = self.mesh.comm
        lo = comm.shift(xs.narrow(d, nl - g, g).contiguous(), 1)
        hi = comm.shift(xs.narrow(d, 0, g).contiguous(), -1)
        if not periodic:
            ids = comm.shard_ids(xs.device).reshape(
                (-1,) + (1,) * (xs.dim() - 1))
            lo = torch.where(ids == 0, torch.zeros_like(lo), lo)
            hi = torch.where(ids == self.num_shards - 1,
                             torch.zeros_like(hi), hi)
        return torch.cat([lo, xs, hi], dim=d)

    def axis_shift(self, xs: torch.Tensor, o: int,
                   periodic: bool) -> torch.Tensor:
        """``shift`` by ``o`` along the sharded axis: z[i] = x[i + o]
        across slab boundaries."""
        g = abs(o)
        ext = self.ghosted(xs, g, periodic)
        return ext.narrow(self.slab_dim, g + o,
                          self.local_shape[self.axis])


def _placeable(shape, mesh, axis: int, depth: int = 1) -> bool:
    P = mesh.num_shards
    return shape[axis] % P == 0 and shape[axis] // P >= max(depth, 1)


def _ghost_depth(A: StructMatrix, axis: int) -> int:
    return max((abs(int(off[axis])) for off in A.stencil.offsets), default=0)


@dataclasses.dataclass
class ShardedStructMatrix:
    """A StructMatrix over slabs: ``mv`` fills the ghost planes and runs
    one DIA product over every slab held (see the module docstring)."""

    A: StructMatrix  # the global operator (its coefficients, its stencil)
    layout: SlabLayout
    depth: int  # ghost planes each side
    dia: DiaMatrix  # the stacked ghosted slabs' view

    @property
    def periodic_axis(self) -> bool:
        return self.A.periodic[self.layout.axis]

    def mv(self, xs: torch.Tensor) -> torch.Tensor:
        """y = A @ x on slabs ``(S,) + local_shape`` (or their flat
        view; y takes x's shape)."""
        lay = self.layout
        x = xs.reshape((-1,) + lay.local_shape)
        ext = lay.ghosted(x, self.depth, self.periodic_axis)
        y = self.dia.mv(ext.reshape(-1)).reshape(ext.shape)
        y = y.narrow(lay.slab_dim, self.depth, lay.local_shape[lay.axis])
        return y.reshape(xs.shape)


def sharded_dia_view(A: StructMatrix, layout: SlabLayout,
                     depth: int) -> DiaMatrix:
    """The DIA view of the stacked ghosted slabs: every plane of the
    unsharded view (same stencil order, same global-box masks), cut into
    slabs, ghost rows zero, offsets in the ghosted slab's strides. Along a
    periodic sharded axis the wrap comes from the ring exchange, so that
    axis keeps one unmasked landing."""
    ax, nd = layout.axis, A.ndim
    G = list(layout.local_shape)
    G[ax] += 2 * depth
    strides = [int(np.prod(G[d + 1:])) for d in range(nd)]
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    planes, offsets = [], []
    for s, off in enumerate(A.stencil.offsets):
        dims = []
        for d in range(nd):
            o = int(off[d])
            if d == ax and A.periodic[d]:
                dims.append([(o, np.ones(A.shape[d], bool))])
            else:
                dims.append(_landings(o, A.shape[d],
                                      A.periodic[d] and d != ax))
        for combo in itertools.product(*dims):
            mask = None
            for d, (_, m) in enumerate(combo):
                if m.all():
                    continue
                md = torch.from_numpy(m).to(A.device).reshape(
                    [-1 if e == d else 1 for e in range(nd)])
                mask = md if mask is None else mask & md
            c = A.coeff(s).expand(A.shape)
            plane = c if mask is None else torch.where(mask, c, zero)
            slabs = layout.split(plane)
            pad = [0, 0] * nd
            pad[2 * (nd - 1 - ax)] = pad[2 * (nd - 1 - ax) + 1] = depth
            planes.append(torch.nn.functional.pad(slabs, pad).reshape(-1))
            offsets.append(sum(delta * strides[d]
                               for d, (delta, _) in enumerate(combo)))
    offs = tuple(offsets)
    return DiaMatrix(dvals=torch.stack(planes), offsets=offs,
                     n_cols=planes[0].shape[0],
                     offsets_static=offs if on_static_ladder(len(offs))
                     else None)


def distribute_struct_vector(x: torch.Tensor, mesh, axis: int = 0):
    """This process's slabs of a global grid vector, on the mesh's device,
    or the whole vector where the grid does not split (replicated)."""
    x = x.to(mesh.device)
    if not _placeable(tuple(x.shape), mesh, axis):
        return x
    return SlabLayout(tuple(x.shape), axis, mesh).split(x)


def distribute_struct_matrix(A: StructMatrix, mesh, axis: int = 0):
    """A ShardedStructMatrix over ``mesh``, or A itself on the mesh's
    device where its grid does not split into slabs at least as deep as
    its stencil reaches (replicated)."""
    A = A.to(mesh.device)
    depth = _ghost_depth(A, axis)
    if not _placeable(A.shape, mesh, axis, depth):
        return A
    layout = SlabLayout(A.shape, axis, mesh)
    return ShardedStructMatrix(A=A, layout=layout, depth=depth,
                               dia=sharded_dia_view(A, layout, depth))


@dataclasses.dataclass
class _Level:
    A: object  # ShardedStructMatrix | StructMatrix
    layout: Optional[SlabLayout]  # None: replicated
    P: object  # the global SemiInterp (None on the coarsest level)
    w_lo: torch.Tensor  # in the level's layout
    w_hi: torch.Tensor
    dinv: torch.Tensor
    red: torch.Tensor


def _in_layout(layout, t: torch.Tensor) -> torch.Tensor:
    return t if layout is None else layout.split(t)


@dataclasses.dataclass
class ShardedPFMG:
    """A set-up PFMG hierarchy placed on a shard mesh
    (``distribute_pfmg``): the same V-cycle on slabs."""

    solver: PFMG
    levels: List[_Level]
    coarse_layout: Optional[SlabLayout]
    coarse_inv: torch.Tensor
    mesh: object

    @property
    def fine_layout(self) -> Optional[SlabLayout]:
        return self.levels[0].layout if self.levels else self.coarse_layout

    def _layout_below(self, l: int):
        return (self.levels[l + 1].layout if l + 1 < len(self.levels)
                else self.coarse_layout)

    def _restrict(self, lev: _Level, lay_c, r):
        P = lev.P
        if lev.layout is None or lay_c is None:
            if lev.layout is not None:
                r = lev.layout.gather(r)
            rc = P.apply_t(r)
            return rc if lay_c is None else lay_c.split(rc)
        e = [0] * len(P.fine_shape)
        e[P.cdir] = 1
        per = P.periodic[P.cdir]
        if P.cdir == lev.layout.axis:
            up = lev.layout.axis_shift(lev.w_lo * r, 1, per)
            dn = lev.layout.axis_shift(lev.w_hi * r, -1, per)
        else:
            up = shift(lev.w_lo * r, tuple(e), P.periodic)
            dn = shift(lev.w_hi * r, tuple(-v for v in e), P.periodic)
        acc = r + up + dn
        return acc[(slice(None),) + self._even(P)].contiguous()

    @staticmethod
    def _even(P) -> tuple:
        return tuple(slice(None, None, 2) if d == P.cdir else slice(None)
                     for d in range(len(P.fine_shape)))

    def _interp(self, lev: _Level, lay_c, ec):
        P = lev.P
        if lev.layout is None or lay_c is None:
            if lay_c is not None:
                ec = lay_c.gather(ec)
            e = P.apply(ec)
            return e if lev.layout is None else lev.layout.split(e)
        xe = ec.new_zeros((ec.shape[0],) + lev.layout.local_shape)
        xe[(slice(None),) + self._even(P)] = ec
        e = [0] * len(P.fine_shape)
        e[P.cdir] = 1
        per = P.periodic[P.cdir]
        if P.cdir == lev.layout.axis:
            lo = lev.layout.axis_shift(xe, -1, per)
            hi = lev.layout.axis_shift(xe, 1, per)
        else:
            lo = shift(xe, tuple(-v for v in e), P.periodic)
            hi = shift(xe, tuple(e), P.periodic)
        return xe + lev.w_lo * lo + lev.w_hi * hi

    def _coarse_solve(self, f):
        lay = self.coarse_layout
        full = f if lay is None else lay.gather(f)
        x = (self.coarse_inv @ full.reshape(-1)).reshape(full.shape)
        return x if lay is None else lay.split(x)

    def _smooth(self, lev: _Level, u, f, sweeps: int):
        s = self.solver
        for _ in range(sweeps):
            if s.relax_type == "jacobi":
                u = weighted_jacobi(lev.A, lev.dinv, u, f, s.jacobi_weight)
            else:
                u = red_black_gs(lev.A, lev.dinv, lev.red, u, f)
        return u

    def cycle(self, f: torch.Tensor,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One V-cycle on the fine level's layout (PFMG.cycle on slabs)."""
        s = self.solver

        def descend(l, f, u):
            if l == len(self.levels):
                return self._coarse_solve(f)
            lev = self.levels[l]
            lay_c = self._layout_below(l)
            u = self._smooth(lev, u, f, s.num_pre_relax)
            rc = self._restrict(lev, lay_c, f - lev.A.mv(u))
            u = u + self._interp(lev, lay_c,
                                 descend(l + 1, rc, torch.zeros_like(rc)))
            return self._smooth(lev, u, f, s.num_post_relax)

        return descend(0, f, torch.zeros_like(f) if u is None else u)

    def _shape(self):
        lay = self.fine_layout
        if lay is not None:
            return (-1,) + lay.local_shape
        A = self.levels[0].A if self.levels else None
        return A.shape if A is not None else self.solver.hierarchy.coarse_shape

    def precond(self):
        """Krylov M on flat (or slab-shaped) vectors of the fine layout."""
        shape = self._shape()

        def M(r):
            z = self.cycle(r.reshape(shape))
            return z.reshape(r.shape)

        return M

    def operator(self):
        """The fine operator as a Krylov A on flat vectors."""
        A, shape = self.levels[0].A, self._shape()
        return lambda x: A.mv(x.reshape(shape)).reshape(x.shape)

    def solve(self, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
              rtol: float = 1e-6, maxiter: int = 200,
              ) -> tuple[torch.Tensor, ConvergenceInfo]:
        """PFMG as a solver (``PFMG.solve``) on the fine layout's slabs;
        the norms are global sums over the mesh."""
        A = self.levels[0].A
        mesh = self.mesh if self.fine_layout is not None else None

        def sq(v):
            return global_sum(torch.sum(v * v), mesh)

        x = torch.zeros_like(b) if x0 is None else x0
        b2 = sq(b)
        eps = rtol * rtol * b2
        r2 = sq(b - A.mv(x))
        it = 0
        while it < maxiter and bool((r2 > eps) & torch.isfinite(r2)):
            x = self.cycle(b, x)
            r2 = sq(b - A.mv(x))
            it += 1
        safe = torch.where(b2 > 0, b2, torch.ones_like(b2))
        rel = torch.sqrt(torch.clamp(r2, min=0.0) / safe)
        return x, make_convergence_info(it, rel, (r2 <= eps) | (b2 == 0))


def distribute_pfmg(solver: PFMG, mesh, axis: int = 0) -> ShardedPFMG:
    """A set-up PFMG hierarchy placed on ``mesh``: every level whose grid
    still splits into slabs runs sharded (its operator a
    ShardedStructMatrix, its weights, inverse diagonal and red mask
    sliced from the global ones); smaller coarse grids are replicated."""
    hier = solver.hierarchy
    assert hier is not None, "call setup(A) first"
    levels = []
    for lev in hier.levels:
        A = distribute_struct_matrix(lev.A, mesh, axis)
        lay = A.layout if isinstance(A, ShardedStructMatrix) else None
        P = dataclasses.replace(lev.P, w_lo=lev.P.w_lo.to(mesh.device),
                                w_hi=lev.P.w_hi.to(mesh.device))
        levels.append(_Level(
            A=A, layout=lay, P=P, w_lo=_in_layout(lay, P.w_lo),
            w_hi=_in_layout(lay, P.w_hi),
            dinv=_in_layout(lay, lev.dinv.to(mesh.device)),
            red=_in_layout(lay, lev.red.to(mesh.device))))
    cA = hier.coarse_A
    coarse_lay = (SlabLayout(cA.shape, axis, mesh)
                  if _placeable(cA.shape, mesh, axis) else None)
    return ShardedPFMG(solver=solver, levels=levels,
                       coarse_layout=coarse_lay,
                       coarse_inv=hier.coarse_inv.to(mesh.device),
                       mesh=mesh)
