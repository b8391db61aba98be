"""AMG hierarchy setup and multilevel cycling.

Counterpart of ``hypre_tpu/amg/hierarchy.py`` (hypre_BoomerAMGSetup,
``parcsr_ls/par_amg_setup.c:28``, and hypre_BoomerAMGCycle,
``par_cycle.c:23``). The pure setup path runs strength, a coarsening
(PMIS, CLJP, Ruge-Stüben/Falgout, HMIS or CGC), an interpolation
(extended+i, direct, classical or multipass, optionally Jacobi-improved)
with truncation, and a Galerkin RAP through the sort-based SpGEMM — or
R A P with an AIR restriction — as tensor operations on the hierarchy's
device, driven by a host loop that reads back only sizes (the RS family
runs its greedy pass on the host). ``setup_backend="native"`` runs the
level loop on host CSR arrays through the C++ kernels of ``native.py``
(hypre's own split: setup in C on the host), with aggressive and
non-Galerkin coarsening, and builds each level's tensors on the device
once; ``"auto"`` takes it whenever the knobs are covered and the library
builds, as the reference does. ``setup_backend="device"`` dispatches
to the slab-formulated on-device setup of ``amg/device_setup.py``, which
also has aggressive coarsening. ``optimize_hierarchy`` then swaps each
level operator for its kernel format (DIA on stencil levels, the banded
gather elsewhere; a ``TransferDia`` passes through). ``amg_cycle`` runs
V/W/F cycles over the level list, ``amg_cycle_t`` the transpose V-cycle
and ``amg_additive_cycle`` the additive variants.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from hypre_tpu_torch.amg.coarsen import (
    cgc, cljp, coarse_map, hmis, pmis, ruge_stuben,
)
from hypre_tpu_torch.amg.interp import (
    classical_interp, direct_interp, ext_plus_i_interp,
    jacobi_improve_interp, multipass_interp, truncate_interp,
)
from hypre_tpu_torch.amg.relax import (
    cf_jacobi, chebyshev, jacobi, kaczmarz, l1_jacobi, l1_norms,
    max_eig_estimate, max_eig_estimate_cg, row_norms_sq_inv,
    sym_two_stage_gs, two_stage_gs,
)
from hypre_tpu_torch.amg.strength import strength_mask
from hypre_tpu_torch import native
from hypre_tpu_torch.core.config import PAD_COL, resolve_device, tensors_to
from hypre_tpu_torch.core.timing import annotate
from hypre_tpu_torch.seq.dia import DiaMatrix, compact_dia
from hypre_tpu_torch.seq.ell import EllMatrix, _np_dtype
from hypre_tpu_torch.seq.fastmv import BandedEll, banded_spmv_t, \
    optimize_operator, with_transpose_schedule
from hypre_tpu_torch.seq.spgemm import ell_spgemm, ell_transpose
from hypre_tpu_torch.seq.transfer_dia import TransferDia


@dataclasses.dataclass(frozen=True)
class Level:
    """One multigrid level's operators (hypre's A_array/P_array/R_array
    slots in hypre_ParAMGData, par_amg.h)."""

    A: object  # EllMatrix | DiaMatrix | BandedEll
    P: Optional[object]
    Pt: Optional[object]  # None when restriction runs through P's transpose
    dinv: torch.Tensor  # 1/diag
    l1inv: torch.Tensor  # 1/l1 row norms
    lmax: torch.Tensor  # D^{-1}A spectral bound for Chebyshev
    rw: Optional[torch.Tensor] = None  # optional per-level Jacobi weight
    cf: Optional[torch.Tensor] = None  # CF splitting (+1 C / -1 F), int8

    def to(self, device) -> "Level":
        return tensors_to(self, device)


@dataclasses.dataclass(frozen=True)
class AMGHierarchy:
    levels: List[Level]
    coarse_inv: torch.Tensor  # dense (pseudo)inverse of the coarsest operator
    galerkin: bool = True
    # true fine row count of a row-padded hierarchy (0 = unpadded) and the
    # true row count of every level; amg_cycle pads/unpads vectors
    n_fine: int = 0
    n_level_true: tuple = ()
    # the shard mesh of a partitioned hierarchy (parallel/par_amg.py); on
    # a ``dist`` mesh the coarse solve gathers its right-hand side
    mesh: object = None
    # True when the device setup built it by replaying a recorded ladder
    # (amg/device_setup.py), False when it took the slow path
    replayed: bool = False

    @property
    def num_levels(self) -> int:
        return len(self.levels) + 1

    @property
    def device(self) -> torch.device:
        return self.coarse_inv.device

    def to(self, device) -> "AMGHierarchy":
        return tensors_to(self, device)


def unpad_hierarchy(hier: AMGHierarchy) -> AMGHierarchy:
    """True-size view of a row-padded hierarchy (a slice: padded rows are
    empty rows appended after the true ones). Returns ``hier`` unchanged
    when it was never padded."""
    if not hier.n_fine or not hier.n_level_true:
        return hier
    ts = hier.n_level_true
    new_levels = []
    for i, lv in enumerate(hier.levels):
        nt, nc = ts[i], ts[i + 1]
        if not isinstance(lv.P, EllMatrix) or (
            lv.Pt is not None and not isinstance(lv.Pt, EllMatrix)
        ):
            raise ValueError("unpad_hierarchy needs ELL transfers "
                             "(transfer_dia hierarchies stay padded)")
        new_levels.append(dataclasses.replace(
            lv,
            A=EllMatrix(vals=lv.A.vals[:nt], cols=lv.A.cols[:nt], n_cols=nt),
            P=EllMatrix(vals=lv.P.vals[:nt], cols=lv.P.cols[:nt], n_cols=nc),
            Pt=(None if lv.Pt is None else
                EllMatrix(vals=lv.Pt.vals[:nc], cols=lv.Pt.cols[:nc],
                          n_cols=nt)),
            dinv=lv.dinv[:nt], l1inv=lv.l1inv[:nt],
            cf=None if lv.cf is None else lv.cf[:nt],
        ))
    nco = ts[-1]
    return dataclasses.replace(
        hier, levels=new_levels, coarse_inv=hier.coarse_inv[:nco, :nco],
        n_fine=0, n_level_true=(),
    )


def _reciprocal(d: torch.Tensor) -> torch.Tensor:
    """1 / d where d != 0, else 0 (the inverse diagonal of a smoother)."""
    nz = d != 0
    return torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                       torch.zeros_like(d))


def _level_vectors(A: EllMatrix, need_cheby: bool):
    dinv = _reciprocal(A.diagonal())
    l1inv = 1.0 / l1_norms(A)
    if need_cheby:
        lmax = max_eig_estimate(A, dinv)
    else:
        lmax = torch.zeros((), dtype=A.dtype, device=A.device)
    return dinv, l1inv, lmax


def _coarse_pinv(A: EllMatrix) -> torch.Tensor:
    """Dense pseudo-inverse of the coarsest operator, with the reference's
    cutoff: singular values below 10*max(M,N)*eps of the largest."""
    dense = torch.zeros((A.n_rows, A.n_cols), dtype=A.dtype, device=A.device)
    rows = torch.arange(A.n_rows, device=A.device)[:, None].expand(A.cols.shape)
    dense.index_put_(
        (rows, A.cols.clamp(min=0).long()),
        torch.where(A.cols >= 0, A.vals, torch.zeros_like(A.vals)),
        accumulate=True)
    rtol = 10.0 * max(A.n_rows, A.n_cols, 1) * torch.finfo(A.dtype).eps
    return torch.linalg.pinv(dense, rtol=rtol)


COARSENINGS = ("pmis", "cljp", "ruge", "falgout", "hmis", "cgc")


def _coarsen(coarsen: str, A, S):
    if coarsen == "pmis":
        return pmis(A, S)
    if coarsen == "cljp":
        return cljp(A, S)
    if coarsen in ("ruge", "falgout"):
        # Falgout on one shard is RS everywhere: CLJP's boundary pass has
        # no shard boundary to work on
        return ruge_stuben(A, S)
    if coarsen == "hmis":
        return hmis(A, S)
    return cgc(A, S)


def _interpolate(interp: str, A, S, cf, cmap, n_coarse: int,
                 p_max_elmts: int):
    if interp == "ext+i":
        return ext_plus_i_interp(A, S, cf, cmap, n_coarse)
    if interp == "direct":
        return direct_interp(A, S, cf, cmap, n_coarse)
    if interp == "classical":
        return classical_interp(A, S, cf, cmap, n_coarse)
    if interp == "multipass":
        return multipass_interp(A, S, cf, cmap, n_coarse,
                                p_max_elmts=p_max_elmts)
    raise ValueError(f"unknown interp type: {interp!r}")


NATIVE_COARSENINGS = ("pmis", "ruge", "hmis", "falgout")
NATIVE_INTERPS = ("ext+i", "direct")


def resolve_setup_backend(setup_backend: str, interp: str = "ext+i",
                          coarsen: str = "pmis",
                          interp_jacobi_passes: int = 0,
                          restrict_type: str = "transpose",
                          agg_num_levels: int = 0,
                          nongalerkin_tol: float = 0.0) -> str:
    """The setup path ``setup_hierarchy`` takes for these knobs: 'auto'
    becomes 'native' when the host C++ setup covers them (PMIS or the RS
    family, ext+i or direct, no Jacobi-improved interpolation, Galerkin
    restriction) and its library builds, else 'jax', as the reference's
    rule does (``hypre_tpu/amg/hierarchy.py:191-206``); aggressive and
    non-Galerkin coarsening outside that raise. An explicit 'native' runs
    whatever was asked, as the reference's does: ext+i for any
    interpolation but direct, the RS pass for any coarsening but PMIS
    (HMIS adds its cleanup), Galerkin restriction and no Jacobi passes;
    it raises when its library does not build."""
    if setup_backend not in ("auto", "jax", "native", "device"):
        raise ValueError(f"unknown setup backend: {setup_backend!r}")
    if setup_backend not in ("auto", "native"):
        return setup_backend
    if setup_backend == "native":
        native.build()  # raises with g++'s output
        return "native"
    covered = (interp in NATIVE_INTERPS and coarsen in NATIVE_COARSENINGS
               and interp_jacobi_passes == 0 and restrict_type == "transpose")
    covered = covered and native.available()
    if nongalerkin_tol > 0 and not covered:
        raise ValueError("nongalerkin_tol requires the native setup path")
    if agg_num_levels > 0 and not covered:
        raise ValueError(
            "aggressive coarsening requires the native setup backend")
    return "native" if covered else "jax"


def setup_hierarchy(
    A: EllMatrix,
    strength_threshold: float = 0.25,
    max_row_sum: float = 1.0,
    max_levels: int = 25,
    max_coarse_size: int = 64,
    p_max_elmts: int = 4,
    trunc_factor: float = 0.0,
    interp: str = "ext+i",
    relax: str = "chebyshev",
    coarsen_rtol: float = 0.9,
    coarsen: str = "pmis",
    interp_jacobi_passes: int = 0,
    setup_backend: str = "auto",
    agg_num_levels: int = 0,
    restrict_type: str = "transpose",
    nongalerkin_tol: float = 0.0,
    device=None,
) -> AMGHierarchy:
    """Build the multigrid hierarchy (BoomerAMG setup phase) on ``device``
    (CUDA unless the caller names another; A is moved there).

    coarsen: 'pmis' (8) | 'cljp' (0) | 'ruge' (1) | 'falgout' (6, RS on
    one shard) | 'hmis' (10) | 'cgc' (21). interp: 'ext+i' | 'direct' |
    'classical' | 'multipass'; ``interp_jacobi_passes`` Jacobi passes
    improve P. restrict_type: 'transpose' (Galerkin R = P^T) or 'air'
    (approximate ideal restriction; the hierarchy is then non-Galerkin
    and each level's Pt holds R).

    setup_backend: 'native' runs the level loop on host CSR arrays through
    the C++ kernels of ``native.py`` (PMIS or RS/HMIS/Falgout, ext+i or
    direct, with ``agg_num_levels`` and ``nongalerkin_tol``); 'jax' (the
    reference's name for the pure path) runs the tensor operations on
    ``device``; 'auto' takes 'native' whenever the knobs are covered and
    the library builds, else 'jax' (``resolve_setup_backend``); 'device'
    runs ``device_setup.setup_hierarchy_device`` (PMIS + ext+i, with
    ``agg_num_levels``).
    """
    if setup_backend == "device":
        from hypre_tpu_torch.amg.device_setup import setup_hierarchy_device

        if interp != "ext+i" or coarsen != "pmis":
            raise ValueError(
                "the device setup backend covers pmis + ext+i "
                f"(got coarsen={coarsen!r}, interp={interp!r})")
        if (restrict_type != "transpose" or nongalerkin_tol > 0
                or interp_jacobi_passes > 0):
            raise ValueError(
                "device setup backend: AIR, non-Galerkin and Jacobi-interp "
                "options are not wired to it")
        return setup_hierarchy_device(
            A, strength_threshold=strength_threshold,
            max_row_sum=max_row_sum, max_levels=max_levels,
            max_coarse_size=max_coarse_size, p_max_elmts=p_max_elmts,
            trunc_factor=trunc_factor, relax=relax,
            coarsen_rtol=coarsen_rtol, agg_num_levels=agg_num_levels,
            device=device)
    setup_backend = resolve_setup_backend(
        setup_backend, interp=interp, coarsen=coarsen,
        interp_jacobi_passes=interp_jacobi_passes,
        restrict_type=restrict_type, agg_num_levels=agg_num_levels,
        nongalerkin_tol=nongalerkin_tol)
    if setup_backend == "native":
        return _setup_hierarchy_native(
            A, strength_threshold=strength_threshold,
            max_row_sum=max_row_sum, max_levels=max_levels,
            max_coarse_size=max_coarse_size, p_max_elmts=p_max_elmts,
            trunc_factor=trunc_factor, relax=relax, coarsen=coarsen,
            coarsen_rtol=coarsen_rtol, interp=interp,
            agg_num_levels=agg_num_levels, nongalerkin_tol=nongalerkin_tol,
            device=resolve_device(device))
    if agg_num_levels or nongalerkin_tol:
        raise NotImplementedError(
            "aggressive and non-Galerkin coarsening run on the native setup "
            "(setup_backend='native' or 'auto'); setup_backend='device' has "
            "agg_num_levels")
    if coarsen not in COARSENINGS:
        raise ValueError(f"unknown coarsen type: {coarsen!r}")
    if restrict_type not in ("transpose", "air"):
        raise ValueError(f"unknown restrict type: {restrict_type!r}")
    A = A.to(resolve_device(device))
    need_cheby = relax == "chebyshev"
    levels: List[Level] = []

    while len(levels) < max_levels - 1 and A.n_rows > max_coarse_size:
        S = strength_mask(A, strength_threshold, max_row_sum)
        cf = _coarsen(coarsen, A, S)
        cmap, n_c = coarse_map(cf)
        n_coarse = int(n_c)
        if n_coarse == 0 or n_coarse >= coarsen_rtol * A.n_rows:
            break  # coarsening stalled (par_amg_setup.c stops similarly)
        P = _interpolate(interp, A, S, cf, cmap, n_coarse, p_max_elmts)
        if interp_jacobi_passes > 0:
            P = jacobi_improve_interp(A, P, cf, passes=interp_jacobi_passes,
                                      max_elmts=p_max_elmts,
                                      trunc_factor=trunc_factor)
        P = truncate_interp(P, max_elmts=p_max_elmts, trunc_factor=trunc_factor)
        if restrict_type == "air":
            from hypre_tpu_torch.amg.air import air_restriction

            Pt = air_restriction(A, S, cf, cmap, n_coarse)
        else:
            Pt = ell_transpose(P)
        AP = ell_spgemm(A, P)
        A_coarse = ell_spgemm(Pt, AP)
        dinv, l1inv, lmax = _level_vectors(A, need_cheby)
        levels.append(Level(A=A, P=P, Pt=Pt, dinv=dinv, l1inv=l1inv,
                            lmax=lmax, cf=cf.to(torch.int8)))
        A = A_coarse

    # coarsest: dense pseudo-inverse (hypre's coarse Gaussian elimination,
    # par_gauss_elim.c; pinv tolerates singular coarse operators)
    return AMGHierarchy(levels=levels, coarse_inv=_coarse_pinv(A),
                        galerkin=restrict_type == "transpose")


def make_smoother(relax: str, relax_weight: float, cheby_order: int,
                  cheby_ratio: float, relax_order: int = 0):
    """Bind a relax-type string to a (level, u, f) -> u function (the
    hypre_BoomerAMGRelax relax_type dispatch, par_relax.c:78-160):
    'jacobi' | 'l1-jacobi' | 'chebyshev' | 'two-stage-gs' |
    'sym-two-stage-gs' | 'kaczmarz'.

    relax_order=1 applies hypre's CF ordering (C points first, then F
    points against the updated C values) to the Jacobi-type smoothers;
    the others ignore it, as hypre's dispatch does for relax types without
    a relax_points path. A level's ``rw`` (CG-estimated weight), when set,
    replaces ``relax_weight`` for Jacobi."""
    def jacobi_weight(lev):
        return relax_weight if lev.rw is None else lev.rw

    if relax_order == 1 and relax in ("jacobi", "l1-jacobi"):
        def cf_sm(lev, u, f):
            if lev.cf is None:
                raise ValueError(
                    "relax_order=1 needs the setup path to record the CF "
                    "splitting (Level.cf); this hierarchy has none")
            if relax == "jacobi":
                return cf_jacobi(lev.A, lev.dinv, u, f, lev.cf,
                                 jacobi_weight(lev))
            return cf_jacobi(lev.A, lev.l1inv, u, f, lev.cf, 1.0)

        return cf_sm
    if relax == "jacobi":
        return lambda lev, u, f: jacobi(lev.A, lev.dinv, u, f,
                                        jacobi_weight(lev))
    if relax == "l1-jacobi":
        return lambda lev, u, f: l1_jacobi(lev.A, lev.l1inv, u, f)
    if relax == "chebyshev":
        return lambda lev, u, f: chebyshev(
            lev.A, lev.dinv, lev.lmax, u, f, order=cheby_order,
            eig_ratio=cheby_ratio,
        )
    if relax == "two-stage-gs":
        return lambda lev, u, f: two_stage_gs(lev.A, lev.dinv, u, f)
    if relax == "sym-two-stage-gs":
        return lambda lev, u, f: sym_two_stage_gs(lev.A, lev.dinv, u, f)
    if relax == "kaczmarz":
        # the row norms of each level's operator, computed at its first
        # sweep and kept (with the operator, so the key stays its own)
        norms = {}

        def kacz(lev, u, f):
            key = id(lev.A)
            if key not in norms:
                norms[key] = (lev.A, row_norms_sq_inv(lev.A))
            return kaczmarz(lev.A, norms[key][1], u, f, relax_weight)

        return kacz
    raise ValueError(f"unknown relax type: {relax!r}")


def _restrict_level(lev: Level, r: torch.Tensor) -> torch.Tensor:
    # Pt=None marks a Galerkin level whose restriction runs through P's
    # own transpose path: fine-space diagonals for a stencil level's
    # TransferDia, else the transpose kernel, from the schedule
    # optimize_hierarchy built. A non-Galerkin (AIR) level keeps its R in
    # Pt, which optimize_hierarchy never drops.
    if isinstance(lev.P, TransferDia):
        return lev.P.mv_t(r)
    if lev.Pt is None:
        return banded_spmv_t(lev.P, r)
    return lev.Pt.mv(r)


def coarse_solve(hier: AMGHierarchy, f: torch.Tensor,
                 transpose: bool = False) -> torch.Tensor:
    """The coarsest level's direct solve: the replicated (pseudo)inverse
    times f. On a ``dist`` mesh each process holds its rows of f: gather
    them all, multiply by this process's rows of the inverse and keep its
    own rows of the result (hypre's ``par_gauss_elim.c:84-118`` gathers
    the coarse right-hand side the same way)."""
    inv = hier.coarse_inv.T if transpose else hier.coarse_inv
    mesh = hier.mesh
    if mesh is None or mesh.comm.backend != "dist":
        return inv @ f
    n = f.shape[0]
    full = mesh.comm.all_gather(f.reshape(mesh.local_shards, -1)).reshape(-1)
    lo = mesh.first_shard * n
    return inv[lo: lo + n] @ full


def _pad_in(hier: AMGHierarchy, f: torch.Tensor, u):
    """A row-padded hierarchy driven with true-size vectors: pad f and u
    with zeros (padded rows carry exact zeros through a cycle) and return
    the true size to slice the result back to, or 0."""
    n_pad = hier.levels[0].A.vec_len_rows if hier.levels else (
        hier.coarse_inv.shape[0])
    if not hier.n_fine or f.shape[0] == n_pad:
        return f, (torch.zeros_like(f) if u is None else u), 0
    n = f.shape[0]
    f = torch.cat([f, f.new_zeros(n_pad - n)])
    u = f.new_zeros(n_pad) if u is None else torch.cat(
        [u, u.new_zeros(n_pad - n)])
    return f, u, n


def amg_cycle(
    hier: AMGHierarchy,
    f: torch.Tensor,
    u: Optional[torch.Tensor] = None,
    smoother: Optional[Callable] = None,
    num_sweeps: int = 1,
    cycle_type: int = 1,
) -> torch.Tensor:
    """One multigrid cycle (V for cycle_type=1, W for 2, F for 3;
    par_cycle.c:23). ``smoother`` may be a list of per-level callables.
    Under a recording profiler the cycle is the span ``amg.cycle``, each
    level visit ``amg.L<l>`` (nested as the visits are) and the coarsest
    solve ``amg.coarse`` (hypre's ``HYPRE_ANNOTATE_MGLEVEL_*`` regions)."""
    smoother = smoother or make_smoother("l1-jacobi", 1.0, 2, 0.3)
    per_level = isinstance(smoother, (list, tuple))

    def descend(level: int, f, u, ctype: int):
        if level == len(hier.levels):
            with annotate("amg.coarse"):
                return coarse_solve(hier, f)
        with annotate(f"amg.L{level}"):
            return visit(level, f, u, ctype)

    def visit(level: int, f, u, ctype: int):
        lev = hier.levels[level]
        sm = smoother[level] if per_level else smoother
        for _ in range(num_sweeps):
            u = sm(lev, u, f)
        r = f - lev.A.mv(u)
        rc = _restrict_level(lev, r)
        ec = torch.zeros(lev.P.vec_len_cols, dtype=f.dtype, device=f.device)
        last = level >= len(hier.levels) - 1
        if ctype == 3 and not last:
            # F-cycle: one recursive F-visit, then a V-visit
            ec = descend(level + 1, rc, ec, 3)
            ec = descend(level + 1, rc, ec, 1)
        else:
            visits = 1 if (last or ctype == 3) else max(ctype, 1)
            for _ in range(visits):
                ec = descend(level + 1, rc, ec, ctype if ctype != 3 else 1)
        u = u + lev.P.mv(ec)
        for _ in range(num_sweeps):
            u = sm(lev, u, f)
        return u

    with annotate("amg.cycle"):
        f, u, unpad = _pad_in(hier, f, u)
        out = descend(0, f, u, cycle_type)
        return out[:unpad] if unpad else out


def amg_cycle_t(
    hier: AMGHierarchy,
    f: torch.Tensor,
    u: Optional[torch.Tensor] = None,
    relax_weight: float = 1.0,
    num_sweeps: int = 1,
) -> torch.Tensor:
    """Transpose V-cycle, one multigrid cycle on A^T (hypre_BoomerAMGCycleT,
    par_amg_solveT.c). A Galerkin hierarchy transposes level by level with
    the same transfers (A_{l+1}^T = P^T A_l^T P): every level product
    becomes ``A.mv_t`` and the coarse solve uses the transposed inverse;
    the smoother is damped Jacobi, as hypre forces there (diag(A^T) =
    diag(A)), with a level's own weight ``lev.rw`` where it is set (the
    reference ignores it). A banded level operator needs its transpose
    schedule (``with_operator_transposes``)."""
    if not hier.galerkin:
        raise ValueError(
            "solveT requires a Galerkin hierarchy (AIR stores R != P^T; "
            "its transpose cycle would need R^T interpolation)")

    def descend(level: int, f, u):
        if level == len(hier.levels):
            return coarse_solve(hier, f, transpose=True)
        lev = hier.levels[level]
        w = relax_weight if lev.rw is None else lev.rw
        for _ in range(num_sweeps):
            u = u + w * lev.dinv * (f - lev.A.mv_t(u))
        rc = _restrict_level(lev, f - lev.A.mv_t(u))
        ec = torch.zeros(lev.P.vec_len_cols, dtype=f.dtype, device=f.device)
        u = u + lev.P.mv(descend(level + 1, rc, ec))
        for _ in range(num_sweeps):
            u = u + w * lev.dinv * (f - lev.A.mv_t(u))
        return u

    f, u, unpad = _pad_in(hier, f, u)
    out = descend(0, f, u)
    return out[:unpad] if unpad else out


def amg_additive_cycle(
    hier: AMGHierarchy,
    f: torch.Tensor,
    u: Optional[torch.Tensor] = None,
    smoother: Optional[Callable] = None,
    num_sweeps: int = 1,
    add_start: int = 0,
    variant: str = "additive",
) -> torch.Tensor:
    """Additive, mult-additive or simple-additive cycle
    (hypre_BoomerAMGAdditiveCycle, par_add_cycle.c; HYPRE_BoomerAMGSet
    Additive / MultAdditive / Simple, each from level ``add_start``).

    Levels above ``add_start`` run the multiplicative V recursion; from
    there down the residual cascades through the restrictions untouched
    and every level adds an independent correction, summed up through
    the prolongations:

        B_add = sum_l (P_0 ... P_{l-1}) S_l (P_0 ... P_{l-1})^T

    variant: 'additive' = ``num_sweeps`` smoother sweeps from zero per
    level; 'simple' = one D^{-1} scaling; 'mult' = the level correction
    is post-smoothed against the level residual on the way up."""
    smoother = smoother or make_smoother("l1-jacobi", 1.0, 2, 0.3)
    f, u, unpad = _pad_in(hier, f, u)
    add_start = max(0, min(add_start, len(hier.levels)))

    # multiplicative down-sweep above the additive region
    stack = []
    f_l, u_l = f, u
    for lev in hier.levels[:add_start]:
        for _ in range(num_sweeps):
            u_l = smoother(lev, u_l, f_l)
        stack.append((lev, f_l, u_l))
        f_l = _restrict_level(lev, f_l - lev.A.mv(u_l))
        u_l = torch.zeros(lev.P.vec_len_cols, dtype=f.dtype, device=f.device)

    core = hier.levels[add_start:]
    if core:
        r_cur = f_l - core[0].A.mv(u_l)
        r_list = []
        for lev in core:
            r_list.append(r_cur)
            r_cur = _restrict_level(lev, r_cur)
        acc = coarse_solve(hier, r_cur)
        for lev, r_l in zip(reversed(core), reversed(r_list)):
            if variant == "simple":
                e = lev.dinv * r_l
            else:
                e = torch.zeros_like(r_l)
                for _ in range(num_sweeps):
                    e = smoother(lev, e, r_l)
            e = e + lev.P.mv(acc)
            if variant == "mult":
                for _ in range(num_sweeps):
                    e = smoother(lev, e, r_l)
            acc = e
        u_l = u_l + acc
    else:
        u_l = coarse_solve(hier, f_l)

    # multiplicative up-sweep
    for lev, f_prev, u_prev in reversed(stack):
        u_l = u_prev + lev.P.mv(u_l)
        for _ in range(num_sweeps):
            u_l = smoother(lev, u_l, f_prev)
    return u_l[:unpad] if unpad else u_l


def with_operator_transposes(hier: AMGHierarchy) -> AMGHierarchy:
    """The hierarchy with a transpose schedule on every banded level
    operator A that lacks one, so that ``A.mv_t`` runs (Kaczmarz and the
    transpose cycle). Built once per operator; DIA and ELL operators have
    their own ``mv_t``."""
    levels = [
        dataclasses.replace(lev, A=with_transpose_schedule(lev.A))
        if isinstance(lev.A, BandedEll) and lev.A.t_vals is None else lev
        for lev in hier.levels]
    return dataclasses.replace(hier, levels=levels)


def optimize_hierarchy(
    hier: AMGHierarchy,
    prefer_pallas: bool | None = None,
    gather_precision: int = 0,
    cheby_eig_est: int = 0,
    specialize: bool = False,
    device=None,
) -> AMGHierarchy:
    """Swap every level operator (A, P, Pt) for its kernel format: DIA for
    shift-annotated stencil operators, the banded gather for large
    scattered ones. Run after setup, before the solve phase.

    The hierarchy is moved to ``device`` (CUDA unless the caller names
    another). prefer_pallas (name kept from the reference): build the
    banded formats; None = when the device is CUDA. With True on the CPU
    the formats run their plain versions.

    gather_precision is kept for parity: the port's gather is exact f32.

    cheby_eig_est > 0: re-estimate each level's Chebyshev lambda_max with
    that many Lanczos steps on the optimized operator.

    specialize: compile the diagonal offsets into the DIA kernel (the
    static kernel) instead of reading them from the device.

    A ``TransferDia`` (the device setup's stencil-level interpolation)
    passes through with ``Pt=None``; its two DIA members are specialized
    when asked.

    Every DIA operator kept then goes through ``compact_dia``: planes that
    are mostly zero (a TransferDia's) get the row-list layout, which the
    card's SpMV reads instead of the planes; dense planes stay as they are.

    A banded operator sheds its ELL payload: everything the smoothers and
    cycles ask of it — products, masked lower/upper products, row norms —
    reads the slot-major copy; ``with_operator_transposes`` adds what
    ``A.mv_t`` needs.
    """
    device = resolve_device(device)
    hier = hier.to(device)
    pp = prefer_pallas if prefer_pallas is not None else device.type == "cuda"

    def spec_dia(M):
        if not specialize or not isinstance(M, DiaMatrix):
            return M
        if M.offsets_static is not None:
            return M
        offs = tuple(int(o) for o in M.offsets.cpu().tolist())
        return dataclasses.replace(M, offsets_static=offs)

    def compact(M):
        return compact_dia(M) if isinstance(M, DiaMatrix) else M

    def opt(M):
        if not isinstance(M, EllMatrix):
            return M
        return optimize_operator(M, pp, exact=gather_precision,
                                 dia_detect="shifts", specialize=specialize)

    def refresh_lmax(lev, A_fast):
        if cheby_eig_est <= 0 or float(lev.lmax) == 0.0:
            return lev
        lmax = max_eig_estimate_cg(
            A_fast, lev.dinv, min(cheby_eig_est, A_fast.vec_len_rows))[0]
        return dataclasses.replace(lev, lmax=lmax.to(lev.lmax.dtype))

    new_levels = []
    for lev in hier.levels:
        A = compact(spec_dia(opt(lev.A)))
        if isinstance(lev.P, TransferDia):
            P = dataclasses.replace(
                lev.P, P_dia=compact(spec_dia(lev.P.P_dia)),
                Pt_dia=compact(spec_dia(lev.P.Pt_dia)))
            new_levels.append(
                refresh_lmax(dataclasses.replace(lev, A=A, P=P, Pt=None), A))
            continue
        P = compact(spec_dia(opt(lev.P)))
        if isinstance(P, BandedEll) and hier.galerkin:
            # restriction runs through P's transpose kernel, from a
            # schedule built here once; Pt and the duplicate ELL payload
            # would only cost memory
            P = with_transpose_schedule(P).drop_ell()
            Pt = None
        else:
            Pt = compact(spec_dia(opt(lev.Pt)))
        if isinstance(A, BandedEll):
            A = A.drop_ell()
        if isinstance(Pt, BandedEll):
            Pt = Pt.drop_ell()
        new_levels.append(
            refresh_lmax(dataclasses.replace(lev, A=A, P=P, Pt=Pt), A))
    return AMGHierarchy(
        levels=new_levels, coarse_inv=hier.coarse_inv, galerkin=hier.galerkin,
        n_fine=hier.n_fine, n_level_true=hier.n_level_true,
    )


# ---------------------------------------------------------------------------
# The host C++ setup (csrc/hypre_tpu_native.cpp through native.py)
# ---------------------------------------------------------------------------


def _ell_to_csr_arrays(A: EllMatrix):
    """Host CSR arrays (int32, int32, float64) of an ELL matrix, columns in
    slot order (the C++ kernels take any order within a row)."""
    cols = A.cols.cpu().numpy()
    vals = A.vals.cpu().numpy().astype(np.float64)
    valid = cols >= 0
    Ap = np.zeros(cols.shape[0] + 1, np.int32)
    np.cumsum(valid.sum(axis=1), out=Ap[1:])
    return (cols.shape[0], Ap, cols[valid].astype(np.int32),
            np.ascontiguousarray(vals[valid]))


def _csr_to_ell(n, m, Ap, Aj, Ax, dtype, device) -> EllMatrix:
    """An (n, m) ELL matrix on ``device`` from host CSR arrays, as wide as
    the longest row."""
    counts = np.diff(Ap)
    k = max(int(counts.max(initial=0)), 1)
    vals = np.zeros((n, k), _np_dtype(dtype))
    cols = np.full((n, k), PAD_COL, np.int32)
    rows = np.repeat(np.arange(n), counts)
    within = np.arange(len(Aj)) - np.repeat(Ap[:-1], counts)
    vals[rows, within] = Ax
    cols[rows, within] = Aj
    return EllMatrix(vals=torch.from_numpy(vals).to(device),
                     cols=torch.from_numpy(cols).to(device), n_cols=m)


def _hash01_vec(n: int) -> np.ndarray:
    """The reference's numpy hash_rand01 in float64: the power method's
    start vector."""
    x = np.arange(n, dtype=np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    x = x ^ (x >> np.uint32(16))
    return x.astype(np.float64) / 4294967296.0


def _setup_hierarchy_native(
    A: EllMatrix,
    strength_threshold: float,
    max_levels: int,
    max_coarse_size: int,
    p_max_elmts: int,
    trunc_factor: float,
    relax: str,
    coarsen: str,
    coarsen_rtol: float,
    interp: str = "ext+i",
    agg_num_levels: int = 0,
    nongalerkin_tol: float = 0.0,
    max_row_sum: float = 1.0,
    device=None,
) -> AMGHierarchy:
    """hypre_BoomerAMGSetup through the host C++ kernels (the reference's
    ``_setup_hierarchy_native``): the level loop stays in host CSR arrays
    in float64 from end to end, and each level's tensors are built on
    ``device`` once. The first ``agg_num_levels`` levels coarsen twice and
    interpolate through P1 P2; ``nongalerkin_tol`` sparsifies every coarse
    operator. Chebyshev's lambda_max comes from a host power method."""
    need_cheby = relax == "chebyshev"
    dtype = A.dtype
    levels: List[Level] = []
    n, Ap, Aj, Ax = _ell_to_csr_arrays(A)
    A_ell = A.to(device)

    def one_pass(n, Ap, Aj, Ax):
        """Strength, coarsening and interpolation on one operator: (number
        of C points, P's CSR, CF splitting); 0 when coarsening stalls."""
        S = native.strength(n, Ap, Aj, Ax, strength_threshold, max_row_sum)
        if coarsen == "pmis":
            cf = native.pmis(n, Ap, Aj, S)
        else:  # ruge / falgout / hmis on one shard: the RS first pass
            cf = native.rs(n, Ap, Aj, S)
            if coarsen == "hmis":
                # PMIS cleanup: F points with strong rows but no C neighbor
                for i in np.nonzero(cf == -1)[0]:
                    seg = slice(Ap[i], Ap[i + 1])
                    strong = Aj[seg][S[seg].astype(bool)]
                    if strong.size and not (cf[strong] == 1).any():
                        cf[i] = 1
        is_c = cf == 1
        n_coarse = int(is_c.sum())
        if n_coarse == 0 or n_coarse >= coarsen_rtol * n:
            return 0, None, None
        cmap = np.where(is_c, np.cumsum(is_c) - 1, -1).astype(np.int32)
        make_p = (native.direct_interp if interp == "direct"
                  else native.extpi_interp)
        Pp, Pj, Px = make_p(n, Ap, Aj, Ax, S, cf, cmap)
        if p_max_elmts > 0 or trunc_factor > 0:
            Pp, Pj, Px = native.truncate(n, Pp, Pj, Px, p_max_elmts,
                                         trunc_factor)
        return n_coarse, (Pp, Pj, Px), cf

    def rap(n, nc, Ap, Aj, Ax, Pp, Pj, Px):
        Tp, Tj, Tx = native.transpose(n, nc, Pp, Pj, Px)
        APp, APj, APx = native.spgemm(n, nc, Ap, Aj, Ax, Pp, Pj, Px)
        return (Tp, Tj, Tx), native.spgemm(nc, nc, Tp, Tj, Tx, APp, APj, APx)

    def vector(v):
        return torch.from_numpy(v.astype(_np_dtype(dtype))).to(device)

    while len(levels) < max_levels - 1 and n > max_coarse_size:
        n_coarse, P_csr, cf = one_pass(n, Ap, Aj, Ax)
        if n_coarse == 0:
            break
        Pp, Pj, Px = P_csr
        if len(levels) < agg_num_levels and n_coarse > max_coarse_size:
            # aggressive coarsening (hypre's agg_num_levels,
            # par_2s_interp.c): coarsen the Galerkin operator of the first
            # pass again and interpolate through P1 P2, so the stored
            # hierarchy skips the intermediate grid
            _, (C1p, C1j, C1x) = rap(n, n_coarse, Ap, Aj, Ax, Pp, Pj, Px)
            n2, P2_csr, _ = one_pass(n_coarse, C1p, C1j, C1x)
            if n2 > 0:
                Pp, Pj, Px = native.spgemm(n, n2, Pp, Pj, Px, *P2_csr)
                if p_max_elmts > 0:
                    Pp, Pj, Px = native.truncate(n, Pp, Pj, Px, p_max_elmts,
                                                 trunc_factor)
                n_coarse = n2
        (Tp, Tj, Tx), (Cp, Cj, Cx) = rap(n, n_coarse, Ap, Aj, Ax, Pp, Pj, Px)
        if nongalerkin_tol > 0:
            Cp, Cj, Cx = _nongalerkin_sparsify(n_coarse, Cp, Cj, Cx,
                                               nongalerkin_tol)
        rows = np.repeat(np.arange(n), np.diff(Ap))
        diag = np.zeros(n)
        np.add.at(diag, rows[Aj == rows], Ax[Aj == rows])
        l1 = np.zeros(n)
        np.add.at(l1, rows, np.abs(Ax))
        dinv = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 0.0)
        lmax = 0.0
        if need_cheby:
            # host power method on D^{-1} A, with hypre's 1.1 safety margin
            # (par_relax_more.c:136)
            x = _hash01_vec(n) - 0.5
            x /= np.linalg.norm(x)
            for _ in range(10):
                y = dinv * native.matvec(n, Ap, Aj, Ax, x)
                nrm = np.linalg.norm(y)
                x = y / (nrm if nrm > 0 else 1.0)
            y = dinv * native.matvec(n, Ap, Aj, Ax, x)
            lmax = 1.1 * float(x @ y) / float(x @ x)
        levels.append(Level(
            A=A_ell, P=_csr_to_ell(n, n_coarse, Pp, Pj, Px, dtype, device),
            Pt=_csr_to_ell(n_coarse, n, Tp, Tj, Tx, dtype, device),
            dinv=vector(dinv), l1inv=vector(1.0 / np.where(l1 > 0, l1, 1.0)),
            lmax=torch.tensor(lmax, dtype=dtype, device=device),
            cf=torch.from_numpy(cf.astype(np.int8)).to(device)))
        n, Ap, Aj, Ax = n_coarse, Cp, Cj, Cx
        A_ell = _csr_to_ell(n, n, Ap, Aj, Ax, dtype, device)
    return AMGHierarchy(levels=levels,
                        coarse_inv=vector(_coarse_inverse(n, Ap, Aj, Ax)),
                        galerkin=True)


def _coarse_inverse(n, Ap, Aj, Ax) -> np.ndarray:
    """The coarsest operator's inverse in float64, as the reference's
    native path takes it: the plain inverse where it checks out (much
    cheaper than pinv at n ~ 1500), else the pseudo-inverse. A singular
    operator (pure Neumann, AMS's gradient space) passes through
    ``np.linalg.inv`` without raising, so the inverse is verified."""
    dense = np.zeros((n, n))
    np.add.at(dense, (np.repeat(np.arange(n), np.diff(Ap)), Aj), Ax)
    try:
        inv = np.linalg.inv(dense)
        scale = max(np.abs(dense).max(initial=0.0), 1.0)
        if (np.isfinite(inv).all() and np.abs(inv).max(initial=0.0) * scale
                < 1e12 and np.abs(dense @ inv - np.eye(n)).max(initial=0.0)
                < 1e-6):
            return inv
    except np.linalg.LinAlgError:
        pass
    return np.linalg.pinv(dense, rcond=1e-10)


def _nongalerkin_sparsify(n, Cp, Cj, Cx, tol):
    """Non-Galerkin sparsification of a coarse operator (the reference's
    simplified par_nongalerkin.c): drop the off-diagonal entries with
    |a_ij| < tol sqrt(|a_ii a_jj|) and lump them onto the diagonal, so row
    sums (constants) are kept and the coarse stencil shrinks."""
    rows = np.repeat(np.arange(n), np.diff(Cp))
    diag = np.zeros(n)
    dm = Cj == rows
    np.add.at(diag, rows[dm], Cx[dm])
    scale = np.sqrt(np.abs(diag[rows]) * np.abs(diag[Cj])) + 1e-300
    keep = dm | (np.abs(Cx) >= tol * scale)
    lump = np.zeros(n)
    np.add.at(lump, rows[~keep], Cx[~keep])
    Cx = Cx.copy()
    Cx[dm] += lump[rows[dm]]
    Np = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(rows[keep], minlength=n), out=Np[1:])
    return Np, Cj[keep].astype(np.int32), Cx[keep]
