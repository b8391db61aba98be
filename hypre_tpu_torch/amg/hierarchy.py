"""AMG hierarchy setup and multilevel cycling.

Counterpart of ``hypre_tpu/amg/hierarchy.py`` (hypre_BoomerAMGSetup,
``parcsr_ls/par_amg_setup.c:28``, and hypre_BoomerAMGCycle,
``par_cycle.c:23``), for the pure setup path: strength, PMIS, extended+i
interpolation with truncation, and Galerkin RAP through the sort-based
SpGEMM, all as tensor operations on the hierarchy's device, driven by a
host loop that reads back only sizes. ``optimize_hierarchy`` then swaps
each level operator for its kernel format (DIA on stencil levels, the
banded gather elsewhere), and ``amg_cycle`` runs V/W/F cycles over the
level list.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from hypre_tpu_torch.amg.coarsen import coarse_map, pmis
from hypre_tpu_torch.amg.interp import ext_plus_i_interp, truncate_interp
from hypre_tpu_torch.amg.relax import (
    chebyshev, jacobi, l1_jacobi, l1_norms, max_eig_estimate,
    max_eig_estimate_cg,
)
from hypre_tpu_torch.amg.strength import strength_mask
from hypre_tpu_torch.core.config import resolve_device, tensors_to
from hypre_tpu_torch.seq.dia import DiaMatrix
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.fastmv import BandedEll, banded_spmv_t, \
    optimize_operator, with_transpose_schedule
from hypre_tpu_torch.seq.spgemm import ell_spgemm, ell_transpose


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
            raise ValueError("unpad_hierarchy needs ELL transfers")
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


def _level_vectors(A: EllMatrix, need_cheby: bool):
    diag = A.diagonal()
    nz = diag != 0
    dinv = torch.where(nz, 1.0 / torch.where(nz, diag, torch.ones_like(diag)),
                       torch.zeros_like(diag))
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

    The port has the reference's pure path (``setup_backend="jax"``, which
    ``"auto"`` also selects) with PMIS coarsening and extended+i
    interpolation. The host C++ setup (``"native"``) and the on-device
    setup (``"device"``) are ROADMAP Queue 1 items 15 and 7.
    """
    if setup_backend in ("native", "device"):
        item = "15" if setup_backend == "native" else "7"
        raise NotImplementedError(
            f"setup_backend={setup_backend!r} is not ported yet "
            f"(ROADMAP.md Queue 1 item {item}); use setup_backend='jax'")
    if setup_backend not in ("jax", "auto"):
        raise ValueError(f"unknown setup backend: {setup_backend!r}")
    if coarsen != "pmis" or interp != "ext+i":
        raise NotImplementedError(
            "the port's setup covers coarsen='pmis' with interp='ext+i' "
            f"(got coarsen={coarsen!r}, interp={interp!r})")
    if (interp_jacobi_passes or agg_num_levels or nongalerkin_tol
            or restrict_type != "transpose"):
        raise NotImplementedError(
            "Jacobi-improved interpolation, aggressive coarsening, "
            "non-Galerkin coarsening and AIR restriction are not ported yet")
    A = A.to(resolve_device(device))
    need_cheby = relax == "chebyshev"
    levels: List[Level] = []

    while len(levels) < max_levels - 1 and A.n_rows > max_coarse_size:
        S = strength_mask(A, strength_threshold, max_row_sum)
        cf = pmis(A, S)
        cmap, n_c = coarse_map(cf)
        n_coarse = int(n_c)
        if n_coarse == 0 or n_coarse >= coarsen_rtol * A.n_rows:
            break  # coarsening stalled (par_amg_setup.c stops similarly)
        P = ext_plus_i_interp(A, S, cf, cmap, n_coarse)
        P = truncate_interp(P, max_elmts=p_max_elmts, trunc_factor=trunc_factor)
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
                        galerkin=True)


def make_smoother(relax: str, relax_weight: float, cheby_order: int,
                  cheby_ratio: float, relax_order: int = 0):
    """Bind a relax-type string to a (level, u, f) -> u function (the
    hypre_BoomerAMGRelax relax_type dispatch, par_relax.c:78-160). The port
    has Jacobi, ℓ1-Jacobi and Chebyshev; CF ordering comes later."""
    if relax_order != 0:
        raise NotImplementedError("CF-ordered relaxation is not ported yet")
    if relax == "jacobi":
        return lambda lev, u, f: jacobi(
            lev.A, lev.dinv, u, f,
            relax_weight if lev.rw is None else lev.rw,
        )
    if relax == "l1-jacobi":
        return lambda lev, u, f: l1_jacobi(lev.A, lev.l1inv, u, f)
    if relax == "chebyshev":
        return lambda lev, u, f: chebyshev(
            lev.A, lev.dinv, lev.lmax, u, f, order=cheby_order,
            eig_ratio=cheby_ratio,
        )
    raise NotImplementedError(f"relax type {relax!r} is not ported yet")


def _restrict_level(lev: Level, r: torch.Tensor) -> torch.Tensor:
    # Pt=None marks a Galerkin level whose restriction runs through P's
    # transpose kernel, from the schedule optimize_hierarchy built
    if lev.Pt is None:
        return banded_spmv_t(lev.P, r)
    return lev.Pt.mv(r)


def amg_cycle(
    hier: AMGHierarchy,
    f: torch.Tensor,
    u: Optional[torch.Tensor] = None,
    smoother: Optional[Callable] = None,
    num_sweeps: int = 1,
    cycle_type: int = 1,
) -> torch.Tensor:
    """One multigrid cycle (V for cycle_type=1, W for 2, F for 3;
    par_cycle.c:23). ``smoother`` may be a list of per-level callables."""
    smoother = smoother or make_smoother("l1-jacobi", 1.0, 2, 0.3)
    per_level = isinstance(smoother, (list, tuple))

    def descend(level: int, f, u, ctype: int):
        if level == len(hier.levels):
            return hier.coarse_inv @ f
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

    n_pad = hier.levels[0].A.vec_len_rows if hier.levels else (
        hier.coarse_inv.shape[0])
    unpad = 0
    if hier.n_fine and f.shape[0] != n_pad:
        # row-padded hierarchy driven with a true-size vector: pad in,
        # slice out (padded rows carry exact zeros through the cycle)
        unpad = f.shape[0]
        f = torch.cat([f, f.new_zeros(n_pad - unpad)])
        if u is not None:
            u = torch.cat([u, u.new_zeros(n_pad - unpad)])
    if u is None:
        u = torch.zeros_like(f)
    out = descend(0, f, u, cycle_type)
    return out[:unpad] if unpad else out


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
        A = spec_dia(opt(lev.A))
        P = spec_dia(opt(lev.P))
        if isinstance(P, BandedEll) and hier.galerkin:
            # restriction runs through P's transpose kernel, from a
            # schedule built here once; Pt and the duplicate ELL payload
            # would only cost memory
            P = with_transpose_schedule(P).drop_ell()
            Pt = None
        else:
            Pt = spec_dia(opt(lev.Pt))
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
