"""BoomerAMG facade — the user-facing solver object.

Counterpart of ``hypre_tpu/amg/boomeramg.py``: the hypre object protocol
(HYPRE_BoomerAMGCreate / Set<Param> / Setup / Solve,
``parcsr_ls/HYPRE_parcsr_amg.c``) with the knobs of hypre_ParAMGData that
have an implementation (``par_amg.h:19-120``):

    amg = BoomerAMG(strength_threshold=0.25).setup(A)   # on the card
    x, info = amg.solve(b, rtol=1e-8)           # standalone AMG iteration
    x, info = pcg(op, b, M=amg.precond())       # as a Krylov preconditioner

``precond()`` returns one cycle from a zero initial guess, the (precond,
precond_setup) pair hypre plugs into its Krylov vtables collapsed into a
closure. ``setup`` runs on the card unless the caller names the CPU (the
default knobs take the host C++ setup, as the reference's do, and move
each level to the card once), and on the card it swaps the level
operators for the kernel formats (``optimize_hierarchy``), so that the
solve runs the DIA and banded kernels.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from hypre_tpu_torch.amg.hierarchy import (
    AMGHierarchy, amg_additive_cycle, amg_cycle, amg_cycle_t, make_smoother,
    optimize_hierarchy, resolve_setup_backend, setup_hierarchy,
    with_operator_transposes,
)
from hypre_tpu_torch.amg.relax import max_eig_estimate_cg
from hypre_tpu_torch.core.config import (
    ConvergenceInfo, make_convergence_info, resolve_device,
)
from hypre_tpu_torch.core.timing import annotate
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.vector import dot


def _prime(A: EllMatrix) -> bool:
    """The device backend's priming hook (the reference's
    ``boomeramg.py:125-140``): warn when A's setup signature is novel,
    record its shape and signature, and say whether the specialized solve
    applies (a known signature whose exact shape was seen before). The
    shape is recorded on first sight, also when the signature is novel."""
    from hypre_tpu_torch import warmup

    novel, msg = warmup.novel_shape_report(A)
    if novel:
        warnings.warn(f"hypre_tpu_torch: {msg}", stacklevel=3)
    seen = warmup.shape_seen(A)
    warmup._record_setup_signature(A)
    return (not novel) and seen


@dataclasses.dataclass
class BoomerAMG:
    # knob names follow the HYPRE_BoomerAMGSet* setters
    strength_threshold: float = 0.25
    # HYPRE_BoomerAMGSetMaxRowSum (hypre default 0.9; 1.0 disables)
    max_row_sum: float = 0.9
    max_levels: int = 25
    max_coarse_size: int = 1500
    p_max_elmts: int = 4
    trunc_factor: float = 0.0
    # 'pmis' | 'cljp' | 'ruge' | 'falgout' | 'hmis' | 'cgc'
    coarsen_type: str = "pmis"
    interp: str = "ext+i"  # 'ext+i' | 'direct' | 'classical' | 'multipass'
    interp_jacobi_passes: int = 0  # par_jacobi_interp.c improvement passes
    # 'jacobi' | 'l1-jacobi' | 'chebyshev' | 'two-stage-gs' |
    # 'sym-two-stage-gs' | 'kaczmarz'; relax_weight < 0 with 'jacobi'
    # asks for per-level CG-estimated weights (par_cg_relax_wt.c)
    relax: str = "chebyshev"
    relax_weight: float = 1.0
    # HYPRE_BoomerAMGSetRelaxOrder: 1 = C points first, then F points
    relax_order: int = 0
    num_sweeps: int = 1
    cycle_type: int = 1  # 1=V, 2=W, 3=F
    # additive cycling from this level down (-1 = off), variant
    # 'additive' | 'mult' | 'simple' (HYPRE_BoomerAMGSetAdditive /
    # SetMultAdditive / SetSimple)
    additive: int = -1
    additive_variant: str = "additive"
    # 'native' the host C++ setup, 'jax' the pure setup on the device,
    # 'device' the on-device slab setup; 'auto' takes 'native' when the
    # knobs are covered and its library builds, else 'jax', as the
    # reference does (hierarchy.resolve_setup_backend)
    setup_backend: str = "auto"
    # aggressive coarsening on the first N levels ('native' or 'device')
    agg_num_levels: int = 0
    # 'transpose' (Galerkin R = P^T) | 'air' (pair with GMRES)
    restrict_type: str = "transpose"
    # non-Galerkin sparsification of the coarse operators ('native')
    nongalerkin_tol: float = 0.0
    # kept for parity: the port's banded gather is always exact float32
    gather_precision: int = 0
    cheby_order: int = 2
    cheby_ratio: float = 0.3
    # > 0: lambda_max by a CG/Lanczos run of this many steps
    # (HYPRE_BoomerAMGSetChebyEigEst) instead of the power estimate
    cheby_eig_est: int = 0
    # complex smoothers on the finest levels (HYPRE_BoomerAMGSetSmoothType
    # / SetSmoothNumLevels, par_amg_setup.c's smooth dispatch): levels
    # 0..smooth_num_levels-1 smooth with u += w M(f - A u), M the named
    # preconditioner built on that level's operator; the pointwise
    # ``relax`` smoother runs below. '' | 'fsai' | 'ilu' | 'schwarz'
    smooth_type: str = ""
    smooth_num_levels: int = 0
    # damping of the complex smoother's correction
    # (HYPRE_BoomerAMGSetSchwarzRlxWeight)
    smooth_weight: float = 1.0
    # compile the stencil levels' diagonal offsets into the DIA kernel
    specialize: bool = False

    hierarchy: Optional[AMGHierarchy] = dataclasses.field(default=None,
                                                          repr=False)
    # the hierarchy as setup built it, with EllMatrix level operators,
    # before the kernel formats replace them: the complex smoothers are
    # built from it, and stats.amg_setup_report reads it
    ell_hierarchy: Optional[AMGHierarchy] = dataclasses.field(
        default=None, repr=False)
    # set by setup: the bound smoother, and whether the banded level
    # operators have their transpose schedules yet
    _smoother: object = dataclasses.field(default=None, init=False,
                                          repr=False)
    _transposed: bool = dataclasses.field(default=False, init=False,
                                          repr=False)
    # the Jacobi weight of the levels without a CG-estimated one: the
    # knob, or 1.0 when relax_weight < 0 asked for CG weights (the knob
    # itself stays, so that every setup builds them again)
    _weight: float = dataclasses.field(default=1.0, init=False, repr=False)
    # the setup path the last setup took: 'native', 'jax' or 'device'
    # ('' for a subclass with a setup of its own)
    setup_path: str = dataclasses.field(default="", init=False, repr=False)

    def setup(self, A: EllMatrix, host_setup="auto", optimize="auto",
              device=None) -> "BoomerAMG":
        """Build the hierarchy for A on ``device`` (CUDA unless the caller
        names another).

        host_setup: True sets up on the CPU and moves the finished
        hierarchy to the device (the reference's execution-policy split,
        HYPRE_SetExecutionPolicy); 'auto' and False set up on the device.
        The native setup is host code whichever is named: it builds each
        level's tensors on the device once.
        optimize: swap the level operators for the kernel formats (DIA,
        banded); 'auto' = when the device is CUDA.

        With setup_backend='device' the setup is primed as the reference's
        is: a warning when A's setup signature is new to the shape
        registry (``warmup.novel_shape_report``), the specialized solve
        (static DIA offsets) when its exact shape was seen before, and both
        recorded on first sight. Under a recording profiler the setup is
        the span ``amg.setup`` and the swap of formats ``amg.formats``."""
        with annotate("amg.setup"):
            target = resolve_device(device)
            spec = False
            if self.setup_backend == "device":
                spec = _prime(A)
            if self.setup_backend == "device" or host_setup == "auto":
                host_setup = False
            if optimize == "auto":
                optimize = target.type == "cuda"
            where = torch.device("cpu") if host_setup else target
            self._do_setup(A.to(where), where)
            hier = self.ell_hierarchy = self.hierarchy
            if optimize:
                with annotate("amg.formats"):
                    hier = optimize_hierarchy(
                        hier, prefer_pallas=True,
                        gather_precision=self.gather_precision,
                        specialize=self.specialize or spec, device=where)
                    if self.relax == "kaczmarz":
                        # its sweeps run A.mv_t on every level
                        hier = with_operator_transposes(hier)
            hier = hier.to(target)

            cg_weights = self.relax == "jacobi" and self.relax_weight < 0
            self._weight = 1.0 if cg_weights else self.relax_weight
            if cg_weights:
                # hypre's convention: relax_weight < 0 asks for per-level
                # weights 1/lambda_max from |relax_weight| CG steps
                # (par_cg_relax_wt.c:300); lev.rw carries them to both cycles.
                # The reference overwrites the knob with 1.0 here, so that a
                # second setup builds no weights.
                steps = max(int(-self.relax_weight), 5)
                hier = dataclasses.replace(hier, levels=[
                    dataclasses.replace(
                        lev, rw=1.0 / max_eig_estimate_cg(lev.A, lev.dinv,
                                                          steps)[0])
                    for lev in hier.levels])
            if self.relax == "chebyshev" and self.cheby_eig_est > 0:
                # the CG/Lanczos lambda_max replaces the power estimate
                hier = dataclasses.replace(hier, levels=[
                    dataclasses.replace(
                        lev, lmax=max_eig_estimate_cg(lev.A, lev.dinv,
                                                      self.cheby_eig_est)[0])
                    for lev in hier.levels])
            self.hierarchy = hier
            self._transposed = False
            self._smoother = make_smoother(
                self.relax, self._weight, self.cheby_order,
                self.cheby_ratio, relax_order=self.relax_order)
            if self.smooth_type and self.smooth_num_levels > 0:
                self._smoother = self._complex_smoothers(target)
            return self

    def _complex_smoothers(self, target: torch.device) -> list:
        """The per-level smoother list of smooth_type (the reference's
        ``boomeramg.py:211-241``): the named preconditioner, built on
        ``target`` from each smoothed level's EllMatrix, applied as
        u + w M(f - A u) with the level's own (kernel-format) A; the
        pointwise smoother below."""
        from hypre_tpu_torch.precond.fsai import FSAI
        from hypre_tpu_torch.precond.ilu import ILU
        from hypre_tpu_torch.precond.schwarz import Schwarz

        make = {"fsai": FSAI, "ilu": ILU, "schwarz": Schwarz}.get(
            self.smooth_type)
        if make is None:
            raise ValueError(f"unknown smooth_type: {self.smooth_type!r}")
        w, base = self.smooth_weight, self._smoother

        def smoother(M):
            return lambda lev, u, f: u + w * M(f - lev.A.mv(u))

        return [smoother(make().setup(lev.A, device=target).precond())
                if l < self.smooth_num_levels else base
                for l, lev in enumerate(self.ell_hierarchy.levels)]

    def _do_setup(self, A: EllMatrix, where: torch.device) -> None:
        """Build ``self.hierarchy`` for A on ``where`` (the reference's
        ``boomeramg.py:247-268``). Subclasses with a setup of their own
        (smoothed aggregation, GSMG) override this hook; ``setup`` then
        optimizes, moves, weights and binds a smoother to whatever it
        built."""
        self.setup_path = resolve_setup_backend(
            self.setup_backend, interp=self.interp, coarsen=self.coarsen_type,
            interp_jacobi_passes=self.interp_jacobi_passes,
            restrict_type=self.restrict_type,
            agg_num_levels=self.agg_num_levels,
            nongalerkin_tol=self.nongalerkin_tol)
        self.hierarchy = setup_hierarchy(
            A,
            strength_threshold=self.strength_threshold,
            max_row_sum=self.max_row_sum,
            max_levels=self.max_levels,
            max_coarse_size=self.max_coarse_size,
            p_max_elmts=self.p_max_elmts,
            trunc_factor=self.trunc_factor,
            interp=self.interp,
            relax=self.relax,
            coarsen=self.coarsen_type,
            interp_jacobi_passes=self.interp_jacobi_passes,
            setup_backend=self.setup_path,
            agg_num_levels=self.agg_num_levels,
            restrict_type=self.restrict_type,
            nongalerkin_tol=self.nongalerkin_tol,
            device=where,
        )

    def _hier(self) -> AMGHierarchy:
        if self.hierarchy is None:
            raise RuntimeError("call setup(A) first")
        return self.hierarchy

    def _hier_t(self) -> AMGHierarchy:
        """The hierarchy, with the transpose schedules of its banded level
        operators built at the first transpose cycle and kept."""
        if not self._transposed:
            self.hierarchy = with_operator_transposes(self._hier())
            self._transposed = True
        return self.hierarchy

    # -- solver interfaces ---------------------------------------------------

    def cycle(self, f: torch.Tensor,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
        hier = self._hier()
        if self.additive >= 0:
            return amg_additive_cycle(
                hier, f, u, smoother=self._smoother,
                num_sweeps=self.num_sweeps, add_start=self.additive,
                variant=self.additive_variant)
        return amg_cycle(hier, f, u, smoother=self._smoother,
                         num_sweeps=self.num_sweeps,
                         cycle_type=self.cycle_type)

    def precond(self):
        """One cycle from a zero guess: the ``M`` of pcg/gmres/bicgstab."""
        return lambda r: self.cycle(r)

    def cycleT(self, f: torch.Tensor,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One transpose cycle (hypre_BoomerAMGCycleT), with the forward
        cycle's Jacobi weights. The first call builds the transpose
        schedule of every banded level operator."""
        return amg_cycle_t(self._hier_t(), f, u,
                           relax_weight=self._weight,
                           num_sweeps=self.num_sweeps)

    def _iterate(self, cycle, apply_A, b, x0, rtol, maxiter):
        """Repeat ``cycle`` until ||b - A x|| <= rtol ||b||, reading the
        test back once per cycle. A row-padded hierarchy runs on padded
        vectors, and x comes back at b's size."""
        hier = self._hier()
        b = b.to(hier.device)
        n, n_pad = b.shape[0], hier.levels[0].A.vec_len_rows
        bp = torch.cat([b, b.new_zeros(n_pad - n)])
        x = torch.zeros_like(bp) if x0 is None else torch.cat(
            [x0.to(hier.device), bp.new_zeros(n_pad - n)])
        b_prod = dot(b, b)
        eps = rtol * rtol * b_prod
        r = bp - apply_A(x)
        i_prod = dot(r, r)
        it = 0
        while it < maxiter and bool((i_prod > eps) & torch.isfinite(i_prod)):
            x = cycle(bp, x)
            r = bp - apply_A(x)
            i_prod = dot(r, r)
            it += 1
        safe_b = torch.where(b_prod > 0, b_prod, torch.ones_like(b_prod))
        rel = torch.sqrt(torch.clamp(i_prod, min=0.0) / safe_b)
        return x[:n], make_convergence_info(it, rel,
                                            (i_prod <= eps) | (b_prod == 0))

    def solve(self, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
              rtol: float = 1e-8,
              maxiter: int = 100) -> tuple[torch.Tensor, ConvergenceInfo]:
        """Standalone AMG iteration (hypre_BoomerAMGSolve,
        par_amg_solve.c:22): cycles until the two-norm residual drops below
        rtol * ||b||."""
        hier = self._hier()
        if not hier.levels:
            return (hier.coarse_inv @ b.to(hier.device),
                    make_convergence_info(1, 0.0, True))
        return self._iterate(self.cycle, hier.levels[0].A.mv, b, x0, rtol,
                             maxiter)

    def solveT(self, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
               rtol: float = 1e-8,
               maxiter: int = 100) -> tuple[torch.Tensor, ConvergenceInfo]:
        """Solve A^T x = b with transpose cycles (hypre_BoomerAMGSolveT,
        par_amg_solveT.c:22)."""
        hier = self._hier_t()
        if not hier.levels:
            return (hier.coarse_inv.T @ b.to(hier.device),
                    make_convergence_info(1, 0.0, True))
        return self._iterate(self.cycleT, hier.levels[0].A.mv_t, b, x0, rtol,
                             maxiter)

    # -- diagnostics (par_stats.c analogue) -----------------------------------

    def stats(self) -> str:
        hier = self._hier()
        lines = ["lev        rows     ell_k      nnz   grid-cmplx"]
        n0 = hier.levels[0].A.n_rows if hier.levels else 0
        total_nnz, nnz0 = 0, 1
        for i, lev in enumerate(hier.levels):
            A = getattr(lev.A, "ell", None) or lev.A  # unwrap the kernel formats
            if hasattr(A, "vals_t"):  # BandedEll without its ELL payload
                nnz = int((A.vals_t != 0).sum())
                width = A.vals_t.shape[0]
            elif hasattr(A, "dvals"):
                nnz = int((A.dvals != 0).sum())
                width = A.D
            else:
                nnz = int(A.structural_mask().sum())
                width = A.k
            if i == 0:
                nnz0 = max(nnz, 1)
            total_nnz += nnz
            lines.append(f"{i:3d} {A.n_rows:11d} {width:9d} {nnz:8d} "
                         f"{A.n_rows / max(n0, 1):10.3f}")
        nc = hier.coarse_inv.shape[0]
        lines.append(f"{len(hier.levels):3d} {nc:11d} {'dense':>9s}")
        lines.append(f"operator complexity: {total_nnz / nnz0:.3f}")
        return "\n".join(lines)
