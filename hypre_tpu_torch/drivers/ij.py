"""ij driver — mirrors ``src/test/ij.c`` (flags at ij.c:521-575, solver ids
at ij.c:2022-2046, coarsening flags :2047-2059).

Counterpart of ``hypre_tpu/drivers/ij.py``, with the same flags, solver
ids and output lines (TEST_ij/solvers.saved):

    Iterations = N
    Final Relative Residual Norm = X

``run(argv, device=None, dtype=None)`` runs on ``device`` (CUDA unless the
caller names another) in ``dtype`` (float32 unless the caller names
another; the reference takes its type from JAX's x64 switch);
``prepare`` does the same up to the solve and hands back the set-up
case, for callers that time or repeat the solve. On the card
the outer operator is applied through its kernel format
(``optimize_operator``: the DIA kernel for a stencil problem), and the
preconditioners keep theirs. Every AMG id sets up as the reference's
does, through BoomerAMG's default: the host C++ setup, which also runs
``-agg_nl``. AMG-DD (ids 90/91) sets up its composite grids for four
devices, as the reference's does (``parallel/amgdd.py``).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable

import numpy as np
import torch

SOLVER_HELP = """solver ids (ij.c:2022-2046 subset):
  0 = AMG            1 = AMG-PCG        2 = DS-PCG        3 = AMG-GMRES
  4 = DS-GMRES       5 = AMG-CGNR       6 = DS-CGNR       8 = ParaSails-PCG
  9 = AMG-BiCGSTAB  10 = DS-BiCGSTAB   12 = Schwarz-PCG  16 = AMG-COGMRES
 13 = GSMG          14 = GSMG-PCG    15 = GSMG-GMRES
 18 = ParaSails-GMRES  20 = Hybrid     31 = FSAI-PCG     50 = AMG-LGMRES
 60 = AMG-FlexGMRES   70 = MGR-GMRES   80 = ILU-GMRES
  7 = PILUT-GMRES    43 = Euclid-PCG  46 = Euclid-GMRES  81 = ILUT-GMRES
 90 = AMG-DD        91 = AMG-DD-GMRES"""

# flag -> (key, value) for the flags that take no argument
_SWITCHES = {
    "-laplacian": ("problem", "laplacian"), "-9pt": ("problem", "9pt"),
    "-27pt": ("problem", "27pt"), "-difconv": ("problem", "difconv"),
    "-vardifconv": ("problem", "vardifconv"), "-rotate": ("problem", "rotate"),
    "-pmis": ("coarsen", "pmis"), "-pmis1": ("coarsen", "pmis"),
    "-cljp": ("coarsen", "cljp"), "-ruge": ("coarsen", "ruge"),
    "-falgout": ("coarsen", "falgout"), "-hmis": ("coarsen", "hmis"),
    "-rhsrand": ("rhs", "rand"),
}
# flag -> (key, parse) for the flags that take one argument
_VALUED = {
    "-solver": ("solver", int), "-CF": ("relax_order", int),
    "-tol": ("tol", float),
    # ij.c:1634 -recompute <0|1> -> HYPRE_PCGSetRecomputeResidual; on here
    # by default, as in the reference (krylov/pcg.py)
    "-recompute": ("recompute_res", int),
    "-recompute_p": ("recompute_res_p", int),
    "-max_iter": ("max_iter", int), "-th": ("theta", float),
    "-mxrs": ("max_row_sum", float), "-smlv": ("smooth_num_levels", int),
    "-sw": ("smooth_weight", float), "-agg_nl": ("agg_nl", int),
    "-Pmx": ("pmx", int), "-ns": ("ns", int), "-k": ("k_dim", int),
    # ij.c's ioutdat: 1 = setup stats, >= 2 adds the per-iteration
    # residual table (SetPrintLevel / SetLogging)
    "-poutdat": ("poutdat", int), "-eps": ("eps", float),
    # ij.c -w: the Jacobi weight; negative = CG-determined
    # (hypre_BoomerAMGCGRelaxWt)
    "-w": ("rlx_wt", float), "-cheby_eig_est": ("cheby_eig_est", int),
    "-interptype": ("interp", lambda v: {
        0: "classical", 3: "direct", 6: "ext+i", 14: "ext+i"}[int(v)]),
    "-rlx": ("relax", lambda v: {
        0: "jacobi", 7: "jacobi", 18: "l1-jacobi", 16: "chebyshev",
        11: "two-stage-gs", 12: "sym-two-stage-gs", 20: "kaczmarz"}[int(v)]),
    # hypre ij.c's smooth_type numbering: 4 = FSAI class, 5 = ILU,
    # 6 = Schwarz
    "-smtype": ("smooth_type", lambda v: {
        4: "fsai", 5: "ilu", 6: "schwarz"}[int(v)]),
}
# HYPRE_BoomerAMGSetAdditive / SetMultAdditive / SetSimple (ij.c
# -additive / -mult_add / -simple <level>)
_ADDITIVE = {"-additive": "additive", "-mult_add": "mult",
             "-simple": "simple"}


def parse_args(argv):
    a = dict(
        solver=1, nx=40, ny=40, nz=1, problem="laplacian", tol=1e-8,
        max_iter=1000, coarsen="pmis", interp="ext+i", relax="chebyshev",
        theta=0.25, agg_nl=0, pmx=4, ns=1, k_dim=30, rhs="ones",
        fromfile=None, eps=1.0, two_norm=True, poutdat=0,
        additive=-1, add_variant="additive", rlx_wt=1.0, cheby_eig_est=0,
        relax_order=0, max_row_sum=0.9, smooth_type="",
        smooth_num_levels=0, smooth_weight=1.0, recompute_res=1,
        recompute_res_p=0,
    )
    i = 0
    while i < len(argv):
        f = argv[i]
        if f in _SWITCHES:
            key, val = _SWITCHES[f]
            a[key] = val
        elif f in _VALUED:
            key, parse = _VALUED[f]
            i += 1
            a[key] = parse(argv[i])
        elif f in _ADDITIVE:
            i += 1
            a["additive"], a["add_variant"] = int(argv[i]), _ADDITIVE[f]
        elif f == "-n":
            a["nx"], a["ny"], a["nz"] = (int(v) for v in argv[i + 1:i + 4])
            i += 3
        elif f == "-fromfile":
            i += 1
            a["problem"], a["fromfile"] = "fromfile", argv[i]
        elif f == "-help":
            print(SOLVER_HELP)
            raise SystemExit(0)
        else:
            raise SystemExit(f"unknown flag {f} (see -help)")
        i += 1
    return a


def build_problem(a, dtype, device):
    from hypre_tpu_torch.io import read_any_matrix
    from hypre_tpu_torch.problems import laplacian as P
    from hypre_tpu_torch.seq.ell import csr_to_ell

    nx, ny, nz = a["nx"], a["ny"], a["nz"]
    kw = dict(dtype=dtype, device=device)
    if a["problem"] == "fromfile":
        return csr_to_ell(read_any_matrix(a["fromfile"]), **kw)
    if a["problem"] == "9pt":
        return P.laplacian_2d_9pt(nx, ny, **kw)
    if a["problem"] == "27pt":
        return P.laplacian_3d_27pt(nx, ny, max(nz, 2), **kw)
    if a["problem"] == "difconv":
        return P.difconv_3d_7pt(nx, ny, max(nz, 2), eps=a["eps"], **kw)
    if a["problem"] == "vardifconv":
        return P.vardifconv_3d(nx, ny, max(nz, 2), eps=a["eps"], **kw)
    if a["problem"] == "rotate":
        return P.rotated_anisotropy_2d(nx, ny, eps=a["eps"], **kw)
    if nz <= 1:
        return P.laplacian_2d_5pt(nx, ny, **kw)
    return P.laplacian_3d_7pt(nx, ny, nz, **kw)


@dataclasses.dataclass
class Case:
    """One driver run, set up: the problem A (EllMatrix), the operator the
    solve applies (A, or its kernel format on the card), the right-hand
    side b, the solver objects built (``amgs``: the BoomerAMGs, for
    -poutdat) and ``solve``, which runs the solve and returns (x, info)."""

    args: dict
    A: object
    op: object
    b: torch.Tensor
    solve: Callable
    amgs: list


def prepare(argv, device=None, dtype=None) -> Case:
    """Parse ``argv``, build the problem and set up the solver on
    ``device`` (CUDA unless the caller names another) in ``dtype``
    (float32 unless the caller names another); the solve waits for
    ``Case.solve()``."""
    from hypre_tpu_torch.amg.boomeramg import BoomerAMG
    from hypre_tpu_torch.amg.gsmg import GSMG
    from hypre_tpu_torch.amg.hybrid import HybridSolver
    from hypre_tpu_torch.amg.mgr import MGR
    from hypre_tpu_torch.core.config import resolve_device
    from hypre_tpu_torch.krylov import (
        bicgstab, cgnr, cogmres, flexgmres, gmres, lgmres, pcg,
    )
    from hypre_tpu_torch.precond import (
        FSAI, ILU, ILUT, PILUT, Euclid, ParaSails, Schwarz,
    )
    from hypre_tpu_torch.seq.fastmv import optimize_operator

    a = parse_args(argv)
    s = a["solver"]
    device = resolve_device(device)
    dtype = dtype or torch.float32
    A = build_problem(a, dtype, device)
    n = A.n_rows
    if a["rhs"] == "rand":
        b = torch.from_numpy(np.random.default_rng(0).random(n)).to(
            device, dtype)
    else:
        b = torch.ones(n, dtype=dtype, device=device)
    # the card applies A in its kernel format (DIA for a stencil operator)
    Aop = optimize_operator(A) if device.type == "cuda" else A
    op = Aop.mv
    dinv = 1.0 / A.diagonal()
    amgs = []

    def amg():
        solver = BoomerAMG(
            coarsen_type=a["coarsen"], interp=a["interp"], relax=a["relax"],
            strength_threshold=a["theta"], agg_num_levels=a["agg_nl"],
            max_row_sum=a["max_row_sum"], smooth_type=a["smooth_type"],
            smooth_num_levels=a["smooth_num_levels"],
            smooth_weight=a["smooth_weight"],
            p_max_elmts=a["pmx"], num_sweeps=a["ns"],
            additive=a["additive"], additive_variant=a["add_variant"],
            relax_weight=a["rlx_wt"], cheby_eig_est=a["cheby_eig_est"],
            relax_order=a["relax_order"],
        ).setup(A, device=device)
        amgs.append(solver)
        return solver

    def ds(r):
        return dinv * r

    kw = dict(rtol=a["tol"], maxiter=a["max_iter"], device=device)
    if a["poutdat"] >= 2:
        kw["logging"] = 1
    gm = dict(kw, k_dim=a["k_dim"])
    pcg_kw = dict(kw, recompute_residual=bool(a["recompute_res"]),
                  recompute_residual_p=a["recompute_res_p"])

    def krylov(solver, M, **kws):
        return lambda: solver(op, b, M=M, **kws)

    if s in (0, 13, 20):
        # the standalone solvers: BoomerAMG, GSMG, Hybrid
        if s == 20:
            obj = HybridSolver().setup(A, device=device)
            kws = {}
        else:
            obj = amg() if s == 0 else GSMG(
                strength_threshold=a["theta"], p_max_elmts=a["pmx"]).setup(
                A, device=device)
            kws = dict(maxiter=a["max_iter"])

        def solve():
            return obj.solve(b, rtol=a["tol"], **kws)
    elif s in (5, 6):
        M = amg().precond() if s == 5 else None

        def solve():
            return cgnr(op, A.mv_t, b, M=M, **kw)
    elif s in (14, 15):
        gs = GSMG(strength_threshold=a["theta"], p_max_elmts=a["pmx"]).setup(
            A, device=device)
        solve = krylov(pcg, gs.precond(), **pcg_kw) if s == 14 else \
            krylov(gmres, gs.precond(), **gm)
    elif s == 1:
        solve = krylov(pcg, amg().precond(), **pcg_kw)
    elif s == 2:
        solve = krylov(pcg, ds, **pcg_kw)
    elif s == 3:
        solve = krylov(gmres, amg().precond(), **gm)
    elif s == 4:
        solve = krylov(gmres, ds, **gm)
    elif s == 8:
        solve = krylov(pcg, ParaSails().setup(A, device=device).precond(),
                       **pcg_kw)
    elif s == 9:
        solve = krylov(bicgstab, amg().precond(), **kw)
    elif s == 10:
        solve = krylov(bicgstab, ds, **kw)
    elif s == 12:
        solve = krylov(pcg, Schwarz().setup(A, device=device).precond(),
                       **pcg_kw)
    elif s == 16:
        solve = krylov(cogmres, amg().precond(), **gm)
    elif s == 18:
        solve = krylov(gmres, ParaSails().setup(A, device=device).precond(),
                       **gm)
    elif s == 31:
        solve = krylov(pcg, FSAI().setup(A, device=device).precond(),
                       **pcg_kw)
    elif s == 50:
        solve = krylov(lgmres, amg().precond(), **gm)
    elif s == 60:
        solve = krylov(flexgmres, amg().precond(), **gm)
    elif s == 70:
        cpts = np.arange(n)[(np.arange(n) % 2) == 0]
        solve = krylov(gmres, MGR().setup(A, [cpts], device=device)
                       .precond(), **kw)
    elif s == 80:
        solve = krylov(gmres, ILU().setup(A, device=device).precond(), **kw)
    elif s == 7:
        solve = krylov(gmres, PILUT().setup(A, device=device).precond(), **gm)
    elif s in (43, 46):
        M = Euclid(level=1).setup(A, device=device).precond()
        solve = krylov(pcg, M, **pcg_kw) if s == 43 else \
            krylov(gmres, M, **gm)
    elif s == 81:
        solve = krylov(gmres, ILUT().setup(A, device=device).precond(), **gm)
    elif s in (90, 91):
        from hypre_tpu_torch.parallel.amgdd import AMGDD

        dd = AMGDD(padding=2).setup(A, num_devices=4, device=device)
        solve = (lambda: dd.solve(b, rtol=a["tol"], maxiter=a["max_iter"])) \
            if s == 90 else krylov(gmres, dd.precond(), **gm)
    else:
        raise SystemExit(f"unsupported solver id {s}\n{SOLVER_HELP}")
    return Case(args=a, A=A, op=Aop, b=b, solve=solve, amgs=amgs)


def run(argv, device=None, dtype=None) -> tuple[int, float]:
    """``prepare`` and solve, then print the two lines (and under -poutdat
    the setup report and the residual table); returns (iterations, final
    relative residual norm)."""
    from hypre_tpu_torch.core.error import record_convergence

    case = prepare(argv, device=device, dtype=dtype)
    a = case.args
    _, info = case.solve()
    record_convergence(info)  # HYPRE_ERROR_CONV semantics (pcg.c)
    iters = int(info.iterations)
    rel = float(info.relative_residual)
    if a["poutdat"] >= 1 and case.amgs:
        from hypre_tpu_torch.stats import amg_setup_report

        print(amg_setup_report(
            case.amgs[0].ell_hierarchy, strength_threshold=a["theta"],
            coarsen=a["coarsen"], interp=a["interp"]))
    if a["poutdat"] >= 2 and info.res_history is not None:
        from hypre_tpu_torch.stats import format_iteration_log

        print(format_iteration_log(info, float(torch.linalg.norm(case.b)),
                                   two_norm=a["two_norm"]))
    print(f"Iterations = {iters}")
    print(f"Final Relative Residual Norm = {rel:e}")
    return iters, rel


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
