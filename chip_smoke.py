#!/usr/bin/env python3
"""Smoke run of hypre_tpu_torch on one CUDA card: build, check, solve.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. Device: the card's name and power limit; build every CUDA kernel from
   ``hypre_tpu_torch/csrc`` and print nvcc's ``-Xptxas -v`` report.
2. Main path at 128^3, float32: ``laplacian_3d_7pt`` -> ``setup_hierarchy``
   (pure setup: PMIS, ext+i, p_max_elmts=4, Chebyshev, max_coarse_size=1500)
   -> ``optimize_hierarchy`` -> ``pcg`` with the AMG V-cycle preconditioner
   at rtol 1e-6, once with the dynamic DIA kernel (``specialize=False``) and
   once with the static one (``specialize=True``). Kernel launch counts are
   set to 0 just before each path and read just after; every kernel of a
   path must have launched, the solve must converge within ITERATION_LIMIT
   iterations, the two paths must take the same number of iterations, and
   the true relative residual must stay under TRUE_RESIDUAL_LIMIT (the
   float32 floor, below).
3. The device-setup path at 128^3, float32: ``setup_hierarchy_device``
   with the reference bench's arguments (aggressive PMIS on the first
   level, multipass interpolation, slab RAP with a 0.02 drop tolerance,
   Chebyshev, max_coarse_size=1500), once with ``transfer_dia=True`` (the
   stencil level's interpolation stored as fine-space diagonals, D = 64)
   and once with ``transfer_dia=False`` (the same P as a banded operator
   with a transpose schedule); each optimized and solved with the dynamic
   and with the static DIA kernel. All four solves must converge within
   BENCH_ITERATION_LIMIT iterations and take the same number of them. Per
   PCG iteration the dense DIA kernel runs 6 times (the level-0 A) and,
   with TransferDia, the row-list DIA kernel twice (the D = 64 transfer
   planes, compacted by ``optimize_hierarchy``; the static path takes the
   same row-list kernel).
4. Kernels against their plain PyTorch versions on the card, at both
   paths' shapes, with times (CUDA events), bounds and the time of one
   PyTorch call that computes the same function (``library_ms``: a CSR
   matrix product). The transpose kernel must also give the same bits in
   two runs; its schedule's size and build time are printed. The row-list
   DIA kernel runs on the TransferDia's two members and must give the bits
   of the dense kernels' plain version, the same in two runs and with the
   static offsets; it is timed against the bound of its layout's bytes and
   against that of the function's bytes alone (``nnz_bound_ms``), with 1
   and with 4 lanes a row beside it; a sweep over the listed rows' length
   times both lane counts. The whole level-0 transfer is timed by every route
   (TransferDia on the row list and on the dense planes, banded, CSR).
5. Card against CPU: the pure-setup path at 24^3 in float64 and at 48^3 in
   float32 (where the banded kernels run), and the device setup with
   ``agg_num_levels=1`` at the same two sizes, on the card and on the CPU
   (plain versions) must give the same level sizes, C-point counts,
   operator formats and PCG iteration count. Two device setups on the
   card at 48^3 must agree in every tensor, bit for bit.
6. The BoomerAMG facade at 128^3, float32, b = ones: ``BoomerAMG(
   max_coarse_size=1500).setup(A)`` on the card (the host C++ setup that
   "auto" takes, then the kernel formats), its setup seconds, levels and ``stats()``; then
   ``amg.precond()`` under pcg, gmres, flexgmres, cogmres and lgmres
   (k_dim=30) and bicgstab, and ``amg.solve``, at rtol 1e-6, maxiter 100;
   and ``BoomerAMG(setup_backend="device", agg_num_levels=1)`` under
   gmres. Each solve must converge with a true relative residual (in
   float64) under TRUE_RESIDUAL_LIMIT, and kernels 1, 3 and 4 must launch
   during it; its iterations, warm milliseconds and launches per
   iteration are printed.
7. Facade options, card against CPU, at N_OPTIONS^3 float32 (the CPU run
   optimizes too, so both run the same formats, the CPU by their plain
   versions): every coarsening, interpolation, smoother, cycle and
   restriction option the facade has, solveT, DS-CGNR (float64) and
   LOBPCG with the facade as T. Each must give the same levels, C-point
   counts, formats and iterations on both, with a banded operator in
   every hierarchy; LOBPCG's eigenvalues must agree to 1e-4.
8. The reference's other 3-D problems at 128^3 through the facade: the
   27-pt Laplacian under PCG with the dynamic and the static DIA kernel
   (D = 27, same iterations), difconv under GMRES(30), vardifconv under
   PCG (phase 4 also holds both DIA kernels at D = 27 against plain).
9. hypre's IJ path at 128^3: IJMatrix assembly (the CSR of
   ``laplacian_3d_7pt`` bit for bit), BoomerAMG-PCG, ``refine_solve`` and
   the two-float device refiner to a true residual of 1e-6 (the refiner
   below the plain one), the device kernels of one two-float residual;
   ``fem_stiffness_2d(1024)`` through IJ; MatrixMarket, IJ-ASCII and
   ``.npz`` round trips at 32^3, exact.
10. HybridSolver at 128^3 (DS-PCG, then the facade), MGR and BlockTridiag
    under FlexGMRES(30) at n = 2 097 152.
11. The new paths card against CPU at small sizes: every new generator,
    the 32^3 IJ path with refinement, Hybrid, MGR and BlockTridiag.
    Each solve of phases 8-10 must converge with a float64 true residual
    under TRUE_RESIDUAL_LIMIT and launch its kernels; its iterations,
    warm milliseconds and launches are printed, and each phase's
    seconds.
12. The rest of amg/ at full width (~2.1 M unknowns), f32, rtol 1e-6:
    ``SmoothedAggAMG`` and ``GSMG`` (max_coarse_size=1500) under PCG on
    the 7-pt 128^3; ``SmoothedAggAMG`` with the three rigid-body modes as
    its null space and nodal ``BlockAMG`` (``ell_to_bsr``) under PCG on
    ``elasticity_2d(1024, 1024)``; ``BlockAMG`` on ``fem_block_2d(1024)``
    under FlexGMRES(30); ``AMS`` on the curl-curl + mass operator and
    ``ADS`` on the div-div + mass operator (lognormal coefficients) of the
    88^3 and N_ADS^3 (cut, see ADS_CUT) hex complexes under PCG (BlockAMG
    on elasticity and ADS in float64, see ``aux_runs``); ``AME`` (block 4)
    on the curl-curl operator at N_AME^3 (cut, see AME_CUT). Each prints its setup seconds, levels,
    formats, iterations, warm ms, true residual and launches; each solve
    must converge under TRUE_RESIDUAL_LIMIT and, wherever a facade built
    kernel formats (float32), launch a ported kernel; AME's eigenvalues
    must lie above the gradient cluster, converge and belong to
    divergence-free vectors. Then the same paths at small sizes on the
    card and on the CPU: equal levels, formats and iterations, and AME's
    eigenvalues against a dense oracle.
13. hypre's preconditioners at full width, f32 at rtol 1e-6 through the
    port's ij driver (``drivers.ij.prepare``) on the 7-pt 128^3: FSAI-,
    ParaSails-, Schwarz- and Euclid-PCG, ILU-, ILUT- and PILUT-GMRES, and
    AMG-PCG with FSAI, ILU and Schwarz level smoothing (-smtype 4/5/6
    -smlv 2); by the API IC and PolyPrecond(order=4) under PCG,
    ILUSchurGMRES (f64) under FlexGMRES(30) at 128^3, ILUSchurNSH at
    NSH_N^2 (cut, NSH_CUT), MGR with the global ILU pass on phase 10's
    block system, BlockPrecond and Uzawa on the Stokes-like saddle system
    at SADDLE_N^2 x 2. Each prints its setup seconds, iterations, warm ms,
    f64 true residual, launches of the ported kernels and the card's
    kernels of all ops (profiler), and must converge under
    TRUE_RESIDUAL_LIMIT and launch a ported kernel. Then every class, each
    -smtype and the driver's ids at small sizes on the card and on the
    CPU: equal iterations, factors to PRECOND_FACTOR_RTOL.
14. hypre's struct layer at full width, f32 at rtol 1e-6, through the
    port's struct driver (``prepare``, then ``solve``): PFMG-PCG
    and SMG-PCG on the 2-D 5-pt STRUCT_N2D^2 and the 3-D 7-pt
    STRUCT_N3D^3, PFMG, SparseMSG-PCG and StructHybrid at STRUCT_N2D^2
    (the 2-D paths for a manufactured x*; 3-D SMG-PCG solved once and
    not profiled, STRUCT_ONCE_CUT). Each prints its setup seconds,
    levels (shape, cdir, stencil size, DIA planes), iterations, warm ms,
    f64 true residual, DIA launches per iteration and the card's kernels
    of all ops per iteration, must converge under TRUE_RESIDUAL_LIMIT and
    launch kernel 1 or 2; every DIA view of each path is held against the
    plain version. Kernels 1 and 2 are timed on the 2-D and 3-D level-0
    operators and PFMG's probed level 1. Then every struct driver id at
    its STRUCT_SMALL flags on the card and on the CPU: in float64 equal
    iterations, the goldens' where there is one; in float32 and float64
    equal cdir sequences and stencil offsets, coefficients to
    STRUCT_COEFF_RTOL in float32.
15. hypre's semi-structured layer at full width, f32 at rtol 1e-6, each
    path for a manufactured x*: through the port's sstruct driver
    (``prepare``, then ``solve``) PCG + Split(PFMG) and PCG + Split(SMG)
    on two SSTRUCT_N^2 parts glued along an edge, Split standalone at
    SPLIT_N^2 (cut, SPLIT_CUT), SysPFMG standalone at -eps SYS_EPS (and
    under PCG), FAC standalone (and under PCG) on the composite grid of
    SSTRUCT_N^2 coarse cells with a 2x patch, SStruct Maxwell (AMS-PCG)
    on the curl-curl + 0.05 I system of SSTRUCT_N^2 cells; by the API
    SysPFMG with jacobi, node-jacobi and node-rbgs on the strong-coupling
    system, FEM assembly (FEM_CUT) and the FEI sequence (FEI_CUT) under
    PCG-BoomerAMG. Each prints its setup seconds (assembly apart),
    iterations, warm ms, f64 true residual and x* error, formats,
    launches per iteration and the card's kernels of all ops per
    iteration, must converge under TRUE_RESIDUAL_LIMIT and launch one of
    kernels 1-4; every DIA view is held against the plain version. The
    kernels are timed on the system DIA views, U's view and FAC's and
    Maxwell's banded levels. Then every SSTRUCT_GOLDEN flag set through
    the driver on the card and on the CPU: in float64 the goldens'
    iterations, in float32 (SSTRUCT_F32_TOL) and float64 equal
    iterations, SysPFMG cdirs, offsets and coefficients, FAC's Galerkin
    operators; the nested-patch FAC and the two-part FEM problem at test
    size alike. U's coupling view runs the row-list kernel.
16. The host C++ setup (``native.py``), which setup_backend "auto" takes:
    the default ``BoomerAMG(max_coarse_size=1500)`` at 128^3 float32 and
    the same with ``nongalerkin_tol``, under PCG at rtol 1e-6, and the ij
    driver's ``-solver 1 -agg_nl 1`` at 128^3; each must print the
    ``native`` setup path, converge under TRUE_RESIDUAL_LIMIT and launch
    kernels 1, 3 and 4, and prints its setup seconds, levels, iterations
    and warm ms. Then the default, ``agg_num_levels=1`` and
    ``nongalerkin_tol`` facades at 24^3 on the card and on the CPU, in
    float64 and float32: equal setup paths, levels, C-point counts,
    formats and iterations. Every phase prints the setup paths its
    BoomerAMG setups took (``setup_paths``).
17. hypre's ParCSR layer (``parallel/``) with every shard on the card
    (the local backend), 7-pt PAR_N^3: A partitioned into 2, 4 and 8
    shards, ``par_spmv`` and ``par_spmv_t`` against ``A.mv``/``mv_t`` in
    float32, the halo's ``exchange_bytes`` (8 shards: 8 * 2 * PAR_N^2 * 4),
    device ms per product and per exchange beside kernel 2's on A; then
    ``setup_hierarchy_par`` on 8 shards (seconds and RAP widths per
    level) with the level sizes of ``setup_hierarchy_device`` on the same
    A with each row in column order (the order the distributed setup sums
    in), and PCG + ``amg_cycle`` (l1-Jacobi) on both to rtol
    PAR_RTOL with equal iterations, a float64 true residual under
    TRUE_RESIDUAL_LIMIT, warm ms, device kernels per iteration and the
    device busy share; the default facade's hierarchy partitioned
    (``partition_hierarchy``) under PCG with the facade's own iterations;
    ``drivers.ij_mm`` jobs 1, 2, 4 and 5 at PAR_N^3 and ``-verify 1`` at
    IJ_MM_VERIFY_N^3; and at N_PARITY^3 on 8 shards card against CPU: the
    CF split, level sizes and iterations. The distributed products launch
    none of the four kernels (checked: their counts stay 0 in the
    distributed solves).
18. One ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

It needs one CUDA card; it imports nothing of JAX or of ``hypre_tpu``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # H100 SXM, no tensor cores
N_MAIN = 128
N_PARITY = 24
# The true residual of a float32 solution cannot fall below the rounding of
# x itself: with b = ones, x grows as n^2 (max ~930 at 128^3) and A times
# x's rounding error is ~1.2e-5 * (n/32)^2 of ||b|| (port on the CPU, n =
# 32/48/64: 1.24e-5, 2.79e-5, 4.98e-5, the same at rtol 1e-6 and 1e-7),
# about 2e-4 at 128^3. The limit keeps a 5x margin over that floor; the
# float64 run of phase 4 holds the solver to rtol 1e-8.
TRUE_RESIDUAL_LIMIT = 1e-3
# Both 128^3 solves take 9 iterations on the H100; a kernel that is wrong
# but not broken inside the V-cycle weakens the preconditioner, which shows
# as more iterations or as the two paths disagreeing.
ITERATION_LIMIT = 12
# f32 card-vs-CPU size: level-0 P holds ~440k elements there, above
# fastmv.MIN_BANDED_ELEMENTS, so the solve runs kernels 3 and 4.
N_PARITY_BANDED = 48
SETUP_KW = dict(setup_backend="jax", coarsen="pmis", interp="ext+i",
                p_max_elmts=4, relax="chebyshev", agg_num_levels=0,
                max_coarse_size=1500)
# The reference bench's own hierarchy (bench.py): setup_hierarchy_device
# with these arguments, transfer_dia True or False, width_plan a fresh dict.
BENCH_KW = dict(max_coarse_size=1500, relax="chebyshev", agg_num_levels=1,
                coarse_drop_tol=0.02)
# All four 128^3 solves of that hierarchy take 14 iterations on the H100.
BENCH_ITERATION_LIMIT = 17
# The facade phase: solver name -> extra arguments, each run with
# M = amg.precond() at FACADE_RTOL on the 128^3 problem. FlexGMRES and
# the standalone AMG iteration test the unpreconditioned residual
# b - A x, computed in float32, which cannot fall below the float32 floor
# above (~2.4e-4 at 128^3; port on the CPU at 48^3: both stall at 1.6e-5
# against a floor of 2.8e-5 and hit maxiter at rtol 1e-6): they run at
# rtol TRUE_RESIDUAL_LIMIT. The others test a recurrence or a
# preconditioned residual and run at 1e-6.
FACADE_RTOL = 1e-6
GMRES_KW = dict(k_dim=30)
FACADE_SOLVERS = {"pcg": {}, "gmres": GMRES_KW,
                  "flexgmres": dict(GMRES_KW, rtol=TRUE_RESIDUAL_LIMIT),
                  "cogmres": GMRES_KW, "lgmres": GMRES_KW, "bicgstab": {}}
# The options phase's grid: the smallest of 32^3-48^3 at which every
# option's hierarchy holds a banded operator (checked, phase 7).
N_OPTIONS = 32
# (label, BoomerAMG knobs, solve): solve names a Krylov driver run with
# the facade as M, or "solveT".
OPTION_CASES = [
    ("cljp", dict(coarsen_type="cljp", interp="direct"), "pcg"),
    ("ruge", dict(coarsen_type="ruge"), "pcg"),
    ("falgout", dict(coarsen_type="falgout"), "pcg"),
    ("hmis", dict(coarsen_type="hmis"), "pcg"),
    ("cgc", dict(coarsen_type="cgc"), "pcg"),
    ("direct", dict(coarsen_type="ruge", interp="direct"), "pcg"),
    ("classical", dict(coarsen_type="ruge", interp="classical"), "pcg"),
    ("multipass", dict(interp="multipass"), "pcg"),
    ("jacobi-interp", dict(interp="direct", coarsen_type="ruge",
                           interp_jacobi_passes=1, p_max_elmts=8), "pcg"),
    ("two-stage-gs", dict(relax="two-stage-gs", num_sweeps=2), "gmres"),
    ("kaczmarz", dict(relax="kaczmarz", relax_weight=0.5, num_sweeps=2),
     "gmres"),
    ("sym-two-stage-gs", dict(relax="sym-two-stage-gs"), "pcg"),
    ("l1-jacobi-cf", dict(relax="l1-jacobi", relax_order=1), "pcg"),
    ("jacobi-cg-weight", dict(relax="jacobi", relax_weight=-10.0), "pcg"),
    ("cheby-eig-est", dict(cheby_eig_est=10), "pcg"),
    ("w-cycle", dict(cycle_type=2), "pcg"),
    ("f-cycle", dict(cycle_type=3), "pcg"),
    ("additive", dict(additive=0, relax="l1-jacobi"), "pcg"),
    ("mult-additive", dict(additive=0, additive_variant="mult",
                           relax="l1-jacobi"), "pcg"),
    ("simple-additive", dict(additive=0, additive_variant="simple",
                             relax="l1-jacobi"), "pcg"),
    ("air", dict(restrict_type="air", interp="direct", relax="l1-jacobi"),
     "gmres"),
    ("solveT", dict(relax="jacobi", relax_weight=0.8), "solveT"),
]
OPTIONS_MAX_COARSE = 200
# Phases 8-11: the 2-D problems' full grid (elasticity_2d, MGR's blocks,
# fem_stiffness_2d: n = 2 097 152, 2 097 152 and ~1.05 M), and the sizes at
# which the new paths run card against CPU
N_2D = 1024
N_SMALL = 32
N_SMALL_2D = 64
LOBPCG_PAIRS = 4
# Phase 12: the slice's solvers at full width (the hex complex at N_HEX:
# 2 091 144 edges, 2 067 648 faces; AME at N_AME), and the sizes at which
# the same paths run card against CPU. The paths must launch one of
# AUX_KERNELS wherever a facade optimized a hierarchy.
N_HEX = 88
# AME's size, halved from N_HEX while the path alone took more than 120 s
# on an NVIDIA H100 80GB HBM3 at 700 W: at 88^3 its setup had not ended
# after ~1500 s, at 44^3 it took 172 s (setup 159.5, solve 12.6). The AMS
# is built on the penalized A + sigma G G^T, whose nodal Pi operators
# coarsen slowly while their rows widen (k = 25 to 1765 at 44^3).
N_AME = 22
AME_CUT = ("AME at 22^3: the path took >1500 s at 88^3 (setup unfinished) "
           "and 172 s at 44^3 on the H100, over its 120 s")
AME_BLOCK = 4
# AME's residual test, absolute where |lambda| < 1. The f32 operator's
# float64 outer loop floors near 1e-5: the f32 nodal cycle leaves the
# projection's CG a gradient part of ~1e-7, which the penalty sigma G G^T
# magnifies (the reference as well; port on the CPU at 6^3, tol 1e-6:
# residual norms 5e-6-1e-5 after 200 iterations).
AME_TOL = 1e-4
AME_EIG_RTOL = 1e-4
AUX_RTOL = FACADE_RTOL
# ADS in f64 takes 308 PCG iterations at 88^3 on an NVIDIA H100 80GB HBM3
# at 700 W: the sigma = 2 lognormal coefficients span ~1e9 there
AUX_MAXITER = 1000
# ADS's size, cut from N_HEX to keep the whole run near 900 s once phase
# 13 came in: at 88^3 the path took 130.5-154.5 s on an NVIDIA H100 80GB
# HBM3 at 700 W (setup 75 s, 308 iterations in 53-56 s), and the run 920 s
N_ADS = 64
ADS_CUT = ("ADS at 64^3: at 88^3 the path took 130-155 s on the H100 and "
           "the run with phase 13 920 s, over ~900")
AUX_SMALL = dict(n3d=20, n2d=48, fem_m=24, nhex=6, ads_hex=6, ame_hex=6)
AUX_KERNELS = ("dia_spmv", "banded_spmv", "banded_spmv_t")
# Phase 13: the ij driver's preconditioner ids and -smtype at N_MAIN^3,
# rtol PRECOND_RTOL: (label, flags, dtype). In float32 with b = ones the
# true residual floors near 2e-4 at 128^3 (TRUE_RESIDUAL_LIMIT above), so
# PCG runs with -recompute 0 (its recurrence residual; the driver's
# default recomputes b - A x, hypre's RecomputeResidual) and the
# left-preconditioned GMRES ids, which recompute M (b - A x) at every
# restart, run in float64 (ROADMAP.md Queue 3).
PRECOND_RTOL = FACADE_RTOL
PRECOND_MAXITER = 1000
PRECOND_IDS = [
    ("FSAI-PCG", "-solver 31 -recompute 0", "float32"),
    ("ParaSails-PCG", "-solver 8 -recompute 0", "float32"),
    ("Schwarz-PCG", "-solver 12 -recompute 0", "float32"),
    ("Euclid-PCG, ILU(1)", "-solver 43 -recompute 0", "float32"),
    ("ILU-GMRES", "-solver 80", "float64"),
    ("ILUT-GMRES", "-solver 81", "float64"),
    ("PILUT-GMRES", "-solver 7", "float64"),
    ("AMG-PCG, FSAI smoothing",
     "-solver 1 -rlx 18 -smtype 4 -smlv 2 -recompute 0", "float32"),
    ("AMG-PCG, ILU smoothing",
     "-solver 1 -rlx 18 -smtype 5 -smlv 2 -recompute 0", "float32"),
    ("AMG-PCG, Schwarz smoothing",
     "-solver 1 -rlx 18 -smtype 6 -smlv 2 -recompute 0", "float32"),
]
SCHUR_NPARTS = 4
# ILUSchurGMRES's size: at 128^3 (f64) it took 217 FlexGMRES iterations
# and 11.5 s a warm solve, 112 s for the part (an inner GMRES of up to 5
# steps, with its host reads, in every application), over its share of
# the phase
SCHUR_N = 64
SCHUR_CUT = ("ILUSchurGMRES at 64^3: at 128^3 the part took 112 s on the "
             "H100 (11.5 s a warm solve)")
# ILU-NSH's size: its interface basis is dense (n, m), m = 6 N for 4 row
# blocks of an N^2 grid: 1 M x 6144 (25 GB in f32) at 1024^2, 65 536 x
# 1536 at 256^2
NSH_N = 256
NSH_CUT = ("ILUSchurNSH at 256^2: its dense (n, m) interface basis is "
           "25 GB per copy at 1024^2")
SADDLE_N = 1024
# Uzawa (omega 0.5) converges while its A11 BoomerAMG is a direct solve:
# with the reference test's 2 V-cycles per A11 solve it stalls at 3e-2
# from 40^2 (A11 above max_coarse_size 1500; port on the CPU, f64, 38^2:
# 115 iterations). With 12 V-cycles it converges at 128^2 (169, f32)
# but not at 64^2 within 600 iterations.
UZAWA_N = 128
UZAWA_CYCLES = 12
UZAWA_CUT = ("Uzawa at 128^2 x 2 with 12 A11 V-cycles: with the reference "
             "test's 2 it converges only while A11 is a direct solve "
             "(<= 38^2)")
# the card-vs-CPU grid of phase 13 (7-pt, and N_SMALL_2D for the 2-D ones)
PRECOND_SMALL = 16
PRECOND_FACTOR_RTOL = 1e-5
# the classes' solves there, in float32 away from its floor (~3e-6 at 16^3)
PRECOND_SMALL_RTOL = 1e-4
# 20^2: at 32^2 the CPU's residual crosses rtol 0.5 % under it (step 81:
# 9.95e-5), where the card's crossed a step later; at 20^2 7 % under
UZAWA_SMALL = 20
# The struct phase (14): hypre's benchmark_struct jobs (BASELINE.md:28-36)
# and bench.py's struct section, float32 at rtol 1e-6 (label, struct
# driver id, dims): the 2-D 5-pt at STRUCT_N2D^2, the 3-D 7-pt at
# STRUCT_N3D^3
STRUCT_N2D = 2048
STRUCT_N3D = 128
STRUCT_RTOL = 1e-6
STRUCT_MAXITER = 200
STRUCT_PATHS = [("PFMG-PCG", 11, 2), ("SMG-PCG", 10, 2), ("PFMG-PCG", 11, 3),
                ("SMG-PCG", 10, 3), ("PFMG", 1, 2), ("SparseMSG-PCG", 12, 2),
                ("StructHybrid", 21, 2)]
STRUCT_KERNELS = ("dia_spmv", "dia_spmv_static")
# (driver id, dims) of the struct paths solved once (their first call is
# the warm_ms) and not profiled: 3-D SMG-PCG at 128^3, ~197 000 kernels
# an iteration, took 61.4 s of the run with one solve
# and the profiled iteration (NVIDIA H100 80GB HBM3, 700.00 W), the
# whole run 999 s once phase 15 came in
STRUCT_ONCE = {(10, 3)}
STRUCT_ONCE_CUT = ("3-D SMG-PCG at 128^3: one solve, no profiled "
                   "iteration, to keep the whole run under ~1000 s")
# card against CPU: tests/test_drivers.py's STRUCT_GOLDEN flags with their
# golden iterations (float64), and the ids they do not cover (None)
STRUCT_SMALL = [
    ("-solver 0 -n 32 32 1", 6), ("-solver 1 -n 32 32 1", 14),
    ("-solver 1 -n 16 16 16", 22), ("-solver 11 -n 32 32 1 -tol 1e-8", 11),
    ("-solver 10 -n 32 32 1 -tol 1e-8", 6),
    ("-solver 1 -n 64 64 1 -c 1 0.01 1", 11),
    ("-solver 2 -n 16 16 1 -tol 1e-8", 11),
    ("-solver 12 -n 16 16 1 -jump 1 -tol 1e-8", 8),
    ("-solver 21 -n 16 16 1 -tol 1e-8", 7),
    ("-solver 32 -n 16 16 1 -tol 1e-8", 6),
    ("-solver 17 -n 10 10 10 -tol 1e-6", 20),
    ("-solver 18 -n 10 10 10 -tol 1e-6", 20),
    ("-solver 8 -n 8 8 1 -tol 1e-5", None),
    ("-solver 20 -n 12 12 12 -tol 1e-8", None),
    ("-solver 22 -n 16 16 1 -tol 1e-8", None),
    ("-solver 30 -n 16 16 1 -tol 1e-8", None),
    ("-solver 31 -n 16 16 1 -tol 1e-8", None)]
STRUCT_COEFF_RTOL = 1e-5
# float32 solves of the card-against-CPU part run at this tolerance: the
# goldens' 1e-5 to 1e-8 lie under what standalone SMG and PFMG reach in
# float32 at these sizes (they stall at 1.5e-5 and 2.9e-5 relative)
STRUCT_F32_TOL = 1e-4
# The sstruct phase (15): the sstruct driver's ids (src/test/sstruct.c,
# TEST_sstruct) and the layer's API, float32 at rtol 1e-6: two glued
# SSTRUCT_N^2 parts (2.1 M unknowns), the two-variable system on
# SSTRUCT_N^2, the composite grid of SSTRUCT_N^2 coarse cells (~1.4 M
# DOFs) and the curl-curl system on SSTRUCT_N^2 cells (2.1 M edges)
SSTRUCT_N = 1024
SSTRUCT_RTOL = 1e-6
SSTRUCT_MAXITER = 1000
# Split standalone's iterations grow linearly with n (block Jacobi over
# the parts with the U couplings lagged): 63 at 12^2, 88 at 24^2, 184 at
# 48^2 in the reference (CPU, f64); 55 / 99 / 172 / 290 at 16^2 - 128^2
# in the port (CPU, f32, b = A x*)
SPLIT_N = 128
SPLIT_CUT = ("Split standalone (id 20) at 2 x 128^2: its iterations grow "
             "linearly with n, ~290 at 128^2, about 4000 at 1024^2")
# the driver's default eps 0.1 makes [L, eps I; eps I, L] indefinite
# past n ~ 13 (lambda_min(L) ~ 2 (pi / (n + 1))^2 < eps); 1e-5 keeps it
# SPD at 1024^2 (lambda_min ~ 1.9e-5)
SYS_EPS = 1e-5
# pointwise Jacobi on the strong-coupling system: 91-97 cycles at 64^2
# and 256^2 (port on the CPU, f32)
SYS_RELAX_MAXITER = 300
# FEM and FEI assemble one element per call (hypre's API): host loops of
# ~37 us (AddFEMValues + AddFEMRHS) and ~24 us (sumInElemMatrix + RHS)
# an element (port on the CPU; ~31 and ~24 us on the H100 machine's
# host), so the sizes keep each loop near 4-5 s
FEM_N = 256
FEM_CUT = ("FEM two parts of 256^2 elements (131 072 calls): one "
           "AddFEMValues call per element, ~37 us each on the host")
FEI_N = 384
FEI_CUT = ("FEI on 384^2 Q1 elements (147 456 calls): one "
           "sumInElemMatrix/RHS call per element, ~24 us each on the host")
SSTRUCT_KERNELS = ("dia_spmv", "dia_spmv_static", "dia_rows",
                   "banded_spmv", "banded_spmv_t")
# card against CPU: tests/test_drivers.py's SSTRUCT_GOLDEN flags with
# their golden iterations (float64); the float32 runs at SSTRUCT_F32_TOL
SSTRUCT_GOLDEN = [
    ("-solver 10 -n 12 -tol 1e-8", 16), ("-solver 11 -n 12 -tol 1e-8", 20),
    ("-solver 20 -n 12 -tol 1e-8", 63), ("-solver 3 -n 16 -tol 1e-7", 16),
    ("-solver 28 -n 12 -tol 1e-8", 15), ("-solver 120 -n 10 -tol 1e-8", 10)]
SSTRUCT_F32_TOL = 1e-4
# Phase 16: the host C++ setup that setup_backend="auto" takes (hypre's
# own split: setup in C on the host, the hierarchy moved to the card
# once): the default facade at N_MAIN^3, the ij driver's -agg_nl and a
# non-Galerkin setup, then card against CPU at N_PARITY^3
NATIVE_RTOL = 1e-6
NONGALERKIN_TOL = 0.02
NATIVE_IJ_FLAGS = (f"-solver 1 -n {N_MAIN} {N_MAIN} {N_MAIN} -agg_nl 1 "
                   f"-tol {NATIVE_RTOL} -recompute 0")
NATIVE_SMALL_CASES = [
    ("default", {}), ("agg_num_levels=1", dict(agg_num_levels=1)),
    ("nongalerkin_tol", dict(nongalerkin_tol=NONGALERKIN_TOL)),
]
# Phase 17: hypre's ParCSR layer on the local backend (every shard on the
# one card): the distributed products at 2, 4 and 8 shards, the
# distributed setup and PCG at PAR_SETUP_SHARDS, a partitioned facade
# hierarchy, ij_mm, and card against CPU at N_PARITY^3
PAR_N = N_MAIN
PAR_SHARDS = (2, 4, 8)
PAR_SETUP_SHARDS = 8
PAR_MAX_COARSE = 1500
PAR_RTOL = 1e-6
PAR_SPMV_RTOL = 1e-6  # against A.mv in float32, relative to max |y|
IJ_MM_JOBS = (1, 2, 4, 5)
IJ_MM_VERIFY_N = N_PARITY
SOURCES = {
    "dia_spmv": ("hypre_tpu_torch/csrc/dia_spmv.cu",
                 "hypre_tpu/seq/dia.py:350 (_dia_kernel)"),
    "dia_spmv_static": ("hypre_tpu_torch/csrc/dia_spmv.cu",
                        "hypre_tpu/seq/dia.py:446 (_dia_kernel_static)"),
    "dia_rows": ("hypre_tpu_torch/csrc/dia_spmv.cu",
                 "hypre_tpu/seq/dia.py:350 (_dia_kernel)"),
    "banded_spmv": ("hypre_tpu_torch/csrc/banded_spmv.cu",
                    "hypre_tpu/seq/fastmv.py:156 (_spmv_kernel)"),
    "banded_spmv_t": ("hypre_tpu_torch/csrc/banded_spmv.cu",
                      "hypre_tpu/seq/fastmv.py:212 (_spmv_t_kernel)"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, torch, warmup: int = 5, reps: int = 50) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls.

    A launch costs the host more than a small kernel costs the card, so
    back-to-back calls would time the host. The card is first held busy
    with a sleep kernel longer than the host needs to enqueue all the
    calls; the events then bracket the calls' device work only."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    # 2 cycles per ns bounds the SM clock from above (H100: 1.98 GHz)
    torch.cuda._sleep(int(min(2 * host_s * reps, 5.0) * 2e9) + 1000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def level_sizes(hier) -> list:
    return [lv.A.n_rows for lv in hier.levels] + [hier.coarse_inv.shape[0]]


def solve(H, hier_fast, A_fast, b, device, rtol):
    sm = H.make_smoother("chebyshev", 1.0, 2, 0.3)
    return H.pcg(A_fast.mv, b,
                 M=lambda r: H.amg_cycle(hier_fast, r, smoother=sm),
                 rtol=rtol, maxiter=100, device=device)


def run_main_path(H, kernels, torch, specialize: bool, hier=None):
    """One main-path run on the card; returns (hier, fast, launches)."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    A = H.laplacian_3d_7pt(N_MAIN, N_MAIN, N_MAIN, dtype=torch.float32,
                           device="cuda")
    if hier is None:
        hier = H.setup_hierarchy(A, device="cuda", **SETUP_KW)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = H.optimize_hierarchy(hier, gather_precision=0,
                                specialize=specialize, device="cuda")
    torch.cuda.synchronize()
    optimize_s = time.perf_counter() - t0
    b = torch.ones(A.n_rows, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    x, info = solve(H, fast, fast.levels[0].A, b, "cuda", 1e-6)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    # the true residual of the f32 solution, evaluated in f64
    A64 = H.laplacian_3d_7pt(N_MAIN, N_MAIN, N_MAIN, dtype=torch.float64,
                             device="cuda")
    b64 = b.double()
    true_rel = float(torch.linalg.vector_norm(b64 - A64.mv(x.double()))
                     / torch.linalg.vector_norm(b64))
    record = {
        "path": "specialized" if specialize else "dynamic",
        "n": A.n_rows, "levels": level_sizes(hier),
        "formats": [[type(lv.A).__name__, type(lv.P).__name__]
                    for lv in fast.levels],
        "setup_s": setup_s, "optimize_s": optimize_s, "solve_s": solve_s,
        "iterations": int(info.iterations),
        "converged": bool(info.converged),
        "relative_residual": float(info.relative_residual),
        "true_relative_residual": true_rel, "launches": launches,
    }
    log(json.dumps(record))
    require(bool(info.converged), f"{record['path']} solve did not converge")
    require(true_rel <= TRUE_RESIDUAL_LIMIT,
            f"true relative residual {true_rel} > {TRUE_RESIDUAL_LIMIT}")
    require(record["iterations"] <= ITERATION_LIMIT,
            f"{record['iterations']} iterations > {ITERATION_LIMIT}")
    require(bool(torch.isfinite(x).all()), "non-finite solution")
    return hier, fast, launches, record["iterations"]


def padded_ones(fast, n: int, torch, dtype, device):
    """b = ones on the n true rows, zeros on the empty rows that a
    row-bucketed hierarchy appends (none at 128^3, a bucket itself): the
    solve then runs on the padded fine operator and x stays 0 there."""
    b = torch.zeros(fast.levels[0].A.n_rows, dtype=dtype, device=device)
    b[:n] = 1.0
    return b


def tensors_of(obj, torch, prefix=""):
    """(path, tensor) for every tensor held by a hierarchy, its levels and
    their operators (dataclasses and lists, recursively)."""
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from tensors_of(v, torch, f"{prefix}[{i}]")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors_of(getattr(obj, f.name), torch,
                                  f"{prefix}.{f.name}")


def describe_formats(fast):
    return [[type(lv.A).__name__, type(lv.P).__name__,
             "P.mv_t" if lv.Pt is None else type(lv.Pt).__name__]
            for lv in fast.levels]


def run_bench_path(H, kernels, torch, transfer_dia: bool):
    """The reference bench's configuration on the card: device setup, then
    optimize + PCG with the dynamic and with the static DIA kernel.
    Returns (hier, {specialize: fast}, {specialize: launches},
    iterations)."""
    from hypre_tpu_torch.seq.fastmv import BandedEll

    tag = "transfer_dia" if transfer_dia else "banded_p"
    A = H.laplacian_3d_7pt(N_MAIN, N_MAIN, N_MAIN, dtype=torch.float32,
                           device="cuda")
    A64 = H.laplacian_3d_7pt(N_MAIN, N_MAIN, N_MAIN, dtype=torch.float64,
                             device="cuda")
    n = A.n_rows
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    width_plan = {}
    t0 = time.perf_counter()
    hier = H.setup_hierarchy_device(A, width_plan=width_plan,
                                    transfer_dia=transfer_dia, **BENCH_KW)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    P0 = hier.levels[0].P
    record = {
        "bench_path": tag, "n": A.n_rows,
        "true_levels": list(hier.n_level_true),
        "bucketed_levels": level_sizes(hier),
        "k": [[lv.A.k, getattr(lv.P, "k", None),
               None if lv.Pt is None else lv.Pt.k] for lv in hier.levels],
        "setup_s": setup_s, "setup_peak_bytes": peak,
        "width_plan": {f"{k[0]}.{k[1]}": v for k, v in width_plan.items()},
    }
    if transfer_dia:
        require(isinstance(P0, H.TransferDia) and hier.levels[0].Pt is None,
                "level 0 does not hold a TransferDia with Pt=None")
        record["transfer_dia"] = {
            "D": P0.P_dia.D,
            "distinct_offsets": len(set(P0.P_dia.offsets.cpu().tolist())),
            "expand": [P0.expand.B, P0.expand.W, P0.expand.n_xpad],
            "compress": [P0.compress.B, P0.compress.W, P0.compress.n_xpad]}
    log(json.dumps(record))

    fasts, launches, iters = {}, {}, {}
    for specialize in (False, True):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fast = H.optimize_hierarchy(hier, gather_precision=0,
                                    specialize=specialize)
        torch.cuda.synchronize()
        optimize_s = time.perf_counter() - t0
        b = padded_ones(fast, n, torch, torch.float32, "cuda")
        t0 = time.perf_counter()
        x, info = solve(H, fast, fast.levels[0].A, b, None, 1e-6)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launches[specialize] = dict(kernels.LAUNCHES)
        true_rel = float(torch.linalg.vector_norm(
            b[:n].double() - A64.mv(x[:n].double()))
            / torch.linalg.vector_norm(b.double()))
        rec = {"bench_path": tag,
               "solve": "specialized" if specialize else "dynamic",
               "formats": describe_formats(fast),
               "optimize_s": optimize_s, "solve_s": solve_s,
               "iterations": int(info.iterations),
               "converged": bool(info.converged),
               "relative_residual": float(info.relative_residual),
               "true_relative_residual": true_rel,
               "launches": launches[specialize]}
        log(json.dumps(rec))
        what = f"{tag} {rec['solve']} solve"
        require(bool(info.converged), f"{what} did not converge")
        require(bool(torch.isfinite(x).all()), f"{what}: non-finite solution")
        require(true_rel <= TRUE_RESIDUAL_LIMIT,
                f"{what}: true relative residual {true_rel} > "
                f"{TRUE_RESIDUAL_LIMIT}")
        require(rec["iterations"] <= BENCH_ITERATION_LIMIT,
                f"{what}: {rec['iterations']} iterations > "
                f"{BENCH_ITERATION_LIMIT}")
        P0f = fast.levels[0].P
        if transfer_dia:
            require(isinstance(P0f, H.TransferDia)
                    and fast.levels[0].Pt is None,
                    f"{what}: level-0 P is not a TransferDia")
        else:
            require(isinstance(P0f, BandedEll) and P0f.t_vals is not None
                    and fast.levels[0].Pt is None,
                    f"{what}: level-0 P is not banded with a schedule")
        suffix = "_static" if specialize else ""
        per_it = per_iteration_launches(H, kernels, torch, fast)
        # 6 dense products of the level-0 A; 2 row-list transfers (one
        # row-list kernel, whichever offsets the planes carry)
        want = {"dia_spmv" + suffix: 6,
                "dia_rows": 2 if transfer_dia else 0}
        for name in ("dia_spmv", "dia_spmv_static", "dia_rows"):
            require(per_it[name] == want.get(name, 0),
                    f"{what}: {per_it[name]} {name} launches per "
                    f"iteration, expected {want.get(name, 0)}")
        for name in [k for k, v in want.items() if v] + [
                "banded_spmv", "banded_spmv_t"]:
            require(launches[specialize][name] > 0,
                    f"{what} never launched {name}")
        fasts[specialize], iters[specialize] = fast, rec["iterations"]
    require(iters[False] == iters[True],
            f"{tag}: dynamic ({iters[False]}) and specialized "
            f"({iters[True]}) solves took different iteration counts")
    return hier, fasts, launches, iters[True]


def per_iteration_launches(H, kernels, torch, fast):
    """Launches of one PCG iteration (one A.mv and one V-cycle), counted,
    beside the per-level tally the cycle's structure predicts."""
    sm = H.make_smoother("chebyshev", 1.0, 2, 0.3)
    r = torch.ones(fast.levels[0].A.n_rows, dtype=torch.float32,
                   device="cuda")
    kernels.reset_launches()
    fast.levels[0].A.mv(r)
    H.amg_cycle(fast, r, smoother=sm)
    torch.cuda.synchronize()
    counted = dict(kernels.LAUNCHES)
    per_level = []
    for li, lv in enumerate(fast.levels):
        a_mvs = 2 * 2 + 1 + (1 if li == 0 else 0)  # Chebyshev 2+2, residual, Krylov
        per_level.append({
            "level": li, "A": type(lv.A).__name__, "A_mv": a_mvs,
            "P": type(lv.P).__name__, "P_mv": 1,
            "restrict": type(lv.Pt).__name__ if lv.Pt is not None else
            "TransferDia.mv_t" if isinstance(lv.P, H.TransferDia) else
            "banded_spmv_t",
        })
    log(json.dumps({"launches_per_pcg_iteration": counted,
                    "per_level": per_level}))
    return counted


def rel_err(a, b, torch) -> tuple[float, float]:
    diff = float((a.double() - b.double()).abs().max())
    scale = float(b.double().abs().max())
    return diff / max(scale, 1e-300), diff


def csr_of(ell, torch):
    """torch CSR tensor of an ELL matrix (yardstick for library_ms only)."""
    warnings.filterwarnings("ignore", message="Sparse")
    mask = ell.cols >= 0
    counts = mask.sum(dim=1)
    crow = torch.zeros(ell.n_rows + 1, dtype=torch.int64, device=ell.device)
    crow[1:] = torch.cumsum(counts, 0)
    return torch.sparse_csr_tensor(crow, ell.cols[mask].long(),
                                   ell.vals[mask], size=ell.shape)


def check_kernels(H, torch, hier, fast):
    from hypre_tpu_torch.seq import dia as dia_mod
    from hypre_tpu_torch.seq import fastmv
    from hypre_tpu_torch.seq.spgemm import ell_transpose

    rng = np.random.default_rng(0)
    results = {}

    # kernels 1 and 2: DIA at 128^3, D=7, f32 and f64
    A = H.laplacian_3d_7pt(N_MAIN, N_MAIN, N_MAIN, dtype=torch.float32,
                           device="cuda")
    dia32 = dia_mod.try_dia(A)
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        dvals = dia32.dvals.to(dtype).contiguous()
        csr = csr_of(H.laplacian_3d_7pt(N_MAIN, N_MAIN, N_MAIN, dtype=dtype,
                                        device="cuda"), torch)
        n, D = dia32.n_rows, dia32.D
        offs_static = tuple(int(o) for o in dia32.offsets.cpu().tolist())
        x = torch.from_numpy(rng.standard_normal(n)).to("cuda", dtype)
        esize = dvals.element_size()
        nbytes = D * n * esize + 2 * n * esize + D * 4
        bms, bby = bound(nbytes, 2.0 * D * n, str(dtype).split(".")[1])
        for name, kern, plain in (
            ("dia_spmv",
             lambda: dia_mod.dia_spmv(dvals, dia32.offsets, x, n,
                                      dia32.margin),
             lambda: dia_mod.dia_spmv_plain(dvals, dia32.offsets, x,
                                            dia32.margin)),
            ("dia_spmv_static",
             lambda: dia_mod.dia_spmv_static(dvals, offs_static, x, n),
             lambda: dia_mod.dia_spmv_static_plain(dvals, offs_static, x)),
        ):
            rel, ab = rel_err(kern(), plain(), torch)
            rel_lib, _ = rel_err(kern(), (csr @ x[:, None])[:, 0], torch)
            rec = {"check": name, "dtype": str(dtype), "shape": [D, n],
                   "max_rel_err": rel, "max_abs_err": ab, "tol": tol,
                   "rel_err_vs_csr": rel_lib,
                   "ms": time_ms(kern, torch),
                   "plain_ms": time_ms(plain, torch, warmup=2, reps=10),
                   "bound_ms": bms, "bound_by": bby,
                   "library_ms": time_ms(lambda: csr @ x[:, None], torch)}
            log(json.dumps(rec))
            require(rel <= tol, f"{name} {dtype}: rel err {rel} > {tol}")
            if dtype == torch.float32:
                results[name] = rec

    # kernels 1 and 2 at D = 27: the 27-pt level-0 operator of phase 8
    # (its rows go under other_shapes of the kernels line)
    A27 = H.laplacian_3d_27pt(N_MAIN, N_MAIN, N_MAIN, dtype=torch.float32,
                              device="cuda")
    dia27 = dia_mod.try_dia(A27)
    require(dia27 is not None and dia27.D == 27, "the 27-pt A is not D = 27")
    csr27 = csr_of(A27, torch)
    del A27
    n, D = dia27.n_rows, dia27.D
    offs27 = tuple(int(o) for o in dia27.offsets.cpu().tolist())
    x = torch.from_numpy(rng.standard_normal(n)).to("cuda", torch.float32)
    bms, bby = bound(D * n * 4 + 2 * n * 4, 2.0 * D * n, "float32")
    lib = (csr27 @ x[:, None])[:, 0]
    lib_ms = time_ms(lambda: csr27 @ x[:, None], torch)
    results["d27"] = []
    for name, kern, plain in (
        ("dia_spmv",
         lambda: dia_mod.dia_spmv(dia27.dvals, dia27.offsets, x, n,
                                  dia27.margin),
         lambda: dia_mod.dia_spmv_plain(dia27.dvals, dia27.offsets, x,
                                        dia27.margin)),
        ("dia_spmv_static",
         lambda: dia_mod.dia_spmv_static(dia27.dvals, offs27, x, n),
         lambda: dia_mod.dia_spmv_static_plain(dia27.dvals, offs27, x)),
    ):
        rel, ab = rel_err(kern(), plain(), torch)
        rel_lib, _ = rel_err(kern(), lib, torch)
        rec = {"check": name, "operator": "A27 (27-pt level 0)",
               "shape": [D, n], "max_rel_err": rel, "max_abs_err": ab,
               "tol": 0.0, "rel_err_vs_csr": rel_lib,
               "ms": time_ms(kern, torch),
               "plain_ms": time_ms(plain, torch, warmup=1, reps=5),
               "bound_ms": bms, "bound_by": bby, "library_ms": lib_ms}
        log(json.dumps(rec))
        require(ab == 0.0, f"{name} at D = 27 differs from the plain "
                f"version by {ab}")
        require(rel_lib <= 1e-5, f"{name} at D = 27: rel err {rel_lib} "
                "against the CSR product")
        results["d27"].append(rec)
    del dia27, csr27

    # kernels 3 and 4 on every banded P and on the largest coarse A
    coarse = [li for li in range(1, len(fast.levels))
              if isinstance(fast.levels[li].A, fastmv.BandedEll)]
    require(isinstance(fast.levels[0].P, fastmv.BandedEll),
            "level-0 P is not banded")
    require(bool(coarse), "no banded coarse A")
    big = max(coarse, key=lambda li: fast.levels[li].A.n_rows)
    ops = [(f"P{li}", hier.levels[li].P, lv.P)
           for li, lv in enumerate(fast.levels)
           if isinstance(lv.P, fastmv.BandedEll)]
    # listed last: the kernels line reports the largest coarse A
    ops.append((f"A{big}", hier.levels[big].A, fast.levels[big].A))
    for label, ell, band in ops:
        k, n_pad = band.vals_t.shape
        payload = k * n_pad * 8 + band.starts.numel() * 4
        flops = 2.0 * k * band.n_rows
        csr = csr_of(ell, torch)
        csr_t = csr_of(ell_transpose(ell), torch)
        x = torch.from_numpy(rng.standard_normal(band.n_cols)) \
            .to("cuda", torch.float32)
        r = torch.from_numpy(rng.standard_normal(band.n_rows)) \
            .to("cuda", torch.float32)
        io = (band.n_cols + band.n_rows) * 4

        def kern():
            return fastmv.banded_spmv(band, x)

        def plain():
            return fastmv.banded_spmv_plain(band.vals_t, band.lcols_t,
                                            band.starts, x, band.n_rows,
                                            band.B)

        rel, ab = rel_err(kern(), plain(), torch)
        rel_lib, _ = rel_err(kern(), (csr @ x[:, None])[:, 0], torch)
        bms, bby = bound(payload + io, flops, "float32")
        rec = {"check": "banded_spmv", "operator": label, "shape": [k, n_pad],
               "n_rows": band.n_rows, "n_cols": band.n_cols,
               "max_rel_err": rel, "max_abs_err": ab, "tol": 1e-6,
               "rel_err_vs_csr": rel_lib,
               "ms": time_ms(kern, torch),
               "plain_ms": time_ms(plain, torch, warmup=2, reps=10),
               "bound_ms": bms, "bound_by": bby,
               "library_ms": time_ms(lambda: csr @ x[:, None], torch)}
        log(json.dumps(rec))
        require(rel <= 1e-6, f"banded_spmv {label}: rel err {rel}")

        # kernel 4 reads the transpose schedule; the coarse A gets one here
        # for this timing row (the solve restricts through P only)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        band_t = fastmv.with_transpose_schedule(band)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if band.t_vals is not None:
            require(all(torch.equal(getattr(band, f), getattr(band_t, f))
                        for f in ("t_vals", "t_rows", "t_colptr",
                                  "t_chunks")),
                    f"{label}: the schedule differs when built again")
        nnz = int(band_t.t_colptr[-1])
        sched_bytes = sum(getattr(band_t, f).numel() * 4 for f in
                          ("t_vals", "t_rows", "t_colptr", "t_chunks"))
        seg = band_t.t_colptr[1:] - band_t.t_colptr[:-1]

        def kern_t():
            return fastmv.banded_spmv_t(band_t, r)

        def plain_t():
            return fastmv.banded_spmv_t_plain(band_t.t_vals, band_t.t_rows,
                                              band_t.t_colptr, r)

        y1, y2 = kern_t(), kern_t()
        rel_t, ab_t = rel_err(y1, plain_t(), torch)
        rel_lib_t, _ = rel_err(y1, (csr_t @ r[:, None])[:, 0], torch)
        rerun, _ = rel_err(y2, y1, torch)
        # the bytes the function must move whatever implements it: a value
        # and a row (or column) index per nonzero, r read and y written
        # once, and the pointers that delimit the columns and the chunks
        bms_t, bby_t = bound(
            nnz * 8 + io
            + (band_t.t_colptr.numel() + band_t.t_chunks.numel()) * 4,
            2.0 * nnz, "float32")
        rec_t = {"check": "banded_spmv_t", "operator": label,
                 "n_rows": band.n_rows, "n_cols": band.n_cols, "nnz": nnz,
                 "schedule_bytes": sched_bytes,
                 "schedule_build_s": build_s,
                 "chunks": band_t.t_chunks.numel() - 1,
                 "longest_segment": int(seg.max()),
                 "mean_segment": nnz / max(band.n_cols, 1),
                 "max_rel_err": rel_t, "max_abs_err": ab_t, "tol": 1e-6,
                 "rel_err_vs_csr": rel_lib_t, "run_to_run_rel": rerun,
                 "ms": time_ms(kern_t, torch),
                 "plain_ms": time_ms(plain_t, torch, warmup=2, reps=10),
                 "bound_ms": bms_t, "bound_by": bby_t,
                 "library_ms": time_ms(lambda: csr_t @ r[:, None], torch)}
        log(json.dumps(rec_t))
        require(rel_t <= 1e-6, f"banded_spmv_t {label}: rel err {rel_t}")
        require(rerun == 0.0 and bool(torch.equal(y1, y2)),
                f"banded_spmv_t {label}: two runs differ ({rerun})")
        for name, rc in (("banded_spmv", rec), ("banded_spmv_t", rec_t)):
            # the largest error over all operators beside the last one's times
            prev = results.get(name)
            results[name] = rc if prev is None else dict(
                rc, max_abs_err=max(rc["max_abs_err"], prev["max_abs_err"]))
    return results


def csr_of_dia(D, torch):
    """torch CSR tensor of a DiaMatrix's nonzeros (yardstick only)."""
    warnings.filterwarnings("ignore", message="Sparse")
    d, rows = torch.nonzero(D.dvals, as_tuple=True)
    cols = rows + D.offsets.long()[d]
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]),
                                  D.dvals[d, rows], size=D.shape)
    return coo.coalesce().to_sparse_csr()


def csr_of_banded(M, torch):
    """torch CSR tensor of a BandedEll's nonzeros, from its slot-major
    payload (an optimized hierarchy keeps no ELL; yardstick only)."""
    warnings.filterwarnings("ignore", message="Sparse")
    n = M.n_rows
    base = M.starts.long().repeat_interleave(M.B)[:n]
    vals = M.vals_t[:, :n]
    cols = base[None, :] + M.lcols_t[:, :n].long()
    s, rows = torch.nonzero(vals, as_tuple=True)
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols[s, rows]]),
                                  vals[s, rows], size=M.shape)
    return coo.coalesce().to_sparse_csr()


def dense_only(M):
    """A DiaMatrix without its row-list layout: the dense kernels' route."""
    return dataclasses.replace(M, r_ptr=None, r_ids=None, r_vals=None,
                               r_rows=None, r_mask=None, r_lanes=1)


def check_transfer_kernels(H, torch, T, T_static, hier_banded,
                           fast_banded):
    """Kernels 1 and 2 at D = 64 (P_dia, Pt_dia) — the dense kernels on the
    planes and the row-list kernels on their compact layout — and kernel 3
    on the k = 1 selections of the bench's TransferDia (``T``;
    ``T_static`` is its specialized twin), then the whole level-0 transfer
    both ways: TransferDia on the row list and on the dense planes against
    the banded route for the same P (kernel 3 forward, kernel 4 back) and
    against one CSR product."""
    from hypre_tpu_torch.seq import dia as dia_mod
    from hypre_tpu_torch.seq import fastmv
    from hypre_tpu_torch.seq.spgemm import ell_transpose

    rng = np.random.default_rng(1)
    out = {"dia_spmv": [], "dia_spmv_static": [], "dia_rows": [],
           "banded_spmv": []}
    n = T.n_rows
    for label, M in (("P_dia", T.P_dia), ("Pt_dia", T.Pt_dia)):
        D = M.D
        require(D == 64, f"{label} has D = {D}, expected 64")
        require(M.r_ptr is not None, f"{label} has no row-list layout")
        csr = csr_of_dia(M, torch)
        nnz = int(csr.values().numel())
        offs_static = tuple(int(o) for o in M.offsets.cpu().tolist())
        x = torch.from_numpy(rng.standard_normal(n)).to("cuda",
                                                        torch.float32)
        bms, bby = bound(D * n * 4 + 2 * n * 4 + D * 4, 2.0 * D * n,
                         "float32")
        lib = (csr @ x[:, None])[:, 0]
        lib_ms = time_ms(lambda: csr @ x[:, None], torch)
        for name, kern, plain in (
            ("dia_spmv",
             lambda: dia_mod.dia_spmv(M.dvals, M.offsets, x, n, M.margin),
             lambda: dia_mod.dia_spmv_plain(M.dvals, M.offsets, x,
                                            M.margin)),
            ("dia_spmv_static",
             lambda: dia_mod.dia_spmv_static(M.dvals, offs_static, x, n),
             lambda: dia_mod.dia_spmv_static_plain(M.dvals, offs_static, x)),
        ):
            rel, ab = rel_err(kern(), plain(), torch)
            rel_lib, _ = rel_err(kern(), lib, torch)
            rec = {"check": name, "operator": label, "shape": [D, n],
                   "nnz": nnz, "max_rel_err": rel, "max_abs_err": ab,
                   "tol": 1e-6, "rel_err_vs_csr": rel_lib,
                   "ms": time_ms(kern, torch),
                   "plain_ms": time_ms(plain, torch, warmup=1, reps=5),
                   "bound_ms": bms, "bound_by": bby, "library_ms": lib_ms}
            log(json.dumps(rec))
            require(rel <= 1e-6, f"{name} {label}: rel err {rel}")
            require(rel_lib <= 1e-5, f"{name} {label}: rel err {rel_lib} "
                    "against the CSR product")
            out[name].append(rec)
        rec_rows = check_row_list(torch, dia_mod, label, M, x, csr, lib,
                                  lib_ms, offs_static)
        for name, rec in rec_rows.items():
            out[name].append(rec)

    for label, sel in (("expand", T.expand), ("compress", T.compress)):
        k, n_pad = sel.vals_t.shape
        require(k == 1, f"{label} has k = {k}")
        csr = csr_of(sel.ell, torch)
        x = torch.from_numpy(rng.standard_normal(sel.n_cols)) \
            .to("cuda", torch.float32)
        bms, bby = bound(n_pad * 8 + sel.starts.numel() * 4
                         + (sel.n_cols + sel.n_rows) * 4,
                         2.0 * sel.n_rows, "float32")

        def kern():
            return fastmv.banded_spmv(sel, x)

        def plain():
            return fastmv.banded_spmv_plain(sel.vals_t, sel.lcols_t,
                                            sel.starts, x, sel.n_rows, sel.B)

        rel, ab = rel_err(kern(), plain(), torch)
        rel_lib, _ = rel_err(kern(), (csr @ x[:, None])[:, 0], torch)
        rec = {"check": "banded_spmv", "operator": label,
               "shape": [k, n_pad], "B": sel.B, "n_rows": sel.n_rows,
               "n_cols": sel.n_cols, "max_rel_err": rel, "max_abs_err": ab,
               "tol": 0.0, "rel_err_vs_csr": rel_lib,
               "ms": time_ms(kern, torch),
               "plain_ms": time_ms(plain, torch, warmup=2, reps=10),
               "bound_ms": bms, "bound_by": bby,
               "library_ms": time_ms(lambda: csr @ x[:, None], torch)}
        log(json.dumps(rec))
        require(ab == 0.0, f"banded_spmv {label}: differs from the plain "
                f"version by {ab}")
        require(rel_lib == 0.0, f"banded_spmv {label}: differs from the "
                "CSR product")
        out["banded_spmv"].append(rec)

    # the whole level-0 transfer, both ways, by three routes
    P_ell = hier_banded.levels[0].P
    P_band = fast_banded.levels[0].P
    require(isinstance(P_band, fastmv.BandedEll)
            and P_band.t_vals is not None, "banded level-0 P has no schedule")
    csr = csr_of(P_ell, torch)
    csr_t = csr_of(ell_transpose(P_ell), torch)
    ec = torch.from_numpy(rng.standard_normal(T.n_cols)) \
        .to("cuda", torch.float32)
    r = torch.from_numpy(rng.standard_normal(n)).to("cuda", torch.float32)
    up_ref = (csr @ ec[:, None])[:, 0]
    down_ref = (csr_t @ r[:, None])[:, 0]
    dense = {tag: dataclasses.replace(t, P_dia=dense_only(t.P_dia),
                                      Pt_dia=dense_only(t.Pt_dia))
             for tag, t in (("dynamic", T), ("static", T_static))}
    routes = {
        "prolong": {
            "transfer_dia_dynamic": lambda: T.mv(ec),
            "transfer_dia_static": lambda: T_static.mv(ec),
            "transfer_dia_dense_dynamic": lambda: dense["dynamic"].mv(ec),
            "transfer_dia_dense_static": lambda: dense["static"].mv(ec),
            "banded": lambda: P_band.mv(ec),
            "csr": lambda: csr @ ec[:, None]},
        "restrict": {
            "transfer_dia_dynamic": lambda: T.mv_t(r),
            "transfer_dia_static": lambda: T_static.mv_t(r),
            "transfer_dia_dense_dynamic": lambda: dense["dynamic"].mv_t(r),
            "transfer_dia_dense_static": lambda: dense["static"].mv_t(r),
            "banded": lambda: fastmv.banded_spmv_t(P_band, r),
            "csr": lambda: csr_t @ r[:, None]},
    }
    rec = {"transfer": "level-0 P", "shape": list(P_ell.shape),
           "nnz": int((P_ell.cols >= 0).sum()),
           "bytes": {"transfer_dia_planes": 2 * T.P_dia.dvals.numel() * 4,
                     "transfer_dia_row_lists": sum(
                         layout_bytes(M) for M in (T.P_dia, T.Pt_dia)),
                     "banded_payload": P_band.vals_t.numel() * 8,
                     "banded_schedule": P_band.t_vals.numel() * 8}}
    for way, ref in (("prolong", up_ref), ("restrict", down_ref)):
        for name, fn in routes[way].items():
            got = fn()
            got = got[:, 0] if got.ndim == 2 else got
            rel, _ = rel_err(got, ref, torch)
            require(rel <= 1e-5, f"{way} by {name}: rel err {rel} against "
                    "the CSR product")
            rec[f"{way}_{name}_ms"] = time_ms(fn, torch)
    log(json.dumps(rec))
    return out, rec


def layout_bytes(M) -> int:
    """Bytes a DiaMatrix's row-list layout holds (the list and its bitmask
    too)."""
    return sum(t.numel() * t.element_size()
               for t in (M.r_ptr, M.r_ids, M.r_vals, M.r_rows, M.r_mask)
               if t is not None)


def row_list_columns(M, torch):
    """The in-range columns the row-list layout of M reaches, one per
    entry."""
    n_list = M.r_ptr.numel() - 1
    slots = torch.repeat_interleave(
        torch.arange(n_list, device=M.device),
        (M.r_ptr[1:] - M.r_ptr[:-1]).long())
    rows = (slots if M.r_rows is None else M.r_rows.long()[slots])
    cols = (rows + M.offsets.long()[M.r_ids.long()]
            if M.r_ids.dtype == torch.uint8 else M.r_ids.long())
    return cols[(cols >= 0) & (cols < M.n_cols)]


def row_list_bounds(M, torch) -> dict:
    """The two yardsticks of a row-list product in float32. ``bound_ms``:
    the bytes the row-list kernel must move, its layout, x at the distinct
    columns the layout reaches and y once. ``nnz_bound_ms``: the bytes of
    the function alone, whatever the layout: y written, each nonzero's
    value and int32 column read once, x at min(nnz, n_cols) columns (the
    same yardstick for every layout of the same function)."""
    n, nnz = M.n_rows, int(M.r_vals.numel())
    cols = row_list_columns(M, torch)
    x_cols = int(torch.unique(cols).numel())
    bms, bby = bound(layout_bytes(M) + x_cols * 4 + n * 4, 2.0 * nnz,
                     "float32")
    nnz_bms, _ = bound(4 * (n + 2 * nnz + min(nnz, M.n_cols)), 2.0 * nnz,
                       "float32")
    return {"nnz": nnz, "x_cols": x_cols,
            "x_sector_bytes": int(torch.unique(cols // 8).numel()) * 32,
            "bound_ms": bms, "bound_by": bby, "nnz_bound_ms": nnz_bms}


def check_row_list(torch, dia_mod, label, M, x, csr, lib, lib_ms,
                   offs_static=None):
    """The row-list kernel on ``M``'s compact layout: the bits of the dense
    kernels' plain version and of its own plain version, the same bits in
    two runs and with the static offsets; its time beside both bounds
    (``row_list_bounds``), the dense kernels' and the CSR call's times.
    The layout is built again from the planes alone, timed, and must
    equal the one the path built. Then the kernel with one thread and with
    4 lanes a listed row on the same planes, each at 0 error
    (``variants_ms``)."""
    n, D = M.n_rows, M.D
    fields = ("r_ptr", "r_ids", "r_vals", "r_rows", "r_mask")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = dia_mod.compact_dia(dense_only(M))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(all((getattr(again, f) is None and getattr(M, f) is None)
                or torch.equal(getattr(again, f), getattr(M, f))
                for f in fields) and again.r_lanes == M.r_lanes,
            f"{label}: the row-list layout differs when built again")
    dense_ref = dia_mod.dia_spmv_plain(M.dvals, M.offsets, x, M.margin)

    def kern():
        return M.mv(x)

    def plain():
        return dia_mod.dia_rows_plain(M.r_ptr, M.r_ids, M.r_vals, M.offsets,
                                      x, n, M.n_cols, M.r_rows)

    y1, y2 = kern(), kern()
    y_st = dia_mod.dia_rows(M.r_ptr, M.r_ids, M.r_vals,
                            offs_static or tuple(M.offsets.cpu().tolist()),
                            x, n, M.n_cols, M.r_rows, M.r_mask, M.r_lanes)
    rel, ab = rel_err(y1, plain(), torch)
    rel_dense, ab_dense = rel_err(y1, dense_ref, torch)
    rel_lib, _ = rel_err(y1, lib, torch)
    rerun, _ = rel_err(y2, y1, torch)
    variants = {}
    for lanes in dia_mod.ROW_LANES:
        V = compact_with_lanes(dia_mod, dense_only(M), lanes)
        require(bool(torch.equal(V.mv(x), dense_ref)),
                f"{label}: the row list with {lanes} lanes a row differs "
                "from the dense plain version")
        variants[f"lanes_{lanes}"] = time_ms(lambda V=V: V.mv(x), torch)
    rec = {"check": "dia_rows", "operator": label, "shape": [D, n],
           "lanes": M.r_lanes,
           "listed_rows": None if M.r_rows is None else M.r_rows.numel(),
           "non_empty_rows": int((M.dvals != 0).any(0).sum()),
           "schedule_bytes": layout_bytes(M),
           "plane_bytes": M.dvals.numel() * M.dvals.element_size(),
           "build_s": build_s,
           "max_rel_err": rel, "max_abs_err": ab, "tol": 0.0,
           "max_abs_err_vs_dense_plain": ab_dense,
           "rel_err_vs_csr": rel_lib, "run_to_run_rel": rerun,
           "ms": time_ms(kern, torch),
           "plain_ms": time_ms(plain, torch, warmup=1, reps=5),
           **row_list_bounds(M, torch), "library_ms": lib_ms,
           "variants_ms": variants}
    log(json.dumps(rec))
    require(ab == 0.0 and ab_dense == 0.0,
            f"dia_rows {label}: differs from the plain versions by {ab} "
            f"(row list) and {ab_dense} (dense planes)")
    require(rel_lib <= 1e-5, f"dia_rows {label}: rel err {rel_lib} "
            "against the CSR product")
    require(rerun == 0.0 and bool(torch.equal(y1, y2))
            and bool(torch.equal(y_st, y1)),
            f"dia_rows {label}: two runs, or the static offsets, differ")
    return {"dia_rows": rec}


def compact_with_lanes(dia_mod, M, lanes: int):
    """``compact_dia(M)`` with ``lanes`` lanes a listed row whatever the
    rows' mean length, and whatever the layout's share of the planes."""
    saved = dia_mod.ROWS_PER_LANE, dia_mod.ROWS_MAX_SHARE
    dia_mod.ROWS_PER_LANE = float("inf") if lanes == 1 else 0
    dia_mod.ROWS_MAX_SHARE = float("inf")
    try:
        return dia_mod.compact_dia(M)
    finally:
        dia_mod.ROWS_PER_LANE, dia_mod.ROWS_MAX_SHARE = saved


def row_lanes_sweep(torch, dia_mod) -> list:
    """Where 4 lanes a listed row start to beat one thread a row: D = 64
    planes over N_MAIN^3 rows holding ~3.1 M nonzeros (the bench P's
    count) in listed rows of ``m`` entries each, for m from 1 to 32, timed
    with each lane count (float32); the two must give the same bits."""
    n, D, nnz = N_MAIN ** 3, 64, 3 << 20
    out = []
    for m in (1, 2, 4, 8, 12, 16, 32):
        g = torch.Generator(device="cuda").manual_seed(m)
        n_list = min(nnz // m, n)
        rows = torch.randperm(n, generator=g, device="cuda")[:n_list]
        planes = torch.rand(n_list, D, generator=g, device="cuda") \
            .argsort(1)[:, :m]
        dv = torch.zeros(D, n, device="cuda")
        dv[planes.reshape(-1), rows.repeat_interleave(m)] = \
            torch.rand(n_list * m, generator=g, device="cuda") + 0.5
        M = dia_mod.DiaMatrix(dvals=dv, offsets=tuple(range(-32, 32)),
                              n_cols=n)
        x = torch.rand(n, generator=g, device="cuda")
        rec = {"row_lanes_sweep": m, "listed_rows": n_list,
               "nnz": n_list * m}
        ys = []
        for lanes in dia_mod.ROW_LANES:
            C = compact_with_lanes(dia_mod, M, lanes)
            ys.append(C.mv(x))
            rec[f"lanes_{lanes}_ms"] = time_ms(lambda C=C: C.mv(x), torch)
        log(json.dumps(rec))
        require(bool(torch.equal(ys[0], ys[1])),
                f"row-list lanes sweep m={m}: the lane counts differ")
        out.append(rec)
        del dv, M, C
    return out


def true_rel(A64, x, b) -> float:
    """||b - A x|| / ||b|| with A, x and b in float64."""
    b64 = b.double()
    return float((A64.mv(x.double()) - b64).norm() / b64.norm())


def facade_solves(H, amg, b):
    """The facade phase's solves, name -> zero-argument call: each Krylov
    driver with the facade as M on the facade's own fine operator (the DIA
    kernel's), and the standalone AMG iteration. A row-padded hierarchy
    gets b padded with zeros; each call returns x at b's size."""
    fine = amg.hierarchy.levels[0].A
    n = b.shape[0]
    bp = b.new_zeros(fine.n_rows)
    bp[:n] = b

    def krylov(name, kw):
        kw = dict(dict(rtol=FACADE_RTOL), **kw)
        x, info = getattr(H, name)(fine.mv, bp, M=amg.precond(), maxiter=100,
                                   device=b.device, **kw)
        return x[:n], info

    out = {name: (lambda name=name, kw=kw: krylov(name, kw))
           for name, kw in FACADE_SOLVERS.items()}
    out["amg.solve"] = lambda: amg.solve(b, rtol=TRUE_RESIDUAL_LIMIT,
                                         maxiter=100)
    return out


def run_facade_path(H, kernels, torch):
    """The facade on the card at 128^3 float32; returns the path's launch
    counts (set to 0 just before, read just after) and the records."""
    kernels.reset_launches()
    A = H.laplacian_3d_7pt(N_MAIN, N_MAIN, N_MAIN, dtype=torch.float32,
                           device="cuda")
    A64 = H.laplacian_3d_7pt(N_MAIN, N_MAIN, N_MAIN, dtype=torch.float64,
                             device="cuda")
    b = torch.ones(A.n_rows, dtype=torch.float32, device="cuda")
    records = []
    for label, knobs, names in (
            ("default", dict(max_coarse_size=1500), None),
            ("device", dict(setup_backend="device", agg_num_levels=1,
                            max_coarse_size=1500), ("gmres",))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        amg = H.BoomerAMG(**knobs).setup(A)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        hier = amg.hierarchy
        log(json.dumps({"facade": label, "knobs": knobs, "setup_s": setup_s,
                        "setup_path": amg.setup_path,
                        "levels": level_sizes(hier),
                        "formats": describe_formats(hier)}))
        log(amg.stats())
        for name, solve in facade_solves(H, amg, b).items():
            if names is not None and name not in names:
                continue
            before = dict(kernels.LAUNCHES)
            x, info = solve()  # cold
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = solve()
            torch.cuda.synchronize()
            warm_ms = (time.perf_counter() - t0) * 1e3
            grew = {k: (kernels.LAUNCHES[k] - before[k]) // 2
                    for k in kernels.LAUNCHES}
            it = int(info.iterations)
            rec = {"facade": label, "solver": name, "iterations": it,
                   "converged": bool(info.converged),
                   "relative_residual": float(info.relative_residual),
                   "true_relative_residual": true_rel(A64, x, b),
                   "warm_ms": warm_ms, "launches": grew,
                   "launches_per_iteration": {
                       k: v / max(it, 1) for k, v in grew.items() if v}}
            log(json.dumps(rec))
            what = f"facade {label} {name}"
            require(rec["converged"], f"{what} did not converge")
            require(bool(torch.isfinite(x).all()), f"{what}: non-finite x")
            require(rec["true_relative_residual"] <= TRUE_RESIDUAL_LIMIT,
                    f"{what}: true relative residual "
                    f"{rec['true_relative_residual']} > "
                    f"{TRUE_RESIDUAL_LIMIT}")
            for k in ("dia_spmv", "banded_spmv", "banded_spmv_t"):
                require(grew[k] > 0, f"{what} never launched {k}")
            records.append(rec)
    return dict(kernels.LAUNCHES), records


def has_banded(hier) -> bool:
    from hypre_tpu_torch.seq.fastmv import BandedEll

    return any(isinstance(M, BandedEll) for lv in hier.levels
               for M in (lv.A, lv.P, lv.Pt))


def option_run(H, torch, device, knobs, solve):
    """One options-phase case on ``device``: facade setup with the kernel
    formats, then the solve. Returns the comparable record."""
    A = H.laplacian_3d_7pt(N_OPTIONS, N_OPTIONS, N_OPTIONS,
                           dtype=torch.float32, device=device)
    amg = H.BoomerAMG(max_coarse_size=OPTIONS_MAX_COARSE, **knobs).setup(
        A, optimize=True, device=device)
    hier = amg.hierarchy
    b = torch.ones(A.n_rows, dtype=torch.float32, device=device)
    if solve == "solveT":
        # the standalone iteration tests b - A^T x in float32 (the floor)
        x, info = amg.solveT(b, rtol=TRUE_RESIDUAL_LIMIT, maxiter=200)
    else:
        x, info = getattr(H, solve)(hier.levels[0].A.mv, b, M=amg.precond(),
                                    rtol=FACADE_RTOL, maxiter=200,
                                    device=device)
    return {"setup_path": amg.setup_path, "levels": level_sizes(hier),
            "c_points": [int((lv.cf == 1).sum()) for lv in hier.levels],
            "formats": describe_formats(hier), "banded": has_banded(hier),
            "iterations": int(info.iterations),
            "converged": bool(info.converged),
            "relative_residual": float(info.relative_residual)}


def extra_option_runs(H, torch, device):
    """DS-CGNR in float64 on the DIA operator, and LOBPCG for the
    LOBPCG_PAIRS smallest eigenpairs with the facade as T."""
    n = N_OPTIONS
    A64 = H.laplacian_3d_7pt(n, n, n, dtype=torch.float64, device=device)
    from hypre_tpu_torch.seq.dia import try_dia

    D = try_dia(A64)
    dinv = 1.0 / D.diagonal()
    b = torch.ones(D.n_rows, dtype=torch.float64, device=device)
    _, info = H.cgnr(D.mv, D.mv_t, b, M=lambda q: dinv * q, rtol=1e-8,
                     maxiter=2000, device=device)
    A = H.laplacian_3d_7pt(n, n, n, dtype=torch.float32, device=device)
    amg = H.BoomerAMG(max_coarse_size=OPTIONS_MAX_COARSE).setup(
        A, optimize=True, device=device)
    X0 = torch.from_numpy(np.random.default_rng(31).standard_normal(
        (A.n_rows, LOBPCG_PAIRS)).astype(np.float32)).to(device)
    op = amg.hierarchy.levels[0].A.mv
    lam, _, rn = H.lobpcg(H.block_op(op), X0, T=H.block_op(amg.precond()),
                          tol=1e-3, maxiter=40)
    return ({"cgnr_iterations": int(info.iterations),
             "cgnr_converged": bool(info.converged)},
            {"lobpcg_eigenvalues": lam.cpu().tolist(),
             "lobpcg_residuals": rn.cpu().tolist()})


def facade_options_card_vs_cpu(H, kernels, torch):
    """Phase 7: every facade option on the card and on the CPU."""
    for label, knobs, solve in OPTION_CASES:
        out = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            out[device] = option_run(H, torch, device, knobs, solve)
            out[device]["seconds"] = time.perf_counter() - t0
        log(json.dumps({"facade_option": label, "knobs": knobs,
                        "solve": solve, **out}))
        tag = f"option {label} at {N_OPTIONS}^3"
        require(out["cuda"]["converged"] and out["cpu"]["converged"],
                f"{tag}: a solve did not converge")
        require(out["cuda"]["banded"], f"{tag}: no banded operator")
        for key in ("setup_path", "levels", "c_points", "formats",
                    "iterations"):
            require(out["cuda"][key] == out["cpu"][key],
                    f"{tag}: {key} differ between card and CPU")
    cg, eig = {}, {}
    for device in ("cuda", "cpu"):
        cg[device], eig[device] = extra_option_runs(H, torch, device)
    log(json.dumps({"facade_option": "ds-cgnr float64", **cg}))
    log(json.dumps({"facade_option": "lobpcg", **eig}))
    require(cg["cuda"]["cgnr_converged"] and cg["cpu"]["cgnr_converged"],
            "DS-CGNR did not converge")
    require(cg["cuda"]["cgnr_iterations"] == cg["cpu"]["cgnr_iterations"],
            "DS-CGNR iterations differ between card and CPU")
    lc = np.array(eig["cuda"]["lobpcg_eigenvalues"])
    lh = np.array(eig["cpu"]["lobpcg_eigenvalues"])
    require(bool(np.all(np.abs(lc - lh) <= 1e-4 * np.abs(lh))),
            f"LOBPCG eigenvalues differ: {lc} vs {lh}")


def card_vs_cpu(H, kernels, torch):
    """The same path on the card and on the CPU (plain versions): same
    levels, same operator formats, same iteration count. 24^3 float64
    holds the setup and the DIA path (no operator is banded there, and
    float64 never is); 48^3 float32 also runs the banded kernels, which
    the CPU run replaces by their plain versions
    (``prefer_pallas=True``)."""
    from hypre_tpu_torch.seq import fastmv

    for n, dtype, rtol in ((N_PARITY, torch.float64, 1e-8),
                           (N_PARITY_BANDED, torch.float32, 1e-6)):
        out = {}
        for device in ("cuda", "cpu"):
            kernels.reset_launches()
            A = H.laplacian_3d_7pt(n, n, n, dtype=dtype, device=device)
            hier = H.setup_hierarchy(A, device=device, **SETUP_KW)
            fast = H.optimize_hierarchy(hier, gather_precision=0,
                                        prefer_pallas=True, device=device)
            b = torch.ones(A.n_rows, dtype=dtype, device=device)
            x, info = solve(H, fast, fast.levels[0].A, b, device, rtol)
            out[device] = {"levels": level_sizes(hier),
                           "formats": [[type(lv.A).__name__,
                                        type(lv.P).__name__]
                                       for lv in fast.levels],
                           "iterations": int(info.iterations),
                           "converged": bool(info.converged),
                           "relative_residual":
                               float(info.relative_residual),
                           "launches": dict(kernels.LAUNCHES)}
        tag = f"{n}^3 {str(dtype).split('.')[1]}"
        log(json.dumps({"card_vs_cpu": tag, **out}))
        require(out["cuda"]["converged"] and out["cpu"]["converged"],
                f"{tag} solve did not converge")
        require(out["cuda"]["levels"] == out["cpu"]["levels"],
                f"{tag}: level sizes differ between card and CPU")
        require(out["cuda"]["formats"] == out["cpu"]["formats"],
                f"{tag}: operator formats differ between card and CPU")
        require(out["cuda"]["iterations"] == out["cpu"]["iterations"],
                f"{tag}: iteration counts differ between card and CPU")
        require(not any(out["cpu"]["launches"].values()),
                f"{tag}: the CPU run launched a kernel")
        if dtype == torch.float32:
            require(isinstance(fast.levels[0].P, fastmv.BandedEll),
                    f"{tag}: level-0 P is not banded")
            for name in ("banded_spmv", "banded_spmv_t"):
                require(out["cuda"]["launches"][name] > 0,
                        f"{tag}: the card run never launched {name}")


def device_setup_card_vs_cpu(H, kernels, torch):
    """The device setup with one aggressive level on the card and on the
    CPU: same true level sizes, C-point counts, operator formats and PCG
    iteration count. 24^3 float64 stores P as ELL (a TransferDia's
    selections run the float32 gather kernel); 48^3 float32 stores the
    stencil level's P as a TransferDia."""
    for n, dtype, rtol, tdia in ((N_PARITY, torch.float64, 1e-8, False),
                                 (N_PARITY_BANDED, torch.float32, 1e-6,
                                  True)):
        out = {}
        for device in ("cuda", "cpu"):
            kernels.reset_launches()
            A = H.laplacian_3d_7pt(n, n, n, dtype=dtype, device=device)
            hier = H.setup_hierarchy_device(
                A, device=device, transfer_dia=tdia,
                **dict(BENCH_KW, max_coarse_size=100))
            fast = H.optimize_hierarchy(hier, gather_precision=0,
                                        prefer_pallas=True, specialize=True,
                                        device=device)
            b = padded_ones(fast, A.n_rows, torch, dtype, device)
            x, info = solve(H, fast, fast.levels[0].A, b, device, rtol)
            out[device] = {
                "true_levels": list(hier.n_level_true),
                "levels": level_sizes(hier),
                "c_points": [int((lv.cf == 1).sum()) for lv in hier.levels],
                "formats": describe_formats(fast),
                "iterations": int(info.iterations),
                "converged": bool(info.converged),
                "relative_residual": float(info.relative_residual),
                "launches": dict(kernels.LAUNCHES)}
        tag = f"device setup {n}^3 {str(dtype).split('.')[1]}"
        log(json.dumps({"card_vs_cpu": tag, **out}))
        require(out["cuda"]["converged"] and out["cpu"]["converged"],
                f"{tag} solve did not converge")
        for key in ("true_levels", "levels", "c_points", "formats",
                    "iterations"):
            require(out["cuda"][key] == out["cpu"][key],
                    f"{tag}: {key} differ between card and CPU")
        require(not any(out["cpu"]["launches"].values()),
                f"{tag}: the CPU run launched a kernel")
        require(out["cuda"]["launches"]["dia_spmv_static"] > 0,
                f"{tag}: the card run never launched dia_spmv_static")
        if tdia:
            require(out["cuda"]["formats"][0][1] == "TransferDia",
                    f"{tag}: level-0 P is not a TransferDia")
            require(out["cuda"]["launches"]["dia_rows"] > 0,
                    f"{tag}: the card run never launched dia_rows")


def device_setup_twice(H, torch):
    """Two device setups on the card at 48^3 hold the same bits in every
    tensor: no step sums or scatters in an order that varies."""
    hiers = []
    for _ in range(2):
        A = H.laplacian_3d_7pt(N_PARITY_BANDED, N_PARITY_BANDED,
                               N_PARITY_BANDED, dtype=torch.float32,
                               device="cuda")
        hiers.append(H.setup_hierarchy_device(
            A, transfer_dia=True, **dict(BENCH_KW, max_coarse_size=100)))
    first, second = (list(tensors_of(h, torch)) for h in hiers)
    require(len(first) == len(second) > 20,
            "two device setups hold different tensors")
    differ = [pa for (pa, a), (pb, b) in zip(first, second)
              if pa != pb or not torch.equal(a, b)]
    log(json.dumps({"device_setup_twice": f"{N_PARITY_BANDED}^3 float32",
                    "tensors": len(first), "differ": differ}))
    require(not differ, f"two device setups differ in {differ}")


# ---------------------------------------------------------------------------
# Phases 8-11: the problem generators, the IJ path with refinement, and the
# Hybrid, MGR and BlockTridiag solvers
# ---------------------------------------------------------------------------


def f64_of(A):
    """A float64 copy of an EllMatrix on its device: the true residual's
    operator."""
    return dataclasses.replace(A, vals=A.vals.double())


def manufactured_rhs(A, torch, seed: int):
    """b = A x* for x* uniform in [0, 1) from ``seed``, formed in float64
    (on the CPU, so that card and CPU runs get the same bits), rounded to
    A's type, on A's device. The 2-D problems at 1024^2 use it: with
    b = ones their solution grows to ~1e5 and the float32 floor of the
    true residual to ~1e-2, above TRUE_RESIDUAL_LIMIT."""
    x = torch.from_numpy(np.random.default_rng(seed).random(A.n_cols))
    return f64_of(A.to("cpu")).mv(x).to(A.dtype).to(A.device)


def uncounted(kernels, fn):
    """fn() with the launch counts restored afterwards: timing and
    profiling runs are not launches of the path."""
    saved = dict(kernels.LAUNCHES)
    try:
        return fn()
    finally:
        kernels.LAUNCHES.update(saved)


def device_kernels(torch, fn) -> int:
    """The CUDA kernels the card ran in one call of fn (torch.profiler):
    every op's launches, the ported kernels' included."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def hold_dia(M, label, kernels, torch, held):
    """One launch of M's DIA kernel (the one its ``mv`` takes) against the
    plain version on the same x: the bits must agree. The counts are
    restored, so the comparison does not count as a launch of the path."""
    from hypre_tpu_torch.seq import dia as dia_mod

    if not isinstance(M, dia_mod.DiaMatrix):
        return
    saved = dict(kernels.LAUNCHES)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        M.n_cols)).to(M.device, M.dtype)
    got = M.mv(x)
    kernels.LAUNCHES.update(saved)
    want = dia_mod.dia_spmv_plain(M.dvals, M.offsets, x, M.margin)
    ab = float((got - want).abs().max())
    kernel = ("dia_rows" if M.r_ptr is not None else "dia_spmv"
              if M.offsets_static is None else "dia_spmv_static")
    held.append({"kernel": kernel, "operator": label,
                 "shape": [M.D, M.n_rows], "max_abs_err": ab})
    require(ab == 0.0, f"{label}: the DIA kernel differs from its plain "
            f"version by {ab}")


def timed(kernels, torch, fn):
    """fn() cold, then warm; returns the warm call's (result, host ms after
    a synchronize, launches)."""
    fn()
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    return out, warm_ms, {k: kernels.LAUNCHES[k] - before[k]
                          for k in kernels.LAUNCHES}


def first_call(kernels, torch, fn):
    """``timed`` for a long solve: the first call only, its host ms after
    a synchronize and its launches."""
    before = dict(kernels.LAUNCHES)
    out, s = synced(torch, fn)
    return out, s * 1e3, {k: kernels.LAUNCHES[k] - before[k]
                          for k in kernels.LAUNCHES}


def check_solve(what, torch, x, info, A64, b, warm_ms, grew, need=(),
                extra=None):
    """Log one solve and require convergence, a finite x, a float64 true
    residual under TRUE_RESIDUAL_LIMIT and a launch of each kernel in
    ``need``."""
    it = int(info.iterations)
    rec = {"solve": what, "iterations": it,
           "converged": bool(info.converged),
           "relative_residual": float(info.relative_residual),
           "true_relative_residual": true_rel(A64, x, b),
           "warm_ms": warm_ms, "launches": grew,
           "launches_per_iteration": {k: v / max(it, 1)
                                      for k, v in grew.items() if v}}
    rec.update(extra or {})
    log(json.dumps(rec))
    require(rec["converged"], f"{what} did not converge")
    require(bool(torch.isfinite(x).all()), f"{what}: non-finite x")
    require(rec["true_relative_residual"] <= TRUE_RESIDUAL_LIMIT,
            f"{what}: true relative residual "
            f"{rec['true_relative_residual']} > {TRUE_RESIDUAL_LIMIT}")
    for k in need:
        require(grew[k] > 0, f"{what} never launched {k}")
    return rec


def facade_setup(H, torch, A, what, **knobs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    amg = H.BoomerAMG(max_coarse_size=1500, **knobs).setup(A)
    torch.cuda.synchronize()
    log(json.dumps({"setup": what, "setup_s": time.perf_counter() - t0,
                    "setup_path": amg.setup_path,
                    "levels": level_sizes(amg.hierarchy),
                    "formats": describe_formats(amg.hierarchy)}))
    return amg


def other_problems_phase(H, kernels, torch, held):
    """Phase 8: the reference's other 3-D problems at 128^3, f32, b = ones,
    the facade at max_coarse_size=1500: the 27-pt Laplacian under PCG
    with the dynamic and with the static DIA kernel (D = 27), difconv
    (cx = 1) under GMRES(30), vardifconv under PCG."""
    import copy

    kernels.reset_launches()
    n = N_MAIN
    b = torch.ones(n ** 3, dtype=torch.float32, device="cuda")
    A = H.laplacian_3d_27pt(n, n, n, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    amg = H.BoomerAMG(max_coarse_size=1500).setup(A, optimize=False)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(json.dumps({"setup": "27-pt", "setup_s": setup_s,
                    "levels": level_sizes(amg.hierarchy)}))
    A64 = f64_of(A)
    its = {}
    for specialize in (False, True):
        # the facade's own optimize step, once per DIA kernel
        t0 = time.perf_counter()
        facade = copy.copy(amg)
        facade.specialize = specialize
        facade.hierarchy = H.optimize_hierarchy(
            amg.hierarchy, prefer_pallas=True, gather_precision=0,
            specialize=specialize, device="cuda")
        torch.cuda.synchronize()
        optimize_s = time.perf_counter() - t0
        fine = facade.hierarchy.levels[0].A
        require(isinstance(fine, H.DiaMatrix) and fine.D == 27,
                "the 27-pt level-0 A is not a D = 27 DiaMatrix")
        hold_dia(fine, "27-pt level 0", kernels, torch, held)
        (x, info), warm_ms, grew = timed(kernels, torch, lambda: H.pcg(
            fine.mv, b, M=facade.precond(), rtol=FACADE_RTOL, maxiter=100))
        kern = "dia_spmv_static" if specialize else "dia_spmv"
        rec = check_solve(
            f"27-pt pcg {'specialized' if specialize else 'dynamic'}",
            torch, x, info, A64, b, warm_ms, grew,
            need=(kern, "banded_spmv", "banded_spmv_t"),
            extra={"optimize_s": optimize_s,
                   "formats": describe_formats(facade.hierarchy)})
        its[specialize] = rec["iterations"]
    require(its[False] == its[True], f"27-pt: dynamic ({its[False]}) and "
            f"specialized ({its[True]}) PCG took different iterations")
    del amg, facade, A, A64, fine
    torch.cuda.empty_cache()

    # vardifconv's solution grows to ~1e2 in the 0.01 corner cubes with
    # b = ones and its float32 true residual floors near 2e-2 (port on the
    # CPU at 48^3), so it solves for a manufactured x*
    for label, make, solver, rhs in (
            ("difconv cx=1", lambda: H.difconv_3d_7pt(
                n, n, n, cx=1.0, dtype=torch.float32, device="cuda"),
             "gmres", lambda A: b),
            ("vardifconv", lambda: H.vardifconv_3d(
                n, n, n, dtype=torch.float32, device="cuda"), "pcg",
             lambda A: manufactured_rhs(A, torch, 10))):
        A = make()
        amg = facade_setup(H, torch, A, label)
        fine = amg.hierarchy.levels[0].A
        hold_dia(fine, f"{label} level 0", kernels, torch, held)
        bp = rhs(A)
        kw = dict(GMRES_KW) if solver == "gmres" else {}
        (x, info), warm_ms, grew = timed(kernels, torch, lambda: getattr(
            H, solver)(fine.mv, bp, M=amg.precond(), rtol=FACADE_RTOL,
                       maxiter=100, **kw))
        check_solve(f"{label} {solver}", torch, x, info, f64_of(A), bp,
                    warm_ms, grew, need=("dia_spmv",))
        del amg, fine, A
    return dict(kernels.LAUNCHES)


def ex5_rows(n: int):
    """The 7-pt Laplacian on an n^3 grid as ex5's row loop stages it: row
    by row, the diagonal first, then the neighbours that exist (x, y, z;
    minus before plus). Returns COO arrays in that order."""
    N = n ** 3
    idx = np.arange(N)
    coords = (idx // (n * n), (idx // n) % n, idx % n)
    strides = (n * n, n, 1)
    cols = [idx]
    vals = [np.full(N, 6.0)]
    for d in range(3):
        for sgn in (-1, 1):
            ok = (coords[d] + sgn >= 0) & (coords[d] + sgn < n)
            cols.append(np.where(ok, idx + sgn * strides[d], -1))
            vals.append(np.full(N, -1.0))
    cols, vals = np.stack(cols, axis=1), np.stack(vals, axis=1)
    keep = cols >= 0
    return (np.repeat(idx, 7).reshape(N, 7)[keep], cols[keep], vals[keep])


def ij_assemble(H, n: int, device, dtype):
    """IJMatrix.set_values with every row staged at once, assemble,
    GetObject on ``device``; the rhs through IJVector."""
    rows, cols, vals = ex5_rows(n)
    ij = H.IJMatrix(n ** 3, n ** 3).set_values(rows, cols, vals).assemble()
    b = H.IJVector(n ** 3).set_values(np.arange(n ** 3), np.ones(n ** 3)) \
        .assemble().get_object(dtype=dtype, device=device)
    return ij, ij.get_object(dtype=dtype, device=device), b


def ij_phase(H, kernels, torch, held):
    """Phase 9: hypre's IJ path at 128^3 f32 (ex5): assemble, the CSR of
    laplacian_3d_7pt bit for bit, BoomerAMG-PCG; refine_solve (f64
    residual on the card, the facade's PCG as the f32 solve) and the
    device refiner with two-float residuals, both to a true residual of
    1e-6; the FEM stiffness problem through IJ; file round trips."""
    import shutil
    import tempfile

    from hypre_tpu_torch import io as tio
    from hypre_tpu_torch.seq.dia import try_dia
    from hypre_tpu_torch.seq.ell import csr_to_ell, ell_to_csr
    from hypre_tpu_torch.seq.twofloat import dia_residual_2f

    kernels.reset_launches()
    n = N_MAIN
    t0 = time.perf_counter()
    ij, A, b = ij_assemble(H, n, "cuda", torch.float32)
    torch.cuda.synchronize()
    assemble_s = time.perf_counter() - t0
    got = ij.get_csr()
    want = ell_to_csr(H.laplacian_3d_7pt(n, n, n, dtype=torch.float32,
                                         device="cuda"))
    same = (np.array_equal(got.indptr, want.indptr)
            and np.array_equal(got.indices, want.indices)
            and np.array_equal(got.data, want.data.astype(np.float64)))
    log(json.dumps({"ij": f"{n}^3 7-pt", "assemble_s": assemble_s,
                    "nnz": got.nnz, "csr_equals_laplacian_3d_7pt": same}))
    require(same, "the IJ-assembled CSR is not laplacian_3d_7pt's")
    del want
    A64 = f64_of(A)
    amg = facade_setup(H, torch, A, "IJ 7-pt")
    fine = amg.hierarchy.levels[0].A
    hold_dia(fine, "IJ 7-pt level 0", kernels, torch, held)
    (x, info), warm_ms, grew = timed(kernels, torch, lambda: H.pcg(
        fine.mv, b, M=amg.precond(), rtol=FACADE_RTOL, maxiter=100))
    check_solve("IJ 7-pt pcg", torch, x, info, A64, b, warm_ms, grew,
                need=("banded_spmv", "banded_spmv_t"))

    def solve_f32(r):
        return H.pcg(fine.mv, r, M=amg.precond(), rtol=FACADE_RTOL,
                     maxiter=100)

    (xr, rel, inner), warm_ms, grew = timed(
        kernels, torch, lambda: H.refine_solve(A, solve_f32, b, rtol=1e-6))
    true_r = true_rel(A64, xr, b)
    log(json.dumps({"solve": "refine_solve", "true_relative_residual": rel,
                    "recomputed": true_r, "inner_iterations": inner,
                    "x_dtype": str(xr.dtype), "warm_ms": warm_ms,
                    "launches": grew}))
    require(rel <= 1e-6 and true_r <= 1e-6,
            f"refine_solve reached {rel} ({true_r}), not 1e-6")

    D = try_dia(A)
    require(D is not None and D.D == 7, "the IJ operator is not D = 7 DIA")
    refined = {}
    for two_f in (True, False):
        inner_its = []

        def inner(Af, r, _its=inner_its):
            d, inf = H.pcg(Af.mv, r, M=amg.precond(), rtol=1e-4, maxiter=30)
            _its.append(int(inf.iterations))
            return d, inf

        refine = H.make_device_refiner([inner] * 3, residual_2f=two_f)
        (x_hi, x_lo, _), warm_ms, grew = timed(
            kernels, torch, lambda: refine(D, b))
        x64 = x_hi.double() + x_lo.double()
        refined[two_f] = true_rel(A64, x64, b)
        log(json.dumps({"solve": "device refiner", "residual_2f": two_f,
                        "true_relative_residual": refined[two_f],
                        "inner_iterations": inner_its[-3:],
                        "warm_ms": warm_ms, "launches": grew}))
    require(refined[True] <= 1e-6, f"the two-float refiner reached "
            f"{refined[True]}, not 1e-6")
    require(refined[True] < refined[False], "the two-float refiner is not "
            "below the plain one")
    hold_dia(D, "IJ 7-pt DiaMatrix (refiners)", kernels, torch, held)
    # one two-float residual: its device kernels, counted by the profiler
    log(json.dumps({
        "dia_residual_2f": f"D = 7, n = {n ** 3}",
        "device_kernels": uncounted(kernels, lambda: device_kernels(
            torch, lambda: dia_residual_2f(D, b, x_hi, x_lo))),
        "ms": uncounted(kernels, lambda: time_ms(
            lambda: dia_residual_2f(D, b, x_hi, x_lo), torch, warmup=2,
            reps=10)),
        "plain_f32_residual_ms": uncounted(kernels, lambda: time_ms(
            lambda: (b - D.mv(x_hi)) - D.mv(x_lo), torch, warmup=2,
            reps=10))}))
    del amg, fine, A, A64, D, x, xr, x_hi, x_lo
    torch.cuda.empty_cache()

    # the FEM stiffness problem through the port's IJ
    t0 = time.perf_counter()
    ij, _ = H.fem_stiffness_2d(m=N_2D)
    Af = ij.get_object(dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    log(json.dumps({"fem_stiffness_2d": N_2D, "rows": Af.n_rows,
                    "nnz": ij.get_csr().nnz,
                    "generate_and_assemble_s": time.perf_counter() - t0}))
    amg = facade_setup(H, torch, Af, "fem_stiffness_2d")
    fine = amg.hierarchy.levels[0].A
    bf = manufactured_rhs(Af, torch, 11)
    (x, info), warm_ms, grew = timed(kernels, torch, lambda: H.pcg(
        fine.mv, bf, M=amg.precond(), rtol=FACADE_RTOL, maxiter=100))
    check_solve("fem_stiffness_2d pcg", torch, x, info, f64_of(Af), bf,
                warm_ms, grew)
    del amg, fine, Af, ij

    # card -> file -> card at 32^3, exact
    m = 32
    A = H.laplacian_3d_7pt(m, m, m, dtype=torch.float32, device="cuda")
    ref = ell_to_csr(A)
    where = tempfile.mkdtemp(prefix=".io_roundtrip_", dir=HERE)
    try:
        for fmt in ("mtx", "ij", "npz"):
            path = os.path.join(where, f"a.{fmt}")
            if fmt == "mtx":
                tio.write_matrix_market(path, A)
            elif fmt == "ij":
                tio.write_ij_ascii(path, A, base=1)
            else:
                tio.save_matrix(path, A)
            back = (tio.load_matrix(path, device="cuda") if fmt == "npz"
                    else csr_to_ell(tio.read_any_matrix(path),
                                    dtype=torch.float32, device="cuda"))
            csr = ell_to_csr(back)
            ok = (np.array_equal(csr.indptr, ref.indptr)
                  and np.array_equal(csr.indices, ref.indices)
                  and np.array_equal(csr.data, ref.data))
            log(json.dumps({"roundtrip": fmt, "grid": f"{m}^3",
                            "bytes": os.path.getsize(path), "exact": ok}))
            require(ok, f"the {fmt} round trip is not exact")
    finally:
        shutil.rmtree(where, ignore_errors=True)
    return dict(kernels.LAUNCHES)


def block_system(H, torch, ng: int, device):
    """tests/test_mgr_ams.py's 2x2 block system [[A, B], [B^T, 4 I]] at
    m = ng^2 per block, assembled sparse: A the 5-pt Laplacian, B 0.1 on
    the diagonal and 0.05 above it.

    A is scaled by ((ng + 1) / 11)^2, 1 at the test's ng = 10, so that its
    smallest eigenvalue stays the test's (8 sin^2(pi / 22) = 0.16). The
    Schur complement onto the first block, A - B B^T / 4, is SPD only
    while that eigenvalue exceeds |B B^T / 4| ~ 5.6e-3: unscaled, the
    system is indefinite beyond ng = 58, and at ng = 512 BoomerAMG-PCG on
    that Schur complement stalls at 1.3e-4 after 60 iterations where it
    takes 5 on the plain Laplacian (port on the CPU, f32)."""
    from hypre_tpu_torch.seq.csr import HostCSR
    from hypre_tpu_torch.seq.ell import csr_to_ell

    m = ng * ng
    scale = ((ng + 1) / 11.0) ** 2
    idx = np.arange(m)
    i, j = idx // ng, idx % ng
    rows, cols, vals = [idx, m + idx], [idx, m + idx], [
        np.full(m, 4.0 * scale), np.full(m, 4.0)]
    for ok, sh in ((i > 0, -ng), (i < ng - 1, ng), (j > 0, -1),
                   (j < ng - 1, 1)):
        rows.append(idx[ok])
        cols.append(idx[ok] + sh)
        vals.append(np.full(int(ok.sum()), -scale))
    for r, c, v in ((idx, m + idx, 0.1), (idx[:-1], m + idx[1:], 0.05),
                    (m + idx, idx, 0.1), (m + idx[1:], idx[:-1], 0.05)):
        rows.append(r)
        cols.append(c)
        vals.append(np.full(r.size, v))
    csr = HostCSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                           np.concatenate(vals), (2 * m, 2 * m))
    return csr_to_ell(csr, dtype=torch.float32, device=device), m


def reduction_runs(H, torch, device, n3d: int, ng: int, held=None,
                   kernels=None):
    """Hybrid at n3d^3 (7-pt, b = ones, cf_tol 0.9), MGR under
    FlexGMRES(30) on the block system at ng^2 blocks, BlockTridiag under
    FlexGMRES(30) on elasticity_2d(ng, ng) with index set 1 = the u dofs.
    Returns one comparable record per solver (and, on the card, logs and
    checks each solve).

    FlexGMRES, not GMRES: the port's GMRES (the reference's) is
    left-preconditioned and tests ||M (b - A x)||, which in float32 floors
    far above rtol 1e-6 on these systems (on the card at n = 2 097 152:
    1.3e-2 after 300 iterations, with the true residual at 1.0e-4; on the
    CPU at 128^2 blocks: 2.1e-6 after 60), while FlexGMRES applies M on
    the right, as hypre's GMRES does, and tests b - A x itself (6 and 7
    iterations at 128^2)."""
    from hypre_tpu_torch.seq.fastmv import optimize_operator

    opt = True  # the CPU runs the card's formats by their plain versions
    on_card = device == "cuda"
    out = {}
    cb = kernels is not None and on_card

    class CountingAMG(H.BoomerAMG):
        """The facade, noting the launch counts when its setup ends: the
        launches after that are the AMG phase's."""

        def setup(self, *args, **kw):
            done = super().setup(*args, **kw)
            if cb:
                torch.cuda.synchronize()
                self.launches_at_setup = dict(kernels.LAUNCHES)
            return done

    A = H.laplacian_3d_7pt(n3d, n3d, n3d, dtype=torch.float32, device=device)
    b = torch.ones(A.n_rows, dtype=torch.float32, device=device)
    amg = CountingAMG()
    hy = H.HybridSolver(amg=amg).setup(A, optimize=opt, device=device)
    for _ in range(2 if cb else 1):  # cold, then warm on the card
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = hy.solve(b, rtol=FACADE_RTOL)
        if on_card:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    out["hybrid"] = {"dscg_iterations": hy.dscg_iterations,
                     "amg_iterations": hy.amg_iterations,
                     "levels": level_sizes(amg.hierarchy),
                     "formats": describe_formats(amg.hierarchy)}
    if cb:
        grew = {k: kernels.LAUNCHES[k] - amg.launches_at_setup[k]
                for k in kernels.LAUNCHES}
        check_solve(f"hybrid {n3d}^3", torch, x, info, f64_of(A), b,
                    seconds * 1e3, grew,
                    need=("dia_spmv", "banded_spmv", "banded_spmv_t"),
                    extra=dict(out["hybrid"], note="warm_ms: the whole "
                               "warm call, its AMG setup included; "
                               "launches: its AMG phase"))
        require(hy.dscg_iterations > 0 and hy.amg_iterations > 0,
                "Hybrid did not run both phases")
    del hy, amg, A

    A, m = block_system(H, torch, ng, device)
    # C points: the Laplacian block (see ROADMAP.md: with the second block
    # as C, GMRES(30) does not converge at 32^2)
    t0 = time.perf_counter()
    mgr = H.MGR(num_relax_sweeps=2).setup(A, [np.arange(m)], optimize=opt,
                                          device=device)
    setup_s = time.perf_counter() - t0
    op = optimize_operator(A) if opt else A
    bb = manufactured_rhs(A, torch, 12)
    out["mgr"] = {"setup_s": setup_s, "levels": [lv.A.n_rows for lv in
                                                 mgr.levels],
                  "coarse_levels": level_sizes(mgr.coarse_amg.hierarchy),
                  "formats": describe_formats(mgr.coarse_amg.hierarchy)}
    if cb:
        hold_dia(op, "MGR block system", kernels, torch, held)
        (x, info), warm_ms, grew = timed(kernels, torch, lambda: H.flexgmres(
            op.mv, bb, M=mgr.precond(), rtol=FACADE_RTOL, maxiter=200,
            **GMRES_KW))
        check_solve(f"mgr flexgmres n={2 * m}", torch, x, info, f64_of(A),
                    bb, warm_ms, grew, need=("dia_spmv",), extra=out["mgr"])
    else:
        x, info = H.flexgmres(op.mv, bb, M=mgr.precond(), rtol=FACADE_RTOL,
                              maxiter=200, device=device, **GMRES_KW)
    out["mgr"]["iterations"] = int(info.iterations)
    del mgr, A, op

    E = H.elasticity_2d(ng, ng, dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    bt = H.BlockTridiag().setup(E, np.arange(0, E.n_rows, 2), optimize=opt,
                                device=device)
    setup_s = time.perf_counter() - t0
    op = optimize_operator(E) if opt else E
    bb = manufactured_rhs(E, torch, 13)
    out["block_tridiag"] = {
        "setup_s": setup_s,
        "levels": [level_sizes(B.hierarchy) for B in (bt.B11, bt.B22)],
        "formats": [describe_formats(B.hierarchy) for B in (bt.B11, bt.B22)]}
    if cb:
        hold_dia(op, "elasticity_2d", kernels, torch, held)
        (x, info), warm_ms, grew = timed(kernels, torch, lambda: H.flexgmres(
            op.mv, bb, M=bt.precond(), rtol=FACADE_RTOL, maxiter=200,
            **GMRES_KW))
        check_solve(f"block_tridiag flexgmres n={E.n_rows}", torch, x, info,
                    f64_of(E), bb, warm_ms, grew,
                    need=("dia_spmv", "banded_spmv"),
                    extra=out["block_tridiag"])
    else:
        x, info = H.flexgmres(op.mv, bb, M=bt.precond(), rtol=FACADE_RTOL,
                              maxiter=200, device=device, **GMRES_KW)
    out["block_tridiag"]["iterations"] = int(info.iterations)
    for rec in out.values():
        rec.pop("setup_s", None)
    return out


def reduction_phase(H, kernels, torch, held):
    """Phase 10: Hybrid at 128^3, MGR and BlockTridiag at n = 2 097 152
    (the 2-D ones for a manufactured solution)."""
    kernels.reset_launches()
    reduction_runs(H, torch, "cuda", N_MAIN, N_2D, held, kernels)
    return dict(kernels.LAUNCHES)


def small_card_vs_cpu(H, kernels, torch):
    """Phase 11: the new paths at small sizes on the card and on the CPU
    (plain versions), f32: each new generator gives the same ELL; the
    32^3 IJ path with BoomerAMG-PCG and refine_solve, Hybrid at 32^3, MGR
    and BlockTridiag at 64^2 blocks give the same levels, C points,
    formats and iterations."""
    from hypre_tpu_torch.seq.ell import ell_to_csr

    gens = [("laplacian_1d", (1000,), {}),
            ("laplacian_2d_9pt", (40, 41), {}),
            ("laplacian_3d_27pt", (20, 21, 22), {}),
            ("difconv_3d_7pt", (20, 21, 22), dict(cx=1.0, cy=0.5)),
            ("rotated_anisotropy_2d", (40, 41), {}),
            ("elasticity_2d", (N_SMALL_2D, N_SMALL_2D), {}),
            ("vardifconv_3d", (24, 24, 24), {})]
    for name, args, kw in gens:
        A, B = (getattr(H, name)(*args, dtype=torch.float32, device=dev,
                                 **kw) for dev in ("cuda", "cpu"))
        same = (torch.equal(A.vals.cpu(), B.vals)
                and torch.equal(A.cols.cpu(), B.cols)
                and A.shifts == B.shifts)
        log(json.dumps({"card_vs_cpu": f"generator {name}{args}",
                        "same": same}))
        require(same, f"{name}: card and CPU assemble different matrices")
    for label, make in (
            ("fem_stiffness_2d(32)", lambda: H.fem_stiffness_2d(m=32)[0]),
            ("circuit_laplacian(4000)", lambda: H.circuit_laplacian(4000))):
        csr = make().get_csr()
        A = make().get_object(dtype=torch.float32, device="cuda")
        back = ell_to_csr(A)
        same = (np.array_equal(back.indices, csr.indices)
                and np.array_equal(back.data, csr.data.astype(np.float32)))
        log(json.dumps({"card_vs_cpu": label, "same": same}))
        require(same, f"{label}: the card's ELL is not the host CSR")

    out = {}
    for device in ("cuda", "cpu"):
        _, A, b = ij_assemble(H, N_SMALL, device, torch.float32)
        amg = H.BoomerAMG(max_coarse_size=OPTIONS_MAX_COARSE).setup(
            A, optimize=True, device=device)
        fine = amg.hierarchy.levels[0].A
        x, info = H.pcg(fine.mv, b, M=amg.precond(), rtol=FACADE_RTOL,
                        maxiter=100, device=device)

        # the inner solves stop at 1e-4, away from the f32 floor, where
        # card and CPU sums could part by an iteration (at rtol 1e-6 the
        # 32^3 inner totals were 12 on the card and 13 on the CPU)
        def solve_f32(r):
            return H.pcg(fine.mv, r, M=amg.precond(), rtol=1e-4,
                         maxiter=100, device=device)

        _, rel, inner = H.refine_solve(A, solve_f32, b, rtol=1e-6)
        rec = {"ij": {"levels": level_sizes(amg.hierarchy),
                      "c_points": [int((lv.cf == 1).sum())
                                   for lv in amg.hierarchy.levels],
                      "formats": describe_formats(amg.hierarchy),
                      "iterations": int(info.iterations),
                      "refine_inner_iterations": inner,
                      "refine_reached_1e-6": rel <= 1e-6}}
        rec.update(reduction_runs(H, torch, device, N_SMALL, N_SMALL_2D))
        out[device] = rec
    for key in out["cuda"]:
        log(json.dumps({"card_vs_cpu": key, "cuda": out["cuda"][key],
                        "cpu": out["cpu"][key]}))
        require(out["cuda"][key] == out["cpu"][key],
                f"{key}: card and CPU differ")
    require(out["cuda"]["ij"]["refine_reached_1e-6"],
            "refine_solve at 32^3 did not reach 1e-6")


# ---------------------------------------------------------------------------
# Phase 12: the rest of amg/ at full width
# ---------------------------------------------------------------------------


def rigid_body_modes(nx: int, ny: int, torch, device):
    """The three rigid-body modes of elasticity_2d(nx, ny), node-major
    (node (i, j) owns unknowns 2 (i ny + j) + {0, 1}): u- and
    v-translation, and the rotation (-y, x) at x = i/nx, y = j/ny. The
    near-nullspace MLI's SetNullSpace gives smoothed aggregation."""
    i, j = (g.ravel() for g in np.meshgrid(np.arange(nx), np.arange(ny),
                                           indexing="ij"))
    B = np.zeros((2 * nx * ny, 3))
    B[0::2, 0] = 1.0
    B[1::2, 1] = 1.0
    B[0::2, 2] = -j / ny
    B[1::2, 2] = i / nx
    return torch.from_numpy(B).to(device=device, dtype=torch.float32)


def aux_levels(amg) -> dict:
    """Level sizes (the aggregate or C-point counts are the next level's
    size) and formats of one facade hierarchy."""
    return {"levels": level_sizes(amg.hierarchy),
            "formats": describe_formats(amg.hierarchy)}


def ams_levels(ams) -> dict:
    """The inner facades' levels and formats (ADS's inner AMS has no
    gradient facade)."""
    return {"G": None if ams.B_G is None else aux_levels(ams.B_G),
            "Pi": [aux_levels(B) for B in ams.B_Pi]}


def aux_runs(H, torch, device, n3d: int, n2d: int, fem_m: int, nhex: int,
             ads_hex: int, ame_hex: int, held=None, kernels=None) -> dict:
    """Every solver of the slice on ``device``, rtol AUX_RTOL, f32 but for
    two f64 paths (below): SA and GSMG on the 7-pt n3d^3 (b = ones), SA
    with the rigid-body modes and BlockAMG on elasticity_2d(n2d, n2d),
    BlockAMG on fem_block_2d(fem_m), AMS on the curl-curl and ADS on the
    div-div problem of the nhex^3 and ads_hex^3 hex complexes, AME on the
    curl-curl problem at ame_hex^3. The 2-D, FEM and hex problems solve for a
    manufactured x*. Returns one comparable record per path; with
    ``kernels`` on the card it also times, logs and checks each solve
    (check_solve) and requires a launch of a ported kernel wherever a
    facade built kernel formats.

    fem_block_2d runs GMRES at the small size, as the reference's test
    does, and FlexGMRES(30) at full width: the left-preconditioned GMRES
    floors in f32 there (``reduction_runs``)."""
    from hypre_tpu_torch.amg.ads import ADS
    from hypre_tpu_torch.amg.ame import AME
    from hypre_tpu_torch.amg.ams import AMS, f64
    from hypre_tpu_torch.amg.block_amg import BlockAMG
    from hypre_tpu_torch.amg.gsmg import GSMG
    from hypre_tpu_torch.problems import maxwell
    from hypre_tpu_torch.seq.bsr import ell_to_bsr
    from hypre_tpu_torch.seq.fastmv import optimize_operator

    on_card = device == "cuda"
    cb = on_card and kernels is not None
    mcs = 1500 if cb else OPTIONS_MAX_COARSE
    f32 = torch.float32
    out = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def setup(make):
        sync()
        t0 = time.perf_counter()
        obj = make()
        sync()
        return obj, time.perf_counter() - t0

    def solve(key, label, A, op, b, M, rec, solver="pcg", need=True,
              once=False):
        kw = dict(GMRES_KW) if "gmres" in solver else {}

        def run():
            return getattr(H, solver)(op.mv, b, M=M, rtol=AUX_RTOL,
                                      maxiter=AUX_MAXITER, device=device,
                                      **kw)

        if cb:
            hold_dia(op, label, kernels, torch, held)
            if once:  # a long solve: its first call only
                before = dict(kernels.LAUNCHES)
                (x, info), s = setup(run)
                ms = s * 1e3
                grew = {k: kernels.LAUNCHES[k] - before[k]
                        for k in kernels.LAUNCHES}
                rec = dict(rec, note="warm_ms: the first call")
            else:
                (x, info), ms, grew = timed(kernels, torch, run)
            check_solve(label, torch, x, info, f64_of(A), b, ms, grew,
                        extra=rec)
            if need:
                require(any(grew[k] > 0 for k in AUX_KERNELS),
                        f"{label} launched none of {AUX_KERNELS}")
        else:
            x, info = run()
            require(bool(info.converged), f"{label} on {device} did not "
                    "converge")
        rec["iterations"] = int(info.iterations)
        out[key] = rec

    def done(key, t0):
        if on_card:
            torch.cuda.empty_cache()
        if cb:
            log(json.dumps({"aux_path": key,
                            "seconds": time.perf_counter() - t0}))

    # smoothed aggregation and GSMG on the 7-pt Laplacian
    A = H.laplacian_3d_7pt(n3d, n3d, n3d, dtype=f32, device=device)
    b = torch.ones(A.n_rows, dtype=f32, device=device)
    for key, cls in (("sa", H.SmoothedAggAMG), ("gsmg", GSMG)):
        t0 = time.perf_counter()
        amg, s = setup(lambda: cls(max_coarse_size=mcs).setup(
            A, optimize=True, device=device))
        rec = dict(aux_levels(amg), setup_s=s)
        fine = amg.hierarchy.levels[0].A
        solve(key, f"{key} pcg {n3d}^3", A, fine, b, amg.precond(), rec)
        del amg, fine
        done(key, t0)
    del A, b

    # smoothed aggregation with the rigid-body modes, and nodal block AMG,
    # on elasticity
    t0 = time.perf_counter()
    E = H.elasticity_2d(n2d, n2d, dtype=f32, device=device)
    op = optimize_operator(E)
    bE = manufactured_rhs(E, torch, 14)
    amg, s = setup(lambda: H.SmoothedAggAMG(
        max_coarse_size=mcs, null_space=rigid_body_modes(
            n2d, n2d, torch, device)).setup(E, optimize=True, device=device))
    solve("sa_elasticity", f"sa rigid-body pcg elasticity {n2d}^2", E, op,
          bE, amg.precond(), dict(aux_levels(amg), setup_s=s))
    del amg
    done("sa_elasticity", t0)

    del E, op, bE
    # in float64: in float32 the f32 Galerkin products of the nodal
    # hierarchy (the reference's too) leave PCG at 6.4e-4 after 200 and
    # 6.8e-4 after 1000 iterations at 1024^2 on the H100 (61 against 32
    # iterations at 512^2, port on the CPU)
    t0 = time.perf_counter()
    E = H.elasticity_2d(n2d, n2d, dtype=torch.float64, device=device)
    bam, s = setup(lambda: BlockAMG().setup(ell_to_bsr(E, 2),
                                            device=device))
    rec = {"levels": [lv.A.n_rows for lv in bam.levels]
           + [bam.coarse_inv.shape[0]], "setup_s": s, "dtype": "float64"}
    solve("block_amg", f"block_amg pcg elasticity {n2d}^2 f64", E,
          optimize_operator(E), manufactured_rhs(E, torch, 14),
          bam.precond(), rec, need=False)
    del bam, E
    done("block_amg", t0)

    t0 = time.perf_counter()
    F = H.fem_block_2d(m=fem_m)[0].get_object(dtype=f32, device=device)
    gen_s = time.perf_counter() - t0
    bam, s = setup(lambda: BlockAMG().setup(ell_to_bsr(F, 2), device=device))
    rec = {"levels": [lv.A.n_rows for lv in bam.levels]
           + [bam.coarse_inv.shape[0]], "setup_s": s, "mesh_s": gen_s}
    solve("block_amg_fem", f"block_amg fem_block_2d({fem_m})", F,
          optimize_operator(F), manufactured_rhs(F, torch, 16),
          bam.precond(), rec, solver="flexgmres" if cb else "gmres",
          need=False)
    del bam, F
    done("block_amg_fem", t0)

    # the auxiliary-space solvers on the hex complex
    t0 = time.perf_counter()
    A, G, xyz = maxwell.curl_curl_3d(nhex, dtype=f32, device=device)
    ams, s = setup(lambda: AMS().setup(A, G, xyz, device=device,
                                       optimize=True))
    solve("ams", f"ams pcg curl-curl {nhex}^3", A, optimize_operator(A),
          manufactured_rhs(A, torch, 17), ams.precond(),
          dict(ams_levels(ams), setup_s=s, edges=A.n_rows))
    del ams, A, G
    done("ams", t0)

    # ADS in float64: in float32 its cycle (f32 hierarchies of operators
    # whose lognormal coefficients span ~1e9 at 88^3) is too inexact for
    # CG: 8.3e-5 after 1000 iterations at 88^3 on the H100; 219 against
    # 106 iterations at 24^3, and f64 PCG with the f32 cycle 4.9e-6 after
    # 1000 (port on the CPU). The kernel formats are float32, so this
    # path runs PyTorch ELL products.
    t0 = time.perf_counter()
    A, C, G, xyz = maxwell.div_div_3d(ads_hex, dtype=torch.float64,
                                      device=device)
    ads, s = setup(lambda: ADS().setup(A, C, G, xyz, device=device,
                                       optimize=True))
    rec = {"ams": ams_levels(ads.ams),
           "Pi": [aux_levels(B) for B in ads.B_Pi], "setup_s": s,
           "faces": A.n_rows, "dtype": "float64"}
    if cb and ads_hex == N_ADS:
        rec["size"] = ADS_CUT
    solve("ads", f"ads pcg div-div {ads_hex}^3 f64", A, optimize_operator(A),
          manufactured_rhs(A, torch, 18), ads.precond(), rec, need=False,
          once=True)
    del ads, A, C, G
    done("ads", t0)

    t0 = time.perf_counter()
    A, G, xyz = maxwell.curl_curl_3d(ame_hex, dtype=f32, device=device)
    ame, s = setup(lambda: AME(block_size=AME_BLOCK, tol=AME_TOL).setup(
        A, G, xyz, device=device, optimize=True))
    if cb:
        before = dict(kernels.LAUNCHES)
    (lam, X, rn), solve_s = setup(lambda: ame.solve(seed=0))
    X64 = X.double()
    div = float(torch.linalg.matrix_norm(f64(ame._Gt).mv(X64))
                / torch.linalg.matrix_norm(X64))
    rec = {"ams": ams_levels(ame.ams), "edges": A.n_rows,
           "eigenvalues": lam.tolist(), "residual_norms": rn.tolist(),
           "div_free": div, "setup_s": s, "solve_s": solve_s}
    if cb and ame_hex == N_AME:
        rec["size"] = AME_CUT
    if cb:
        grew = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        log(json.dumps(dict(rec, solve=f"ame block {AME_BLOCK} curl-curl "
                            f"{ame_hex}^3", launches=grew)))
        require(any(grew[k] > 0 for k in AUX_KERNELS),
                f"AME launched none of {AUX_KERNELS}")
    # the gradient fields sit at beta = 0.01; the divergence-free ones
    # above it by the curl-curl eigenvalue, (pi / nhex)^2 or more
    lam_ok = bool(torch.isfinite(lam).all()) and float(lam.min()) > 0.0105
    require(lam_ok, f"AME eigenvalues {lam.tolist()} not above the "
            "gradient cluster at beta = 0.01")
    require(bool((rn <= ame.tol * torch.clamp(lam.abs(), min=1.0)).all()),
            f"AME did not converge: residual norms {rn.tolist()}")
    require(div <= 1e-5, f"AME eigenvectors not divergence-free: {div}")
    out["ame"] = rec
    del ame, A, G, X, X64
    done("ame", t0)
    for rec in out.values():
        for k in ("setup_s", "solve_s", "mesh_s"):
            rec.pop(k, None)
    return out


def aux_phase(H, kernels, torch, held):
    """Phase 12: the slice's solvers at full width on the card."""
    kernels.reset_launches()
    aux_runs(H, torch, "cuda", N_MAIN, N_2D, N_2D, N_HEX, N_ADS, N_AME, held,
             kernels)
    return dict(kernels.LAUNCHES)


def ame_oracle(torch, nhex: int, k: int):
    """The k smallest eigenvalues of the curl-curl operator at nhex^3 on
    the divergence-free complement, densely in f64 (the reference test's
    deflation oracle): the eigenvalues of P A P above 1.5 beta, P the
    projector onto range(G)'s complement."""
    from hypre_tpu_torch.problems import maxwell
    from hypre_tpu_torch.seq.ell import ell_to_csr

    A, G, _ = maxwell.curl_curl_3d(nhex, dtype=torch.float64, device="cpu")
    Ad, Gd = ell_to_csr(A).to_dense(), ell_to_csr(G).to_dense()
    U, sv, _ = np.linalg.svd(Gd, full_matrices=False)
    Q = U[:, sv > 1e-10 * sv.max()]
    P = np.eye(Ad.shape[0]) - Q @ Q.T
    w = np.linalg.eigvalsh(P @ Ad @ P)
    return np.sort(w[w > 0.015])[:k]


def aux_card_vs_cpu(H, kernels, torch):
    """The slice's paths at AUX_SMALL on the card and on the CPU (plain
    versions): levels, formats and iterations equal, AME's eigenvalues to
    AME_EIG_RTOL of each other and of the dense oracle."""
    out = {dev: aux_runs(H, torch, dev, **AUX_SMALL)
           for dev in ("cuda", "cpu")}
    lam = {dev: np.array(out[dev]["ame"].pop("eigenvalues"))
           for dev in out}
    for dev in out:
        out[dev]["ame"].pop("residual_norms")
        out[dev]["ame"].pop("div_free")
    want = ame_oracle(torch, AUX_SMALL["ame_hex"], AME_BLOCK)
    gap = float(np.abs(lam["cuda"] - lam["cpu"]).max() / want.max())
    err = float(np.abs(np.sort(lam["cpu"]) - want).max() / want.max())
    log(json.dumps({"card_vs_cpu": "ame", "cuda": lam["cuda"].tolist(),
                    "cpu": lam["cpu"].tolist(), "oracle": want.tolist(),
                    "gap": gap, "oracle_err": err}))
    require(gap <= AME_EIG_RTOL and err <= AME_EIG_RTOL,
            "AME: card, CPU and oracle eigenvalues disagree")
    for key in out["cuda"]:
        log(json.dumps({"card_vs_cpu": key, "cuda": out["cuda"][key],
                        "cpu": out["cpu"][key]}))
        require(out["cuda"][key] == out["cpu"][key],
                f"{key}: card and CPU differ")


# ---------------------------------------------------------------------------
# Phase 13: hypre's preconditioners at full width
# ---------------------------------------------------------------------------


def saddle_system(H, torch, n: int, dtype, device):
    """tests/test_precond.py's Stokes-like system at n^2 velocity and n^2
    pressure unknowns: A the 5-pt Laplacian plus the unit mass, B a
    one-sided difference, C = 1e-2 I."""
    from hypre_tpu_torch.precond.saddle import SaddleSystem
    from hypre_tpu_torch.seq.spgemm import ell_add, ell_transpose

    kw = dict(dtype=dtype, device=device)
    A = ell_add(1.0, H.laplacian_2d_5pt(n, n, **kw), 1.0,
                H.stencil_to_ell((n, n), [(0, 0)], [1.0], **kw))
    B = H.stencil_to_ell((n, n), [(0, 0), (1, 0)], [1.0, -1.0], **kw)
    C = H.stencil_to_ell((n, n), [(0, 0)], [1e-2], **kw)
    return SaddleSystem(A=A, B=B, Bt=ell_transpose(B), C=C)


def precond_record(label, kernels, torch, setup_s, run, A64, b, held, op,
                   need=("dia_spmv",), extra=None):
    """One phase-13 solve on the card: the operator's DIA kernel held
    against plain, the solve cold then warm (timed, launches counted),
    once more under the profiler for the card's kernels of all ops, then
    check_solve."""
    hold_dia(op, label, kernels, torch, held)
    (x, info), warm_ms, grew = timed(kernels, torch, run)
    ops = uncounted(kernels, lambda: device_kernels(torch, run))
    it = max(int(info.iterations), 1)
    rec = {"setup_s": setup_s, "device_kernels": ops,
           "device_kernels_per_iteration": ops / it}
    rec.update(extra or {})
    check_solve(label, torch, x, info, A64, b, warm_ms, grew, need=need,
                extra=rec)
    return int(info.iterations)


def synced(torch, fn):
    """(fn(), seconds) with the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def precond_phase(H, kernels, torch, held):
    """Phase 13: the ij driver's preconditioner ids and -smtype at 128^3,
    then the classes the driver does not reach by the API (IC, the
    polynomial, MGR's global ILU, the saddle solvers, ILU-Schur), each at
    PRECOND_RTOL with its setup seconds, iterations, warm ms, f64 true
    residual and launches."""
    from hypre_tpu_torch.drivers import ij
    from hypre_tpu_torch.precond import (
        IC, BlockPrecond, ILUSchurGMRES, ILUSchurNSH, PolyPrecond, Uzawa,
    )
    from hypre_tpu_torch.seq.fastmv import optimize_operator

    kernels.reset_launches()
    grid = f"-n {N_MAIN} {N_MAIN} {N_MAIN} -tol {PRECOND_RTOL}"
    for label, flags, dtype in PRECOND_IDS:
        t0 = time.perf_counter()
        dt = getattr(torch, dtype)
        case, setup_s = synced(torch, lambda: ij.prepare(
            f"{flags} {grid}".split(), device="cuda", dtype=dt))
        need = ("dia_spmv", "banded_spmv", "banded_spmv_t") \
            if "-smtype" in flags else ("dia_spmv",)
        precond_record(f"ij {flags} ({label}, {dtype})", kernels, torch,
                       setup_s, case.solve, f64_of(case.A), case.b, held,
                       case.op, need=need)
        del case
        torch.cuda.empty_cache()
        log(json.dumps({"phase": "precond_phase", "part": label,
                        "seconds": time.perf_counter() - t0}))

    n = N_MAIN
    A = H.laplacian_3d_7pt(n, n, n, dtype=torch.float32, device="cuda")
    op = optimize_operator(A)
    b = torch.ones(A.n_rows, dtype=torch.float32, device="cuda")
    for label, make in (("IC", lambda: IC()),
                        ("PolyPrecond(order=4)", lambda: PolyPrecond(
                            order=4))):
        t0 = time.perf_counter()
        M, setup_s = synced(torch, lambda: make().setup(
            A, device="cuda").precond())
        precond_record(f"{label} pcg {n}^3", kernels, torch, setup_s,
                       lambda: H.pcg(op.mv, b, M=M, rtol=PRECOND_RTOL,
                                     maxiter=PRECOND_MAXITER,
                                     device="cuda"),
                       f64_of(A), b, held, op)
        log(json.dumps({"phase": "precond_phase", "part": label,
                        "seconds": time.perf_counter() - t0}))
    del A, op, b, M

    # ILU-GMRES with its interface Schur solve, in float64 (FlexGMRES tests
    # b - A x, whose float32 floor lies above PRECOND_RTOL), cut to
    # SCHUR_N^3 (SCHUR_CUT)
    t0 = time.perf_counter()
    n = SCHUR_N
    A = H.laplacian_3d_7pt(n, n, n, dtype=torch.float64, device="cuda")
    op = optimize_operator(A)
    b = torch.ones(A.n_rows, dtype=torch.float64, device="cuda")
    sch, setup_s = synced(torch, lambda: ILUSchurGMRES(
        nparts=SCHUR_NPARTS).setup(A, device="cuda"))
    precond_record(f"ILUSchurGMRES flexgmres {n}^3 (float64)", kernels,
                   torch, setup_s, lambda: H.flexgmres(
                       op.mv, b, M=sch.precond(), rtol=PRECOND_RTOL,
                       maxiter=PRECOND_MAXITER, device="cuda",
                       **GMRES_KW),
                   A, b, held, op, extra={"size": SCHUR_CUT})
    log(json.dumps({"ILUSchurGMRES inner iterations": {
        "applies": len(sch.inner_iterations),
        "max": max(sch.inner_iterations),
        "min": min(sch.inner_iterations)}}))
    require(max(sch.inner_iterations) <= sch.schur_max_iter,
            "the inner GMRES ran past its maxiter")
    del A, op, b, sch
    log(json.dumps({"phase": "precond_phase", "part": "ILUSchurGMRES",
                    "seconds": time.perf_counter() - t0}))

    # ILU-NSH: its dense (n, m) interface basis caps the size (NSH_CUT)
    t0 = time.perf_counter()
    A = H.laplacian_2d_5pt(NSH_N, NSH_N, dtype=torch.float32, device="cuda")
    op = optimize_operator(A)
    b = manufactured_rhs(A, torch, 14)
    nsh, setup_s = synced(torch, lambda: ILUSchurNSH(
        nparts=SCHUR_NPARTS, nsh_iters=12).setup(A, device="cuda"))
    precond_record(f"ILUSchurNSH flexgmres {NSH_N}^2", kernels, torch,
                   setup_s, lambda: H.flexgmres(
                       op.mv, b, M=nsh.precond(), rtol=PRECOND_RTOL,
                       maxiter=PRECOND_MAXITER, device="cuda",
                       **GMRES_KW),
                   f64_of(A), b, held, op,
                   extra={"interface": int(nsh.g_idx.numel()),
                          "size": NSH_CUT})
    del A, op, b, nsh
    log(json.dumps({"phase": "precond_phase", "part": "ILUSchurNSH",
                    "seconds": time.perf_counter() - t0}))

    # MGR with the global ILU pass on phase 10's block system
    t0 = time.perf_counter()
    A, m = block_system(H, torch, N_2D, "cuda")
    mgr, setup_s = synced(torch, lambda: H.MGR(
        num_relax_sweeps=2, global_smooth_type="ilu").setup(
        A, [np.arange(m)], device="cuda"))
    op = mgr.levels[0].op
    bb = manufactured_rhs(A, torch, 12)
    precond_record(f"MGR(global ilu) flexgmres n={2 * m}", kernels, torch,
                   setup_s, lambda: H.flexgmres(
                       op.mv, bb, M=mgr.precond(), rtol=PRECOND_RTOL,
                       maxiter=PRECOND_MAXITER, device="cuda",
                       **GMRES_KW),
                   f64_of(A), bb, held, op,
                   need=("dia_spmv", "banded_spmv", "banded_spmv_t"))
    del A, mgr, op, bb
    log(json.dumps({"phase": "precond_phase", "part": "MGR",
                    "seconds": time.perf_counter() - t0}))

    # the saddle solvers
    t0 = time.perf_counter()
    sysm = saddle_system(H, torch, SADDLE_N, torch.float32, "cuda")
    sys64 = saddle_system(H, torch, SADDLE_N, torch.float64, "cuda")
    fast = sysm.optimized()
    x_star = torch.from_numpy(np.random.default_rng(15).random(
        sysm.n_u + sysm.n_p)).cuda()
    bs = sys64.mv(x_star).float()
    bp, setup_s = synced(torch, lambda: BlockPrecond(
        mode="triangular").setup(sysm, device="cuda"))
    precond_record(f"BlockPrecond flexgmres {SADDLE_N}^2 x 2", kernels,
                   torch, setup_s, lambda: H.flexgmres(
                       fast.mv, bs, M=bp.precond(), rtol=PRECOND_RTOL,
                       maxiter=PRECOND_MAXITER, device="cuda",
                       **GMRES_KW),
                   sys64, bs, held, fast.A,
                   need=("dia_spmv", "banded_spmv", "banded_spmv_t"),
                   extra={"levels": level_sizes(bp.amg.hierarchy)})
    del bp, sysm, sys64, fast
    sysm = saddle_system(H, torch, UZAWA_N, torch.float32, "cuda")
    sys64 = saddle_system(H, torch, UZAWA_N, torch.float64, "cuda")
    fast = sysm.optimized()
    x_star = torch.from_numpy(np.random.default_rng(15).random(
        sysm.n_u + sysm.n_p)).cuda()
    bs = sys64.mv(x_star).float()
    uz, setup_s = synced(torch, lambda: Uzawa(
        omega=0.5, rtol=PRECOND_RTOL, maxiter=PRECOND_MAXITER,
        inner_cycles=UZAWA_CYCLES).setup(sysm, device="cuda"))
    f, g = bs[:sysm.n_u], bs[sysm.n_u:]

    def uzawa():
        u, p, info = uz.solve(f, g)
        return torch.cat([u, p]), info

    precond_record(f"Uzawa {UZAWA_N}^2 x 2", kernels, torch, setup_s,
                   uzawa, sys64, bs, held, fast.A,
                   need=("dia_spmv",), extra={
                       "levels": level_sizes(uz.amg.hierarchy),
                       "size": UZAWA_CUT})
    del uz, sysm, sys64, fast
    log(json.dumps({"phase": "precond_phase", "part": "saddle",
                    "seconds": time.perf_counter() - t0}))
    return dict(kernels.LAUNCHES)


def factors_of(obj) -> dict:
    """name -> host float64 array of what a preconditioner's setup built
    (dense factors at the card-vs-CPU sizes)."""
    import torch

    from hypre_tpu_torch.seq.ell import EllMatrix, ell_to_csr

    def dense(M):
        return np.asarray(ell_to_csr(M).to_dense(), dtype=np.float64)

    out = {}
    for name in ("L", "U", "Lt", "G", "M", "S", "C"):
        M = getattr(obj, name, None)
        if isinstance(M, EllMatrix):
            out[name] = dense(M)
    for name in ("dinv", "inv_blocks", "X", "weight"):
        t = getattr(obj, name, None)
        if isinstance(t, torch.Tensor):
            out[name] = t.double().cpu().numpy()
    if getattr(obj, "coeffs", None) is not None:
        out["coeffs"] = np.asarray(obj.coeffs, dtype=np.float64)
    for name in ("_ilut", "B_ilu", "C_ilu"):
        inner = getattr(obj, name, None)
        if inner is not None:
            out.update({f"{name}.{k}": v for k, v in
                        factors_of(inner).items()})
    return out


def precond_small_runs(H, torch, device) -> dict:
    """Every class, each -smtype and the driver's ids at small sizes on
    ``device`` in float32: setup factors and iterations."""
    from hypre_tpu_torch import precond as P
    from hypre_tpu_torch.drivers import ij

    out = {}
    grid = f"-n {PRECOND_SMALL} {PRECOND_SMALL} {PRECOND_SMALL} " \
        f"-tol {PRECOND_RTOL}"
    for label, flags, dtype in PRECOND_IDS:
        case = ij.prepare(f"{flags} {grid}".split(), device=device,
                          dtype=getattr(torch, dtype))
        _, info = case.solve()
        out[f"ij {flags}"] = {"iterations": int(info.iterations),
                              "converged": bool(info.converged)}
    n = PRECOND_SMALL
    A = H.laplacian_3d_7pt(n, n, n, dtype=torch.float32, device=device)
    b = torch.ones(A.n_rows, dtype=torch.float32, device=device)
    classes = [("ILU", {}), ("ILU", dict(fill_level=1)), ("ILUT", {}),
               ("Euclid", {}), ("PILUT", {}), ("IC", {}),
               ("DDICT", {}), ("DDILUT", {}), ("FSAI", {}),
               ("FSAI", dict(algo_type="adaptive")), ("ParaSails", {}),
               ("Schwarz", {}), ("Schwarz", dict(overlap=2)),
               ("PolyPrecond", {}), ("ILUSchurGMRES", dict(nparts=2)),
               ("ILUSchurNSH", dict(nparts=2, nsh_iters=12))]
    for name, kw in classes:
        obj = getattr(P, name)(**kw).setup(A, device=device)
        key = name + "".join(f",{k}={v}" for k, v in kw.items())
        solver = H.flexgmres if name == "ILUSchurGMRES" else (
            H.gmres if name in ("ILU", "ILUT", "Euclid", "PILUT", "DDILUT",
                                "ILUSchurNSH") else H.pcg)
        kws = GMRES_KW if solver is not H.pcg else {}
        _, info = solver(A.mv, b, M=obj.precond(), rtol=PRECOND_SMALL_RTOL,
                         maxiter=PRECOND_MAXITER, device=device, **kws)
        out[key] = {"factors": factors_of(obj),
                    "iterations": int(info.iterations)}
    Bk, m = block_system(H, torch, N_SMALL_2D, device)
    mgr = H.MGR(num_relax_sweeps=2, global_smooth_type="ilu").setup(
        Bk, [np.arange(m)], optimize=True, device=device)
    bb = manufactured_rhs(Bk, torch, 12)
    _, info = H.flexgmres(mgr.levels[0].op.mv, bb, M=mgr.precond(),
                          rtol=PRECOND_SMALL_RTOL, maxiter=PRECOND_MAXITER,
                          device=device, **GMRES_KW)
    out["MGR(global ilu)"] = {"iterations": int(info.iterations)}
    sysm = saddle_system(H, torch, N_SMALL_2D, torch.float32, device)
    bs = torch.cat([torch.ones(sysm.n_u), torch.zeros(sysm.n_p)]).to(device)
    bp = P.BlockPrecond().setup(sysm, device=device, optimize=True)
    _, info = H.flexgmres(bp.op.mv, bs, M=bp.precond(),
                          rtol=PRECOND_SMALL_RTOL, maxiter=PRECOND_MAXITER,
                          device=device, **GMRES_KW)
    out["BlockPrecond"] = {"factors": factors_of(bp),
                           "iterations": int(info.iterations)}
    sysm = saddle_system(H, torch, UZAWA_SMALL, torch.float32, device)
    bs = torch.cat([torch.ones(sysm.n_u), torch.zeros(sysm.n_p)]).to(device)
    uz = P.Uzawa(omega=0.5, rtol=PRECOND_SMALL_RTOL).setup(
        sysm, device=device, optimize=True)
    *_, info = uz.solve(bs[:sysm.n_u], bs[sysm.n_u:])
    out["Uzawa"] = {"iterations": int(info.iterations)}
    return out


def precond_card_vs_cpu(H, kernels, torch):
    """Phase 13's card-vs-CPU part: equal iterations, factors to
    PRECOND_FACTOR_RTOL relative."""
    out = {dev: precond_small_runs(H, torch, dev) for dev in ("cuda", "cpu")}
    for key in out["cuda"]:
        got, want = out["cuda"][key], out["cpu"][key]
        gaps = {}
        for name, w in want.get("factors", {}).items():
            g = got["factors"][name]
            require(g.shape == w.shape, f"{key} {name}: shapes differ")
            gaps[name] = float(np.abs(g - w).max(initial=0.0)
                               / max(np.abs(w).max(initial=0.0), 1e-30))
        log(json.dumps({"card_vs_cpu": key, "cuda": got["iterations"],
                        "cpu": want["iterations"], "factor_gaps": gaps}))
        require(got["iterations"] == want["iterations"],
                f"{key}: card and CPU take different iterations")
        require(all(v <= PRECOND_FACTOR_RTOL for v in gaps.values()),
                f"{key}: card and CPU factors differ: {gaps}")


# ---------------------------------------------------------------------------
# Phase 14: hypre's struct layer at full width
# ---------------------------------------------------------------------------


def struct_operators(mg) -> list:
    """(label, StructMatrix) for every operator a struct solver applies
    through its DIA view: the levels' A, SMG's plane operators, SparseMSG's
    lattice, a Hybrid's A."""
    hier = getattr(mg, "hierarchy", None)
    if hier is not None:
        ops = []
        for li, lv in enumerate(hier.levels):
            ops.append((f"A{li}", lv.A))
            plane = getattr(lv, "plane", None)
            if plane is not None:
                ops += [(f"A{li}.T{pi}", pl.T)
                        for pi, pl in enumerate(plane.levels)]
        return ops
    if isinstance(getattr(mg, "A", None), dict):
        return [(f"A{g}", M) for g, M in mg.A.items()]
    return [("A", mg.A)]


def struct_levels(mg) -> list:
    """Per level: shape, coarsening direction, stencil size and the DIA
    view's plane count (PFMG and SMG; SparseMSG's lattice grids)."""
    hier = getattr(mg, "hierarchy", None)
    if hier is not None:
        out = [{"shape": list(lv.A.shape), "cdir": lv.P.cdir,
                "stencil": lv.A.stencil.size, "D": lv.A.dia.D}
               for lv in hier.levels]
        return out + [{"shape": list(hier.coarse_shape),
                       "stencil": hier.coarse_A.stencil.size}]
    if isinstance(getattr(mg, "A", None), dict):
        return [{"grid": list(g), "shape": list(M.shape),
                 "stencil": M.stencil.size} for g, M in mg.A.items()]
    return []


def hold_views(label, ops, kernels, torch, held):
    """Every DIA view of ``ops`` ((name, DiaMatrix) pairs) against the
    plain version (one launch each, not counted), summarized as one record
    per kernel in ``held``."""
    got = []
    for name, M in ops:
        hold_dia(M, f"{label} {name}", kernels, torch, got)
    for kernel in ("dia_spmv", "dia_spmv_static", "dia_rows"):
        mine = [h for h in got if h["kernel"] == kernel]
        if mine:
            held.append({
                "kernel": kernel, "operator": f"{label}: {len(mine)} DIA "
                "views", "shape": [max(h["shape"][0] for h in mine),
                                   max(h["shape"][1] for h in mine)],
                "max_abs_err": max(h["max_abs_err"] for h in mine)})


def struct_phase(H, kernels, torch, held):
    """Phase 14 through the port's struct driver (``prepare``, then
    ``solve`` for the path's right-hand side): PFMG-PCG and SMG-PCG on the
    2-D 5-pt STRUCT_N2D^2 and the 3-D 7-pt STRUCT_N3D^3, PFMG,
    SparseMSG-PCG and StructHybrid at STRUCT_N2D^2, float32 at
    STRUCT_RTOL; the 2-D paths solve for a manufactured x* (b = A x*),
    the 3-D ones for b = ones. Each prints its setup seconds, levels
    (shape, cdir, stencil, DIA planes), iterations, warm ms, float64 true
    residual, DIA launches per iteration and the card's kernels of all
    ops per iteration; each must converge under TRUE_RESIDUAL_LIMIT and
    launch kernel 1 or 2. Every DIA view of a path is held against the
    plain version (one summary record per path in ``held``). Returns the
    launches and the operators the kernels line times."""
    from hypre_tpu_torch.drivers import struct as drv
    from hypre_tpu_torch.problems.struct_problems import struct_laplacian

    kernels.reset_launches()
    timing_ops = {}
    for label, sid, dims in STRUCT_PATHS:
        t0 = time.perf_counter()
        n = STRUCT_N2D if dims == 2 else STRUCT_N3D
        shape = (n,) * dims
        what = f"{label} {'x'.join(map(str, shape))}"
        flags = (f"-solver {sid} -n {n} {n} {n if dims == 3 else 1} "
                 f"-tol {STRUCT_RTOL} -max_iter {STRUCT_MAXITER}")
        case, setup_s = synced(torch, lambda: drv.prepare(
            flags.split(), device="cuda", dtype=torch.float32))
        A, mg = case.A, case.mg
        A64 = struct_laplacian(shape, dtype=torch.float64, device="cuda")
        x_star, b = None, case.b
        if dims == 2:
            x_star = torch.from_numpy(np.random.default_rng(16).random(
                shape)).cuda()
            b = A64.mv(x_star).float()
        hold_views(what, [(name, M.dia) for name, M in
                          struct_operators(mg)], kernels, torch, held)
        (x, info), warm_ms, grew = (
            first_call if (sid, dims) in STRUCT_ONCE else timed)(
                kernels, torch, lambda: case.solve(b))
        it = max(int(info.iterations), 1)
        if sid == 21:
            ops = uncounted(kernels, lambda: device_kernels(
                torch, lambda: case.solve(b)))
            per_it = ops / max(mg.dscg_iterations + mg.mg_iterations, 1)
            extra = {"dscg_iterations": mg.dscg_iterations,
                     "mg_iterations": mg.mg_iterations}
        else:
            # one iteration's work: a cycle and a matvec (the Krylov
            # vector ops, ~10 kernels, are not in it)
            f = b.reshape(-1)
            one = (lambda: (mg.precond()(f), A.mv(f))) if sid != 1 else \
                (lambda: (mg.cycle(b, b), A.mv(b)))
            per_it = None if (sid, dims) in STRUCT_ONCE else uncounted(
                kernels, lambda: device_kernels(torch, one))
            extra = {}
        rec = {"flags": flags, "setup_s": setup_s,
               "warm_ms_of": "the first call" if (sid, dims) in STRUCT_ONCE
               else "the second call",
               "cut": STRUCT_ONCE_CUT if (sid, dims) in STRUCT_ONCE
               else None,
               "levels": struct_levels(mg),
               "device_kernels_per_iteration": per_it,
               "dia_launches_per_iteration": sum(
                   grew[k] for k in STRUCT_KERNELS) / it}
        if x_star is not None:
            rec["x_star_rel_err"] = float(
                (x.reshape(shape).double() - x_star).norm() / x_star.norm())
        rec.update(extra)
        check_solve(what, torch, x.reshape(-1), info, A64, b.reshape(-1),
                    warm_ms, grew, extra=rec)
        require(sum(grew[k] for k in STRUCT_KERNELS) > 0,
                f"{what} launched neither DIA kernel")
        if sid == 11:
            lv = mg.hierarchy.levels
            timing_ops[f"{dims}-D level 0"] = lv[0].A
            timing_ops[f"{dims}-D PFMG level 1 (probed)"] = lv[1].A
        del case, A, A64, b, x, mg
        torch.cuda.empty_cache()
        log(json.dumps({"phase": "struct_phase", "part": what,
                        "seconds": time.perf_counter() - t0}))
    return dict(kernels.LAUNCHES), timing_ops


def struct_kernel_rows(torch, ops) -> dict:
    """Kernels 1 and 2 on the struct operators' DIA views (the static and
    the dynamic kernel on the same planes): time, bound, the plain
    version's time and one CSR product's, for the kernels line's
    other_shapes."""
    from hypre_tpu_torch.seq import dia as dia_mod
    from hypre_tpu_torch.struct.matrix import dia_view

    rng = np.random.default_rng(17)
    rows = {k: [] for k in STRUCT_KERNELS}
    for label, A in ops.items():
        static, dyn = A.dia, dia_view(A, specialize=False)
        D, n = static.D, static.n_rows
        x = torch.from_numpy(rng.standard_normal(n)).to("cuda",
                                                         torch.float32)
        csr = csr_of_dia(static, torch)
        lib = (csr @ x[:, None])[:, 0]
        lib_ms = time_ms(lambda: csr @ x[:, None], torch)
        bms, bby = bound(D * n * 4 + 2 * n * 4 + D * 4, 2.0 * D * n,
                         "float32")
        for name, M, plain in (
            ("dia_spmv_static", static,
             lambda: dia_mod.dia_spmv_static_plain(static.dvals,
                                                   static.offsets_static, x)),
            ("dia_spmv", dyn,
             lambda: dia_mod.dia_spmv_plain(dyn.dvals, dyn.offsets, x,
                                            dyn.margin)),
        ):
            require((M.offsets_static is not None)
                    == (name == "dia_spmv_static"),
                    f"{label}: {name} is not the view's kernel")
            y = M.mv(x)
            _, ab = rel_err(y, plain(), torch)
            rel_lib, _ = rel_err(y, lib, torch)
            rec = {"check": name, "operator": f"struct {label}",
                   "shape": [D, n], "max_abs_err": ab, "tol": 0.0,
                   "rel_err_vs_csr": rel_lib,
                   "ms": time_ms(lambda: M.mv(x), torch),
                   "plain_ms": time_ms(plain, torch, warmup=1, reps=5),
                   "bound_ms": bms, "bound_by": bby, "library_ms": lib_ms}
            log(json.dumps(rec))
            require(ab == 0.0, f"{name} on struct {label} differs from "
                    f"the plain version by {ab}")
            require(rel_lib <= 1e-5, f"{name} on struct {label}: rel err "
                    f"{rel_lib} against the CSR product")
            rows[name].append(rec)
    return rows


def struct_small_runs(torch, device) -> dict:
    """Every struct driver id at its STRUCT_SMALL flags on ``device``, in
    float64 and in float32 (at STRUCT_F32_TOL): the solve's iterations
    and the set-up hierarchy's cdir sequence, stencil offsets and
    coefficients."""
    from hypre_tpu_torch.drivers import struct as drv

    out = {}
    for flags, _ in STRUCT_SMALL:
        for dtype in (torch.float64, torch.float32):
            argv = flags.split()
            if dtype == torch.float32:
                argv = [a for i, a in enumerate(argv) if a != "-tol" and (
                    i == 0 or argv[i - 1] != "-tol")]
                argv += ["-tol", str(STRUCT_F32_TOL)]
            case = drv.prepare(argv, device=device, dtype=dtype)
            mg = case.mg
            _, info = case.solve()
            rec = {"iterations": int(info.iterations),
                   "converged": bool(info.converged)}
            if hasattr(mg, "dscg_iterations"):
                rec["dscg_mg"] = [mg.dscg_iterations, mg.mg_iterations]
            if getattr(mg, "hierarchy", None) is not None:
                rec["cdirs"] = mg.hierarchy.cdirs
            if mg is not None and not hasattr(mg, "dscg_iterations"):
                ops = [M for _, M in struct_operators(mg)]
                rec["offsets"] = [list(M.stencil.offsets) for M in ops]
                rec["coeffs"] = [M.coeffs.double().cpu().numpy()
                                 for M in ops]
            out[(flags, str(dtype))] = rec
    return out


def struct_card_vs_cpu(torch):
    """Phase 14's card-vs-CPU part: in float64 the golden iterations on
    both; in both types a converged solve, equal iterations, cdir
    sequences and stencil offsets, coefficients to STRUCT_COEFF_RTOL
    (float32) and 1e-12 (float64)."""
    out = {dev: struct_small_runs(torch, dev) for dev in ("cuda", "cpu")}
    golden = dict(STRUCT_SMALL)
    for key in out["cuda"]:
        flags, dtype = key
        got, want = out["cuda"][key], out["cpu"][key]
        gaps = [float(np.abs(g - w).max(initial=0.0)
                      / max(np.abs(w).max(initial=0.0), 1e-30))
                for g, w in zip(got.pop("coeffs", []),
                                want.pop("coeffs", []))]
        gap = max(gaps, default=0.0)
        tol = STRUCT_COEFF_RTOL if dtype == "torch.float32" else 1e-12
        log(json.dumps({"card_vs_cpu": f"struct {flags} ({dtype})",
                        "cuda": {k: v for k, v in got.items()
                                 if k != "offsets"},
                        "cpu": {k: v for k, v in want.items()
                                if k != "offsets"},
                        "coeff_gap": gap}))
        require(got == want, f"struct {flags} ({dtype}): card and CPU "
                "differ")
        require(gap <= tol, f"struct {flags} ({dtype}): coefficients "
                f"differ by {gap}")
        require(got["converged"], f"struct {flags} ({dtype}) did not "
                "converge")
        if dtype == "torch.float64":
            if golden[flags] is not None:
                require(got["iterations"] == golden[flags],
                        f"struct {flags}: {got['iterations']} iterations, "
                        f"golden {golden[flags]}")


# ---------------------------------------------------------------------------
# Phase 15: hypre's semi-structured layer at full width
# ---------------------------------------------------------------------------


def facade_ops(label, amg) -> list:
    """(label, operator) for every level operator of a facade's
    hierarchy."""
    ops = []
    for li, lv in enumerate(amg.hierarchy.levels):
        ops += [(f"{label} A{li}", lv.A), (f"{label} P{li}", lv.P)]
    return ops


def split_ops(A, sp) -> list:
    """The DIA views a Split path applies: each part's, U's and every
    sub-solver operator's."""
    ops = [(f"part{k}", P.dia) for k, P in enumerate(A.parts)]
    ops.append(("U", A.U_op))
    for k, sub in enumerate(sp.subs):
        ops += [(f"part{k} {name}", M.dia)
                for name, M in struct_operators(sub)]
    return ops


def sys_levels(sp) -> list:
    return [{"shape": list(lv.A.shape), "cdir": lv.P[0].cdir,
             "stencil": lv.A.stencil.size, "D": lv.A.dia.D,
             "kernel": "dia_spmv_static" if lv.A.dia.offsets_static
             is not None else "dia_spmv"} for lv in sp.levels] + [
        {"shape": list(sp.coarse_A.shape),
         "stencil": sp.coarse_A.stencil.size}]


def fac_formats(fac) -> dict:
    return {"levels": [{"n": lv.A.n_rows, "A": type(lv.A_op).__name__,
                        "P": type(lv.P_op).__name__,
                        "R": type(lv.R_op).__name__}
                       for lv in fac.levels],
            "base": {"levels": level_sizes(fac.coarse_amg.hierarchy),
                     "formats": describe_formats(fac.coarse_amg.hierarchy)}}


def strong_system(n, dtype, device):
    """tests/test_sstruct.py's node-relaxation system, [[L + 3, 2.9],
    [2.9, L + 3]]: SPD at every size, strongly coupled at each node."""
    import torch

    from hypre_tpu_torch.drivers import sstruct as drv
    from hypre_tpu_torch.sstruct.syspfmg import SysStructMatrix

    A = drv.coupled_system(n, 2.9, dtype=torch.float64, device="cpu")
    coeffs = A.coeffs.clone()
    ci = A.stencil.center_index()
    coeffs[0, 0, ci] += 3.0
    coeffs[1, 1, ci] += 3.0
    return SysStructMatrix(coeffs=coeffs.to(device, dtype),
                           stencil=A.stencil, shape=A.shape)


def fem_two_parts(n, dtype, device, seconds=None):
    """tests/test_sstruct.py's FEM problem: two n x n Q1 parts glued
    along an edge (shared nodes), Dirichlet on the outer boundary, one
    AddFEMValues call per element; ``seconds`` (a dict) takes the host
    loop's and the assembly's seconds."""
    from hypre_tpu_torch.sstruct import fem

    ke = np.array([[2 / 3, -1 / 6, -1 / 3, -1 / 6],
                   [-1 / 6, 2 / 3, -1 / 6, -1 / 3],
                   [-1 / 3, -1 / 6, 2 / 3, -1 / 6],
                   [-1 / 6, -1 / 3, -1 / 6, 2 / 3]])
    t0 = time.perf_counter()
    grid = fem.SStructFEMGrid([(n + 1, n + 1), (n + 1, n + 1)])
    for p in (0, 1):
        grid.set_fem_ordering(p, [0, 0, 0, 0],
                              [(0, 0), (1, 0), (1, 1), (0, 1)])
    for j in range(n + 1):
        grid.share_node(1, (0, j), 0, (n, j))
    M = fem.SStructFEMMatrix(grid, dtype=dtype, device=device)
    fe = np.full(4, 0.25 / (2 * n * n))
    for p in (0, 1):
        for i in range(n):
            for j in range(n):
                M.add_fem_values(p, (i, j), ke)
                M.add_fem_rhs(p, (i, j), fe)
    bnd = set()
    for j in range(n + 1):
        bnd.add(grid.dof(0, (0, j), 0))
        bnd.add(grid.dof(1, (n, j), 0))
    for p in (0, 1):
        for i in range(n + 1):
            bnd.add(grid.dof(p, (i, 0), 0))
            bnd.add(grid.dof(p, (i, n), 0))
    t1 = time.perf_counter()
    M.assemble(dirichlet=sorted(bnd))
    if seconds is not None:
        seconds.update(elements_s=t1 - t0,
                       assembly_s=time.perf_counter() - t1)
    return M


def fei_q1(n, dtype, device, seconds=None):
    """tests/test_fei.py's Q1 Poisson FEI sequence on an n x n element
    mesh, u = 0 on the boundary, one sumInElemMatrix/RHS call per
    element; ``seconds`` takes the host loop's and loadComplete's."""
    from hypre_tpu_torch.fei import FEISystem

    ke = np.array([[2 / 3, -1 / 6, -1 / 3, -1 / 6],
                   [-1 / 6, 2 / 3, -1 / 6, -1 / 3],
                   [-1 / 3, -1 / 6, 2 / 3, -1 / 6],
                   [-1 / 6, -1 / 3, -1 / 6, 2 / 3]])
    t0 = time.perf_counter()
    s = FEISystem(dtype=dtype, device=device).initFields()
    s.initElemBlock("blk", n * n, 4)
    fe = np.full(4, 0.25 / (n * n))
    for i in range(n):
        for j in range(n):
            conn = [(i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)]
            s.sumInElemMatrix("blk", (i, j), conn, ke)
            s.sumInElemRHS("blk", (i, j), conn, fe)
    bnd = [(i, j) for i in range(n + 1) for j in range(n + 1)
           if i in (0, n) or j in (0, n)]
    s.loadNodeBCs(bnd, [0.0] * len(bnd))
    t1 = time.perf_counter()
    s.loadComplete()
    if seconds is not None:
        seconds.update(elements_s=t1 - t0,
                       load_complete_s=time.perf_counter() - t1)
    return s


def sstruct_record(what, kernels, torch, held, run, A64, b, x_star, ops,
                   one, extra, once=False):
    """One phase-15 solve on the card: its DIA views held against plain,
    the solve cold then warm (or its first call only, ``once``), the
    card's kernels of all ops in ``one`` (one iteration's work) under the
    profiler, then check_solve and a launch of one of kernels 1-4."""
    hold_views(what, ops, kernels, torch, held)
    (x, info), warm_ms, grew = (first_call if once else timed)(
        kernels, torch, run)
    rec = dict(extra, warm_ms_of="the first call" if once
               else "the second call")
    rec["device_kernels_per_iteration"] = uncounted(
        kernels, lambda: device_kernels(torch, one))
    if x_star is not None:
        rec["x_star_rel_err"] = float((x.reshape(-1).double()
                                       - x_star.reshape(-1)).norm()
                                      / x_star.norm())
    check_solve(what, torch, x.reshape(-1), info, A64, b.reshape(-1),
                warm_ms, grew, extra=rec)
    require(any(grew[k] > 0 for k in SSTRUCT_KERNELS),
            f"{what} launched none of kernels 1-4")
    return int(info.iterations)


def x_star_rhs(A64, shape, seed, torch):
    """(x*, b = A x* in float32) with x* uniform in [0, 1) from ``seed``,
    formed in float64 on A's device."""
    x = torch.from_numpy(np.random.default_rng(seed).random(shape)).to(
        A64.device)
    return x, A64.mv(x).float()


def sstruct_phase(H, kernels, torch, held):
    """Phase 15: the sstruct driver's ids and the layer's API at full
    width, f32 at SSTRUCT_RTOL, each for a manufactured x* (b = A x*):
    PCG + Split(PFMG) and PCG + Split(SMG) on two SSTRUCT_N^2 parts,
    Split standalone at SPLIT_N^2 (SPLIT_CUT), SysPFMG standalone and
    under PCG at -eps SYS_EPS, SysPFMG with each relaxation on the
    strong-coupling system, FAC standalone and under PCG on the
    composite grid of SSTRUCT_N^2 coarse cells, SStruct Maxwell on
    SSTRUCT_N^2 cells, FEM assembly (FEM_CUT) and FEI (FEI_CUT) under
    PCG-BoomerAMG. Each prints its setup seconds, iterations, warm ms,
    f64 true residual, x* error, formats, launches per iteration and the
    card's kernels of all ops per iteration, must converge under
    TRUE_RESIDUAL_LIMIT and launch one of kernels 1-4; every DIA view is
    held against the plain version. Returns the launches and the
    operators the kernels line times."""
    from hypre_tpu_torch.drivers import sstruct as drv
    from hypre_tpu_torch.seq import fastmv
    from hypre_tpu_torch.sstruct import SysPFMG

    f32, f64 = torch.float32, torch.float64
    n, tol, mx = SSTRUCT_N, SSTRUCT_RTOL, SSTRUCT_MAXITER
    kernels.reset_launches()
    timing = {}

    def part_done(what, t0):
        torch.cuda.empty_cache()
        log(json.dumps({"phase": "sstruct_phase", "part": what,
                        "seconds": time.perf_counter() - t0}))

    # the Split paths on the two glued parts
    for label, sid, size, once in (("PCG+Split(PFMG)", 11, n, False),
                                   ("PCG+Split(SMG)", 10, n, True),
                                   ("Split", 20, SPLIT_N, True)):
        t0 = time.perf_counter()
        what = f"{label} 2x{size}^2"
        flags = f"-solver {sid} -n {size} -tol {tol} -max_iter {mx}"
        case, setup_s = synced(torch, lambda: drv.prepare(
            flags.split(), device="cuda", dtype=f32))
        _, A64 = drv.two_part_problem(size, dtype=f64, device="cuda")
        x_star, b = x_star_rhs(A64, A64.n_rows, 31, torch)
        A, sp = case.A, case.solver
        one = ((lambda: (sp.precond()(b), A.mv(b))) if sid != 20
               else (lambda: sp._sweep(b, b)))
        sstruct_record(what, kernels, torch, held, lambda: case.solve(b),
                       A64, b, x_star, split_ops(A, sp), one, {
                           "flags": flags, "setup_s": setup_s,
                           "U": {"format": type(A.U_op).__name__,
                                 "D": getattr(A.U_op, "D", None),
                                 "row_list": getattr(A.U_op, "r_ptr",
                                                     None) is not None},
                           "part_levels": struct_levels(sp.subs[0])},
                       once=once)
        if sid == 11:
            timing[f"U (2 x {size}^2 parts)"] = A.U_op
        del case, A, A64, sp, b
        part_done(what, t0)

    # SysPFMG on -eps SYS_EPS, standalone and under PCG
    t0 = time.perf_counter()
    flags = f"-solver 3 -n {n} -eps {SYS_EPS} -tol {tol} -max_iter {mx}"
    case, setup_s = synced(torch, lambda: drv.prepare(
        flags.split(), device="cuda", dtype=f32))
    A64 = drv.coupled_system(n, SYS_EPS, dtype=f64, device="cuda")
    x_star, b = x_star_rhs(A64, (2, n, n), 32, torch)
    A, sp = case.A, case.solver
    ops = [(f"A{li}", lv.A.dia) for li, lv in enumerate(sp.levels)]
    one = lambda: (sp.cycle(b, b), A.mv(b))  # noqa: E731
    extra = {"flags": flags, "setup_s": setup_s, "levels": sys_levels(sp)}
    sstruct_record(f"SysPFMG 2x{n}^2", kernels, torch, held,
                   lambda: case.solve(b), A64, b, x_star, ops, one, extra)
    sstruct_record(f"SysPFMG-PCG 2x{n}^2", kernels, torch, held,
                   lambda: H.pcg(A.as_linear_op(), b.reshape(-1),
                                 M=sp.precond(), rtol=tol, maxiter=mx,
                                 device="cuda"),
                   A64, b, x_star, [], one, extra)
    timing[f"SysPFMG level 0 ({n}^2, 2 vars)"] = sp.levels[0].A.dia
    timing["SysPFMG level 1 (probed)"] = sp.levels[1].A.dia
    del case, A, A64, sp, b
    part_done("SysPFMG", t0)

    # SysPFMG's three relaxations on the strong-coupling system
    t0 = time.perf_counter()
    A, A64 = strong_system(n, f32, "cuda"), strong_system(n, f64, "cuda")
    x_star, b = x_star_rhs(A64, (2, n, n), 33, torch)
    for relax in ("jacobi", "node-jacobi", "node-rbgs"):
        sp, setup_s = synced(torch, lambda: SysPFMG(
            max_coarse_size=128, relax_type=relax).setup(A))
        sstruct_record(
            f"SysPFMG {relax} strong 2x{n}^2", kernels, torch, held,
            lambda: sp.solve(b, rtol=tol, maxiter=SYS_RELAX_MAXITER), A64, b,
            x_star, [(f"A{li}", lv.A.dia) for li, lv in enumerate(sp.levels)],
            lambda: (sp.cycle(b, b), A.mv(b)),
            {"setup_s": setup_s, "levels": len(sp.levels)})
        del sp
    del A, A64, b
    part_done("SysPFMG relaxations", t0)

    # FAC on the composite grid, standalone and under PCG
    t0 = time.perf_counter()
    flags = f"-solver 28 -n {n} -tol {tol} -max_iter {mx}"
    case, setup_s = synced(torch, lambda: drv.prepare(
        flags.split(), device="cuda", dtype=f32))
    fac = case.solver
    A64 = f64_of(case.A)
    x_star, b = x_star_rhs(A64, A64.n_rows, 34, torch)
    ops = []
    for li, lv in enumerate(fac.levels):
        ops += [(f"A{li}", lv.A_op), (f"P{li}", lv.P_op), (f"R{li}", lv.R_op)]
    ops += facade_ops("base", fac.coarse_amg)
    one = lambda: (fac.cycle(b), fac.A_op.mv(b))  # noqa: E731
    extra = {"flags": flags, "setup_s": setup_s, "dofs": case.A.n_rows,
             "formats": fac_formats(fac)}
    sstruct_record(f"FAC {n}^2 composite", kernels, torch, held,
                   lambda: case.solve(b), A64, b, x_star, ops, one, extra)
    sstruct_record(f"FAC-PCG {n}^2 composite", kernels, torch, held,
                   lambda: H.pcg(fac.A_op.mv, b, M=fac.precond(), rtol=tol,
                                 maxiter=mx, device="cuda"),
                   A64, b, x_star, [], one, extra)
    for name, M in ops:
        if isinstance(M, fastmv.BandedEll) and name in ("base A0",
                                                        "base P0"):
            timing[f"FAC {name}"] = M
    del case, fac, A64, b, ops
    part_done("FAC", t0)

    # SStruct Maxwell on the edge curl-curl system
    t0 = time.perf_counter()
    flags = f"-solver 120 -n {n} -tol {tol} -max_iter {mx}"
    case, setup_s = synced(torch, lambda: drv.prepare(
        flags.split(), device="cuda", dtype=f32))
    mw = case.solver
    A64 = f64_of(case.A)
    x_star, b = x_star_rhs(A64, A64.n_rows, 35, torch)
    ops = [("A", mw.op)]
    if mw.ams.B_G is not None:
        ops += facade_ops("G", mw.ams.B_G)
    for d, B in enumerate(mw.ams.B_Pi):
        ops += facade_ops(f"Pi{d}", B)
    M = mw.precond()
    sstruct_record(f"Maxwell {n}^2 cells", kernels, torch, held,
                   lambda: case.solve(b), A64, b, x_star, ops,
                   lambda: (M(b), mw.op.mv(b)),
                   {"flags": flags, "setup_s": setup_s, "edges": A64.n_rows,
                    "A": type(mw.op).__name__, "ams": ams_levels(mw.ams)})
    for name, op in ops:
        if isinstance(op, fastmv.BandedEll) and name in ("G A0", "G P0"):
            timing[f"Maxwell {name}"] = op
    del case, mw, A64, b, ops, M
    part_done("Maxwell", t0)

    # FEM assembly and FEI, each under PCG with the BoomerAMG facade
    for label, make, size in (("FEM two parts", fem_two_parts, FEM_N),
                              ("FEI Q1", fei_q1, FEI_N)):
        t0 = time.perf_counter()
        secs = {}
        obj = make(size, f32, "cuda", secs)
        A = obj.A
        A64 = f64_of(A)
        x_star, b = x_star_rhs(A64, A.n_rows, 36, torch)
        # the format both solves apply A through (FEISystem.solve builds
        # the same one from A in every call)
        op = fastmv.optimize_operator(A)
        if label.startswith("FEI"):
            # FEISystem.solve sets up its preconditioner in every call, as
            # the reference's does: its warm ms include that setup, which
            # the same facade (max_coarse_size 64) times here alone
            obj.b = b
            obj.parameters(["solver cg", "preconditioner boomeramg"])
            amg, setup_s = synced(torch, lambda: H.BoomerAMG(
                max_coarse_size=64).setup(A, device="cuda"))
            run = lambda: obj.solve(rtol=tol, maxiter=mx)  # noqa: E731
        else:
            amg, setup_s = synced(torch, lambda: H.BoomerAMG(
                max_coarse_size=1500).setup(A, device="cuda"))
            run = lambda: H.pcg(op.mv, b, M=amg.precond(), rtol=tol,  # noqa
                                maxiter=mx, device="cuda")
        P = amg.precond()
        sstruct_record(f"{label} {A.n_rows} dofs", kernels, torch, held, run,
                       A64, b, x_star, facade_ops("amg", amg),
                       lambda: (P(b), op.mv(b)),
                       dict(secs, setup_s=setup_s, dofs=A.n_rows,
                            levels=level_sizes(amg.hierarchy),
                            formats=describe_formats(amg.hierarchy)))
        del obj, A, A64, b, amg, P, op
        part_done(label, t0)
    return dict(kernels.LAUNCHES), timing


def sstruct_kernel_rows(torch, ops) -> dict:
    """The ported kernels on phase 15's operators at their shapes (the
    system DIA views, U's view, FAC's and Maxwell's banded levels): time,
    bound, the plain version's time and one CSR product's, for the
    kernels line's other_shapes. A DIA view's ``bound_ms`` counts the
    bytes of its layout; ``nnz_bound_ms`` those of the function alone: y
    written, each nonzero's value and int32 column read once, and x at
    the columns they reach. U's view runs the row-list kernel
    (``check_row_list``)."""
    from hypre_tpu_torch.seq import dia as dia_mod
    from hypre_tpu_torch.seq import fastmv

    rng = np.random.default_rng(18)
    rows = {}
    for label, M in ops.items():
        x = torch.from_numpy(rng.standard_normal(M.n_cols)).to(
            "cuda", torch.float32)
        if isinstance(M, dia_mod.DiaMatrix) and M.r_ptr is not None:
            # the row-list kernel (U's coupling view), with both bounds
            csr = csr_of_dia(M, torch)
            lib = (csr @ x[:, None])[:, 0]
            lib_ms = time_ms(lambda: csr @ x[:, None], torch)
            rec = check_row_list(torch, dia_mod, f"sstruct {label}", M, x,
                                 csr, lib, lib_ms)["dia_rows"]
            rows.setdefault("dia_rows", []).append(rec)
            continue
        if isinstance(M, dia_mod.DiaMatrix):
            D, n = M.D, M.n_rows
            csr = csr_of_dia(M, torch)
            name = ("dia_spmv_static" if M.offsets_static is not None
                    else "dia_spmv")
            nbytes = D * n * 4 + 2 * n * 4 + D * 4
            flops = 2.0 * D * n

            def plain(M=M, x=x):
                return dia_mod.dia_spmv_plain(M.dvals, M.offsets, x,
                                              M.margin)
            kern = (lambda M=M, x=x: M.mv(x))
            shape = [D, n]
            nz = int((M.dvals != 0).sum())
            nnz_bms, _ = bound(4 * (n + 2 * nz + min(nz, M.n_cols)),
                               2.0 * nz, "float32")
            extra = {"nonzeros": nz, "nnz_bound_ms": nnz_bms}
        else:
            name = "banded_spmv"
            k, n_pad = M.vals_t.shape
            csr = csr_of_banded(M, torch)
            nbytes = k * n_pad * 8 + M.starts.numel() * 4 \
                + (M.n_cols + M.n_rows) * 4
            flops = 2.0 * k * M.n_rows

            def kern(M=M, x=x):
                return fastmv.banded_spmv(M, x)

            def plain(M=M, x=x):
                return fastmv.banded_spmv_plain(M.vals_t, M.lcols_t,
                                                M.starts, x, M.n_rows, M.B)
            shape = [k, n_pad]
            extra = {}
        y = kern()
        rel, ab = rel_err(y, plain(), torch)
        rel_lib, _ = rel_err(y, (csr @ x[:, None])[:, 0], torch)
        bms, bby = bound(nbytes, flops, "float32")
        tol = 1e-6 if name.startswith("banded") else 0.0
        rec = {"check": name, "operator": f"sstruct {label}",
               "shape": shape, "max_abs_err": ab, "tol": tol,
               "rel_err_vs_csr": rel_lib,
               "ms": time_ms(kern, torch),
               "plain_ms": time_ms(plain, torch, warmup=1, reps=5),
               "bound_ms": bms, "bound_by": bby,
               "library_ms": time_ms(lambda: csr @ x[:, None], torch),
               **extra}
        log(json.dumps(rec))
        require(rel <= tol, f"{name} on {label} differs from the plain "
                f"version by {rel}")
        require(rel_lib <= 1e-5, f"{name} on {label}: rel err {rel_lib} "
                "against the CSR product")
        rows.setdefault(name, []).append(rec)
        if name == "banded_spmv" and M.t_vals is not None:
            rows["banded_spmv_t"] = rows.get("banded_spmv_t", []) + [
                banded_t_row(torch, f"sstruct {label}", M, csr, rng)]
    return rows


def banded_t_row(torch, label, M, csr, rng) -> dict:
    """Kernel 4 on a banded operator's transpose schedule: y = M^T r
    against the plain version and one CSR product of M^T."""
    from hypre_tpu_torch.seq import fastmv

    r = torch.from_numpy(rng.standard_normal(M.n_rows)).to("cuda",
                                                           torch.float32)
    csr_t = csr.t().to_sparse_csr()
    nnz = int(M.t_colptr[-1])
    bms, bby = bound(nnz * 8 + (M.n_rows + M.n_cols) * 4
                     + (M.t_colptr.numel() + M.t_chunks.numel()) * 4,
                     2.0 * nnz, "float32")

    def kern():
        return fastmv.banded_spmv_t(M, r)

    def plain():
        return fastmv.banded_spmv_t_plain(M.t_vals, M.t_rows, M.t_colptr, r)

    y = kern()
    rel, ab = rel_err(y, plain(), torch)
    rel_lib, _ = rel_err(y, (csr_t @ r[:, None])[:, 0], torch)
    rec = {"check": "banded_spmv_t", "operator": label, "nnz": nnz,
           "shape": [M.n_cols, M.n_rows], "max_abs_err": ab, "tol": 1e-6,
           "rel_err_vs_csr": rel_lib, "ms": time_ms(kern, torch),
           "plain_ms": time_ms(plain, torch, warmup=1, reps=5),
           "bound_ms": bms, "bound_by": bby,
           "library_ms": time_ms(lambda: csr_t @ r[:, None], torch)}
    log(json.dumps(rec))
    require(rel <= 1e-6, f"banded_spmv_t on {label}: rel err {rel}")
    require(rel_lib <= 1e-5, f"banded_spmv_t on {label}: rel err "
            f"{rel_lib} against the CSR product")
    return rec


def fac_coarse_operators(fac) -> list:
    """The Galerkin operators FAC's setup stored, dense: each coarser
    level's A, then the matrix its base BoomerAMG was set up on."""
    from hypre_tpu_torch.seq.ell import ell_to_csr

    mats = [lv.A for lv in fac.levels[1:]] + [fac.coarse_A]
    return [ell_to_csr(M).to_dense() for M in mats]


def sstruct_small_runs(torch, device) -> dict:
    """Every SSTRUCT_GOLDEN flag set through the driver on ``device``, in
    float64 and in float32 (at SSTRUCT_F32_TOL), with the kernel formats
    on both devices (``optimize=True``); SysPFMG's cdirs, offsets and
    coefficients and FAC's Galerkin operators; then the nested-patch FAC
    and the two-part FEM problem of tests/test_sstruct.py at their test
    sizes."""
    from hypre_tpu_torch.drivers import sstruct as drv
    from hypre_tpu_torch.krylov import pcg
    from hypre_tpu_torch.seq.ell import ell_to_csr
    from hypre_tpu_torch.sstruct import fac as fac_mod

    out = {}
    for flags, _ in SSTRUCT_GOLDEN:
        for dtype in (torch.float64, torch.float32):
            argv = flags.split()
            if dtype == torch.float32:
                argv = argv[:argv.index("-tol")] + ["-tol",
                                                    str(SSTRUCT_F32_TOL)]
            case = drv.prepare(argv, device=device, dtype=dtype,
                               optimize=True)
            _, info = case.solve()
            rec = {"iterations": int(info.iterations),
                   "converged": bool(info.converged)}
            sp = case.solver
            if hasattr(sp, "cdirs") and hasattr(sp, "coarse_meta"):
                rec["cdirs"] = sp.cdirs
                rec["offsets"] = [list(lv.A.stencil.offsets)
                                  for lv in sp.levels]
                rec["coeffs"] = [lv.A.coeffs.double().cpu().numpy()
                                 for lv in sp.levels]
            if isinstance(sp, fac_mod.FAC):
                rec["coeffs"] = fac_coarse_operators(sp)
            out[(flags, str(dtype))] = rec
    patches = [((2, 2), (8, 8)), ((4, 4), (6, 6))]
    for dtype in (torch.float64, torch.float32):
        A, masks, parents, nn = fac_mod.composite_poisson_nested(
            10, patches, dtype=dtype, device=device)
        fac = fac_mod.FAC().setup(A, masks, parents, device=device,
                                  optimize=True)
        b = torch.from_numpy(np.random.default_rng(7).standard_normal(
            nn)).to(device, dtype)
        _, info = fac.solve(b, rtol=1e-8 if dtype == torch.float64
                            else SSTRUCT_F32_TOL, maxiter=80)
        out[("FAC nested", str(dtype))] = {
            "iterations": int(info.iterations),
            "converged": bool(info.converged),
            "coeffs": fac_coarse_operators(fac)}
        M = fem_two_parts(6, dtype, device)
        dinv = 1.0 / M.A.diagonal()
        _, info = pcg(M.A.mv, M.b, M=lambda r: dinv * r,
                      rtol=1e-10 if dtype == torch.float64
                      else SSTRUCT_F32_TOL, device=device)
        out[("FEM two parts", str(dtype))] = {
            "iterations": int(info.iterations),
            "converged": bool(info.converged),
            "coeffs": [ell_to_csr(M.A).to_dense(), M.b.double().cpu()
                       .numpy()]}
    return out


def sstruct_card_vs_cpu(torch):
    """Phase 15's card-against-CPU part: in float64 the golden iterations
    on both; in both types a converged solve, equal iterations, cdirs and
    offsets, coefficients and Galerkin operators to STRUCT_COEFF_RTOL
    (float32) and 1e-12 (float64)."""
    out = {dev: sstruct_small_runs(torch, dev) for dev in ("cuda", "cpu")}
    golden = dict(SSTRUCT_GOLDEN)
    for key in out["cuda"]:
        flags, dtype = key
        got, want = out["cuda"][key], out["cpu"][key]
        gaps = [float(np.abs(g - w).max(initial=0.0)
                      / max(np.abs(w).max(initial=0.0), 1e-30))
                for g, w in zip(got.pop("coeffs", []),
                                want.pop("coeffs", []))]
        gap = max(gaps, default=0.0)
        tol = STRUCT_COEFF_RTOL if dtype == "torch.float32" else 1e-12
        log(json.dumps({"card_vs_cpu": f"sstruct {flags} ({dtype})",
                        "cuda": {k: v for k, v in got.items()
                                 if k != "offsets"},
                        "cpu": {k: v for k, v in want.items()
                                if k != "offsets"},
                        "coeff_gap": gap}))
        require(got == want, f"sstruct {flags} ({dtype}): card and CPU "
                "differ")
        require(gap <= tol, f"sstruct {flags} ({dtype}): coefficients "
                f"differ by {gap}")
        require(got["converged"], f"sstruct {flags} ({dtype}) did not "
                "converge")
        if dtype == "torch.float64" and flags in golden:
            require(got["iterations"] == golden[flags],
                    f"sstruct {flags}: {got['iterations']} iterations, "
                    f"golden {golden[flags]}")


# ---------------------------------------------------------------------------
# Phase 16: the host C++ setup
# ---------------------------------------------------------------------------


def count_setup_paths(H):
    """Count, from here on, the setup path each BoomerAMG setup takes
    ('native', 'jax' or 'device'): the phases print and clear the counts,
    so that every phase shows which of its setups moved to the host C++
    setup."""
    import collections

    counts = collections.Counter()
    do_setup = H.BoomerAMG._do_setup

    def counted(self, A, where):
        do_setup(self, A, where)
        counts[self.setup_path] += 1

    H.BoomerAMG._do_setup = counted
    return counts


def native_phase(H, kernels, torch, held):
    """Phase 16: the default facade (setup_backend "auto", which takes the
    host C++ setup) at N_MAIN^3 float32 under PCG, the same with
    nongalerkin_tol, and the ij driver's -agg_nl: each prints its setup
    path (which must be 'native'), setup seconds, levels, iterations, warm
    ms and f64 true residual, must converge under TRUE_RESIDUAL_LIMIT and
    launch kernels 1, 3 and 4."""
    from hypre_tpu_torch.drivers import ij

    kernels.reset_launches()
    n = N_MAIN
    A = H.laplacian_3d_7pt(n, n, n, dtype=torch.float32, device="cuda")
    A64 = H.laplacian_3d_7pt(n, n, n, dtype=torch.float64, device="cuda")
    b = torch.ones(A.n_rows, dtype=torch.float32, device="cuda")
    need = ("dia_spmv", "banded_spmv", "banded_spmv_t")
    for label, knobs in (("default", {}),
                         ("nongalerkin", dict(
                             nongalerkin_tol=NONGALERKIN_TOL))):
        t0 = time.perf_counter()
        amg, setup_s = synced(torch, lambda: H.BoomerAMG(
            max_coarse_size=1500, **knobs).setup(A))
        require(amg.setup_path == "native",
                f"facade {label} took the {amg.setup_path!r} setup")
        log(amg.stats())
        op = amg.hierarchy.levels[0].A
        for name, M in facade_ops(f"native {label}", amg):
            hold_dia(M, name, kernels, torch, held)
        (x, info), warm_ms, grew = timed(
            kernels, torch, lambda: H.pcg(op.mv, b, M=amg.precond(),
                                          rtol=NATIVE_RTOL, maxiter=100,
                                          device="cuda"))
        check_solve(f"native facade {label} pcg {n}^3", torch, x, info, A64,
                    b, warm_ms, grew, need=need, extra={
                        "setup_path": amg.setup_path, "knobs": knobs,
                        "setup_s": setup_s,
                        "levels": level_sizes(amg.hierarchy),
                        "formats": describe_formats(amg.hierarchy)})
        del amg, op, x
        torch.cuda.empty_cache()
        log(json.dumps({"phase": "native_phase", "part": label,
                        "seconds": time.perf_counter() - t0}))
    del A, A64, b
    t0 = time.perf_counter()
    case, setup_s = synced(torch, lambda: ij.prepare(
        NATIVE_IJ_FLAGS.split(), device="cuda", dtype=torch.float32))
    paths = [amg.setup_path for amg in case.amgs]
    require(paths == ["native"], f"ij -agg_nl took the {paths} setups")
    hier = case.amgs[0].hierarchy
    (x, info), warm_ms, grew = timed(kernels, torch, case.solve)
    check_solve(f"ij {NATIVE_IJ_FLAGS}", torch, x, info, f64_of(case.A),
                case.b,
                warm_ms, grew, need=need, extra={
                    "setup_path": paths[0], "setup_s": setup_s,
                    "levels": level_sizes(hier),
                    "formats": describe_formats(hier)})
    log(json.dumps({"phase": "native_phase", "part": "ij -agg_nl",
                    "seconds": time.perf_counter() - t0}))
    return dict(kernels.LAUNCHES)


def native_card_vs_cpu(H, kernels, torch):
    """The host C++ setup through the facade at N_PARITY^3, on the card and
    on the CPU (both optimized, so the CPU runs the card's formats by
    their plain versions): the same setup path, levels, C-point counts,
    formats and PCG iterations, in float64 at rtol 1e-8 and in float32 at
    NATIVE_RTOL."""
    n = N_PARITY
    for label, knobs in NATIVE_SMALL_CASES:
        for dtype, rtol in ((torch.float64, 1e-8),
                            (torch.float32, NATIVE_RTOL)):
            out = {}
            for device in ("cuda", "cpu"):
                A = H.laplacian_3d_7pt(n, n, n, dtype=dtype, device=device)
                amg = H.BoomerAMG(max_coarse_size=100, **knobs).setup(
                    A, optimize=True, device=device)
                hier = amg.hierarchy
                b = torch.ones(A.n_rows, dtype=dtype, device=device)
                _, info = H.pcg(hier.levels[0].A.mv, b, M=amg.precond(),
                                rtol=rtol, maxiter=100, device=device)
                out[device] = {
                    "setup_path": amg.setup_path,
                    "levels": level_sizes(hier),
                    "c_points": [int((lv.cf == 1).sum())
                                 for lv in hier.levels],
                    "formats": describe_formats(hier),
                    "iterations": int(info.iterations),
                    "converged": bool(info.converged)}
            tag = f"native {label} {n}^3 {str(dtype).split('.')[1]}"
            log(json.dumps({"card_vs_cpu": tag, **out}))
            require(out["cuda"]["converged"] and out["cpu"]["converged"],
                    f"{tag}: a solve did not converge")
            path = out["cuda"]["setup_path"]
            require(path == "native", f"{tag}: took the {path!r} setup")
            for key in ("setup_path", "levels", "c_points", "formats",
                        "iterations"):
                require(out["cuda"][key] == out["cpu"][key],
                        f"{tag}: {key} differ between card and CPU")


def device_profile_counts(torch, fn, warm_s: float):
    """One call of fn under torch.profiler: the CUDA kernels it ran, their
    device ms, and the device busy share (device ms over ``warm_s``, the
    host wall time of an unprofiled warm call)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    count, dev_ms = 0, 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        count += e.count
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        dev_ms += us / 1e3
    return count, dev_ms, dev_ms / (warm_s * 1e3)


def par_products(H, kernels, torch):
    """Phase 17 (a): the 7-pt PAR_N^3 operator (float32) partitioned into
    each of PAR_SHARDS, ``par_spmv``/``par_spmv_t`` against ``A.mv``/
    ``mv_t``, the halo bytes, and the device ms of a product, of a
    transpose product and of an exchange alone beside kernel 2's on A."""
    from hypre_tpu_torch.parallel import make_mesh, partition_ell
    from hypre_tpu_torch.parallel.par_ell import (
        distribute_vector, exchange, par_spmv, par_spmv_t,
    )
    from hypre_tpu_torch.seq import dia as dia_mod

    n = PAR_N
    A = H.laplacian_3d_7pt(n, n, n, dtype=torch.float32, device="cuda")
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        A.n_rows)).to("cuda", torch.float32)
    y_ref, yt_ref = A.mv(x), A.mv_t(x)
    D = dia_mod.try_dia(A)
    offs = tuple(D.offsets.tolist())
    k2_ms = uncounted(kernels, lambda: time_ms(
        lambda: dia_mod.dia_spmv_static(D.dvals, offs, x, D.n_cols), torch))
    nbytes = (D.dvals.numel() + 2 * A.n_rows) * 4
    k2_bound, _ = bound(nbytes, 2 * D.dvals.numel(), "float32")
    for P in PAR_SHARDS:
        mesh = make_mesh(P, device="cuda")
        Ap, part_s = synced(torch, lambda: partition_ell(A, mesh))
        xd = distribute_vector(x, mesh)
        before = dict(kernels.LAUNCHES)
        y = par_spmv(Ap, xd)[: A.n_rows]
        yt = par_spmv_t(Ap, xd)[: A.n_cols]
        torch.cuda.synchronize()
        require(kernels.LAUNCHES == before,
                f"{P} shards: a distributed product launched a kernel")
        err = float((y - y_ref).abs().max() / y_ref.abs().max())
        err_t = float((yt - yt_ref).abs().max() / yt_ref.abs().max())
        send = xd[Ap.send_index]
        rec = {"parallel": "products", "shards": P, "n": A.n_rows,
               "partition_s": part_s, "offsets": list(Ap.offsets),
               "halo_sizes": list(Ap.sizes),
               "exchange_bytes": Ap.exchange_bytes(),
               "rel_err_spmv": err, "rel_err_spmv_t": err_t,
               "par_spmv_ms": time_ms(lambda: par_spmv(Ap, xd), torch),
               "par_spmv_t_ms": time_ms(lambda: par_spmv_t(Ap, xd), torch),
               "exchange_ms": time_ms(lambda: exchange(
                   mesh, send, Ap.offsets, Ap.sizes), torch),
               "kernel2_ms": k2_ms, "kernel2_bound_ms": k2_bound}
        log(json.dumps(rec))
        require(err <= PAR_SPMV_RTOL and err_t <= PAR_SPMV_RTOL,
                f"{P} shards: par_spmv off A.mv by {err}, par_spmv_t by "
                f"{err_t}")
        if P == 8:
            require(Ap.exchange_bytes() == 8 * 2 * n * n * 4,
                    f"8 shards move {Ap.exchange_bytes()} bytes an "
                    f"exchange, not 8 * 2 * {n}^2 * 4")
        del Ap, xd, send
    torch.cuda.empty_cache()


def column_ordered(H, torch, A):
    """A with each row's slots in column order, padding last: the order
    ``setup_hierarchy_par`` keeps its rows in, so that the single-device
    setup on it adds the same terms in the same order."""
    key = torch.where(A.cols >= 0, A.cols, torch.full_like(A.cols, 2**30))
    _, order = torch.sort(key, dim=1, stable=True)
    return H.EllMatrix(vals=torch.gather(A.vals, 1, order),
                       cols=torch.gather(A.cols, 1, order), n_cols=A.n_cols)


def par_setup_solve(H, kernels, torch):
    """Phase 17 (b), (c): setup_hierarchy_par on PAR_SETUP_SHARDS shards
    of the PAR_N^3 operator (float32), its level sizes against
    setup_hierarchy_device's on the same A in column order (unpadded), and
    PCG + amg_cycle (l1-Jacobi) on both: equal iterations."""
    from hypre_tpu_torch.parallel import make_mesh, partition_ell
    from hypre_tpu_torch.parallel.par_ell import distribute_vector
    from hypre_tpu_torch.parallel.par_setup import setup_hierarchy_par

    n = PAR_N
    dt = torch.float32
    A = H.laplacian_3d_7pt(n, n, n, dtype=dt, device="cuda")
    A64 = f64_of(A)
    mesh = make_mesh(PAR_SETUP_SHARDS, device="cuda")
    Ap = partition_ell(A, mesh)
    stats = []
    hier, setup_s = synced(torch, lambda: setup_hierarchy_par(
        Ap, max_coarse_size=PAR_MAX_COARSE, level_stats=stats))
    sizes = [lv.A.n_rows for lv in hier.levels] + [hier.levels[-1].P.n_cols]
    ref, ref_s = synced(torch, lambda: H.setup_hierarchy_device(
        column_ordered(H, torch, A), max_coarse_size=PAR_MAX_COARSE,
        device="cuda"))
    log(json.dumps({"parallel": "setup", "shards": PAR_SETUP_SHARDS,
                    "setup_s": setup_s, "levels": sizes, "per_level": stats,
                    "device_setup_s": ref_s,
                    "device_setup_levels": list(ref.n_level_true)}))
    require(sizes == list(ref.n_level_true),
            f"distributed levels {sizes} != single-device "
            f"{list(ref.n_level_true)}")
    ref = H.unpad_hierarchy(ref)
    sm = H.make_smoother("l1-jacobi", 1.0, 2, 0.3)
    b = torch.ones(A.n_rows, dtype=dt, device="cuda")
    bd = distribute_vector(b, mesh)

    def dist_solve():
        return H.pcg(hier.levels[0].A.mv, bd,
                     M=lambda r: H.amg_cycle(hier, r, smoother=sm),
                     rtol=PAR_RTOL, maxiter=100, device="cuda")

    (x, info), warm_ms, grew = timed(kernels, torch, dist_solve)
    require(not any(grew.values()),
            f"the distributed solve launched ported kernels: {grew}")
    count, dev_ms, busy = device_profile_counts(torch, dist_solve,
                                                warm_ms / 1e3)
    it = max(int(info.iterations), 1)
    check_solve(f"parallel pcg {n}^3 {PAR_SETUP_SHARDS} shards", torch,
                x[: A.n_rows], info, A64, b, warm_ms, grew, extra={
                    "device_kernels_per_iteration": count / it,
                    "device_ms": dev_ms, "busy_share": busy})
    (x1, info1), warm1, grew1 = timed(kernels, torch, lambda: H.pcg(
        ref.levels[0].A.mv, b, M=lambda r: H.amg_cycle(ref, r, smoother=sm),
        rtol=PAR_RTOL, maxiter=100, device="cuda"))
    check_solve(f"single-device pcg {n}^3 (the device setup)", torch, x1,
                info1, A64, b, warm1, grew1)
    require(int(info.iterations) == int(info1.iterations),
            f"distributed PCG took {int(info.iterations)} iterations, "
            f"single-device {int(info1.iterations)}")
    del hier, ref, Ap, A, x, x1
    torch.cuda.empty_cache()


def par_facade(H, kernels, torch):
    """Phase 17 (d): the default facade's (host C++) hierarchy at PAR_N^3
    float32, its ELL payload partitioned over PAR_SETUP_SHARDS shards,
    under PCG with the facade's smoother: the facade's own iterations."""
    from hypre_tpu_torch.parallel import make_mesh
    from hypre_tpu_torch.parallel.par_amg import partition_hierarchy
    from hypre_tpu_torch.parallel.par_ell import distribute_vector

    n = PAR_N
    A = H.laplacian_3d_7pt(n, n, n, dtype=torch.float32, device="cuda")
    A64 = f64_of(A)
    amg, setup_s = synced(torch, lambda: H.BoomerAMG(
        max_coarse_size=PAR_MAX_COARSE).setup(A))
    require(amg.setup_path == "native",
            f"the default facade took the {amg.setup_path!r} setup")
    mesh = make_mesh(PAR_SETUP_SHARDS, device="cuda")
    part, part_s = synced(torch, lambda: partition_hierarchy(
        amg.ell_hierarchy, mesh))
    b = torch.ones(A.n_rows, dtype=torch.float32, device="cuda")
    bd = distribute_vector(b, mesh)
    (x, info), warm_ms, grew = timed(kernels, torch, lambda: H.pcg(
        part.levels[0].A.mv, bd,
        M=lambda r: H.amg_cycle(part, r, smoother=amg._smoother),
        rtol=PAR_RTOL, maxiter=100, device="cuda"))
    require(not any(grew.values()),
            f"the partitioned solve launched ported kernels: {grew}")
    check_solve(f"partitioned facade pcg {n}^3", torch, x[: A.n_rows], info,
                A64, b, warm_ms, grew, extra={
                    "setup_s": setup_s, "partition_s": part_s,
                    "levels": level_sizes(amg.hierarchy)})
    op = amg.hierarchy.levels[0].A
    (x1, info1), warm1, grew1 = timed(kernels, torch, lambda: H.pcg(
        op.mv, b, M=amg.precond(), rtol=PAR_RTOL, maxiter=100,
        device="cuda"))
    check_solve(f"facade pcg {n}^3 (unpartitioned)", torch, x1, info1, A64,
                b, warm1, grew1, need=("dia_spmv", "banded_spmv",
                                       "banded_spmv_t"))
    require(int(info.iterations) == int(info1.iterations),
            f"partitioned facade took {int(info.iterations)} iterations, "
            f"unpartitioned {int(info1.iterations)}")
    del amg, part, op, x, x1
    torch.cuda.empty_cache()


def par_ij_mm(torch):
    """Phase 17 (e): ij_mm jobs IJ_MM_JOBS on the 7-pt PAR_N^3 (float32),
    and -verify 1 against the host C++ oracle at IJ_MM_VERIFY_N^3."""
    import contextlib
    import io

    from hypre_tpu_torch.drivers import ij_mm

    n, m = PAR_N, IJ_MM_VERIFY_N
    runs = [(f"-n {n} {n} {n} -7pt -job {j}", False) for j in IJ_MM_JOBS]
    runs += [(f"-n {m} {m} {m} -7pt -job {j} -verify 1", True)
             for j in IJ_MM_JOBS]
    for flags, verify in runs:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            dt = ij_mm.run(flags.split(), device="cuda")
        text = out.getvalue().strip()
        log(text)
        log(json.dumps({"ij_mm": flags, "seconds_per_product": dt,
                        "run_s": time.perf_counter() - t0}))
        require(not verify or "verify: passed" in text,
                f"ij_mm {flags}: {text}")


def parallel_phase(H, kernels, torch):
    """Phase 17: hypre's ParCSR layer on the card (the local backend)."""
    kernels.reset_launches()
    for part, fn in (("products", lambda: par_products(H, kernels, torch)),
                     ("setup_solve", lambda: par_setup_solve(H, kernels,
                                                            torch)),
                     ("facade", lambda: par_facade(H, kernels, torch)),
                     ("ij_mm", lambda: par_ij_mm(torch))):
        t0 = time.perf_counter()
        fn()
        log(json.dumps({"phase": "parallel_phase", "part": part,
                        "seconds": time.perf_counter() - t0}))
    return dict(kernels.LAUNCHES)


def parallel_card_vs_cpu(H, torch):
    """Phase 17 (f): the distributed split, setup and PCG at N_PARITY^3 on
    PAR_SETUP_SHARDS shards, on the card and on the CPU, in float64 and
    float32: the same CF splitting, level sizes and iterations."""
    from hypre_tpu_torch.parallel import make_mesh, partition_ell
    from hypre_tpu_torch.parallel.par_ell import distribute_vector
    from hypre_tpu_torch.parallel.par_setup import (
        par_split_phase, setup_hierarchy_par,
    )

    n = N_PARITY
    sm = H.make_smoother("l1-jacobi", 1.0, 2, 0.3)
    for dtype, rtol in ((torch.float64, 1e-8), (torch.float32, PAR_RTOL)):
        out, cfs = {}, {}
        for device in ("cuda", "cpu"):
            A = H.laplacian_3d_7pt(n, n, n, dtype=dtype, device=device)
            mesh = make_mesh(PAR_SETUP_SHARDS, device=device)
            Ap = partition_ell(A, mesh)
            cfs[device] = par_split_phase(Ap, 0.25, 12)[2].cpu()
            hier = setup_hierarchy_par(Ap, max_coarse_size=100)
            b = distribute_vector(torch.ones(A.n_rows, dtype=dtype,
                                             device=device), mesh)
            _, info = H.pcg(Ap.mv, b,
                            M=lambda r: H.amg_cycle(hier, r, smoother=sm),
                            rtol=rtol, maxiter=100, device=device)
            out[device] = {
                "levels": [lv.A.n_rows for lv in hier.levels]
                + [hier.levels[-1].P.n_cols],
                "c_points": int((cfs[device] == 1).sum()),
                "iterations": int(info.iterations),
                "converged": bool(info.converged)}
        tag = f"parallel {n}^3 {str(dtype).split('.')[1]}"
        log(json.dumps({"card_vs_cpu": tag, **out}))
        require(out["cuda"]["converged"] and out["cpu"]["converged"],
                f"{tag}: a solve did not converge")
        require(torch.equal(cfs["cuda"], cfs["cpu"]),
                f"{tag}: the CF splits differ")
        for key in ("levels", "iterations"):
            require(out["cuda"][key] == out["cpu"][key],
                    f"{tag}: {key} differ between card and CPU")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import hypre_tpu_torch as H
    from hypre_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False  # coarse solve in full f32
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = t_run = time.perf_counter()
    kernels.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for stem, out in kernels.BUILD_LOG.items():
        log(f"--- nvcc {stem}.cu ---\n{out.strip()}")

    paths = count_setup_paths(H)

    def phase_done(name, t0, **more):
        """The phase's seconds and the setup paths its BoomerAMG setups
        took (counts cleared for the next phase)."""
        log(json.dumps({"phase": name, "seconds": time.perf_counter() - t0,
                        "setup_paths": dict(paths), **more}))
        paths.clear()

    hier, fast, l_dyn, it_dyn = run_main_path(H, kernels, torch, False)
    _, _, l_st, it_st = run_main_path(H, kernels, torch, True, hier=hier)
    require(it_dyn == it_st, f"dynamic ({it_dyn}) and specialized ({it_st}) "
            "solves took different iteration counts")
    for name in ("dia_spmv", "banded_spmv", "banded_spmv_t"):
        require(l_dyn[name] > 0, f"dynamic path never launched {name}")
    for name in ("dia_spmv_static", "banded_spmv", "banded_spmv_t"):
        require(l_st[name] > 0, f"specialized path never launched {name}")
    per_iteration_launches(H, kernels, torch, fast)

    hier_td, fast_td, l_td, it_td = run_bench_path(H, kernels, torch, True)
    hier_bp, fast_bp, l_bp, it_bp = run_bench_path(H, kernels, torch, False)
    require(it_td == it_bp, f"TransferDia ({it_td}) and banded-P ({it_bp}) "
            "hierarchies took different iteration counts")
    require(level_sizes(hier_td) == level_sizes(hier_bp)
            and hier_td.n_level_true == hier_bp.n_level_true,
            "the two device setups built different levels")

    t0 = time.perf_counter()
    results = check_kernels(H, torch, hier, fast)
    at_new_shapes, _ = check_transfer_kernels(
        H, torch, fast_td[False].levels[0].P, fast_td[True].levels[0].P,
        hier_bp, fast_bp[False])
    for rec in results.pop("d27"):
        at_new_shapes[rec["check"]].append(rec)
    from hypre_tpu_torch.seq import dia as dia_mod

    row_lanes_sweep(torch, dia_mod)
    del hier, fast, hier_td, fast_td, hier_bp, fast_bp
    torch.cuda.empty_cache()
    phase_done("kernels", t0)
    t0 = time.perf_counter()
    l_facade, _ = run_facade_path(H, kernels, torch)
    phase_done("facade_path", t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    card_vs_cpu(H, kernels, torch)
    device_setup_card_vs_cpu(H, kernels, torch)
    device_setup_twice(H, torch)
    phase_done("card_vs_cpu", t0)
    t0 = time.perf_counter()
    facade_options_card_vs_cpu(H, kernels, torch)
    phase_done("facade_options_card_vs_cpu", t0)
    held = []  # the new phases' DIA operators, each held against plain
    new_phases = []
    for phase in (other_problems_phase, ij_phase, reduction_phase):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        new_phases.append(phase(H, kernels, torch, held))
        phase_done(phase.__name__, t0)
    t0 = time.perf_counter()
    small_card_vs_cpu(H, kernels, torch)
    phase_done("small_card_vs_cpu", t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    new_phases.append(aux_phase(H, kernels, torch, held))
    phase_done("aux_phase", t0)
    t0 = time.perf_counter()
    aux_card_vs_cpu(H, kernels, torch)
    phase_done("aux_card_vs_cpu", t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    new_phases.append(precond_phase(H, kernels, torch, held))
    phase_done("precond_phase", t0)
    t0 = time.perf_counter()
    precond_card_vs_cpu(H, kernels, torch)
    phase_done("precond_card_vs_cpu", t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    l_struct, struct_ops = struct_phase(H, kernels, torch, held)
    new_phases.append(l_struct)
    for name, recs in struct_kernel_rows(torch, struct_ops).items():
        at_new_shapes[name].extend(recs)
    del struct_ops
    phase_done("struct_phase", t0)
    t0 = time.perf_counter()
    struct_card_vs_cpu(torch)
    phase_done("struct_card_vs_cpu", t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    l_sstruct, sstruct_ops = sstruct_phase(H, kernels, torch, held)
    new_phases.append(l_sstruct)
    for name, recs in sstruct_kernel_rows(torch, sstruct_ops).items():
        at_new_shapes.setdefault(name, []).extend(recs)
    del sstruct_ops
    phase_done("sstruct_phase", t0)
    t0 = time.perf_counter()
    sstruct_card_vs_cpu(torch)
    phase_done("sstruct_card_vs_cpu", t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    new_phases.append(native_phase(H, kernels, torch, held))
    phase_done("native_phase", t0)
    t0 = time.perf_counter()
    native_card_vs_cpu(H, kernels, torch)
    phase_done("native_card_vs_cpu", t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    new_phases.append(parallel_phase(H, kernels, torch))
    phase_done("parallel_phase", t0)
    t0 = time.perf_counter()
    parallel_card_vs_cpu(H, torch)
    phase_done("parallel_card_vs_cpu", t0)
    log(json.dumps({"run_seconds": time.perf_counter() - t_run}))

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # the row-list shapes' second yardstick and variant times
    extra_keys = ("operator", "nnz_bound_ms", "variants_ms")
    path_launches = [l_dyn, l_st, l_td[False], l_td[True], l_bp[False],
                     l_bp[True], l_facade] + new_phases
    line = []
    for name, (src, replaces) in SOURCES.items():
        more = list(at_new_shapes.get(name, []))
        # the row-list kernels run on the bench hierarchy's transfer planes
        # only: their first shape is P_dia
        rc = results[name] if name in results else more.pop(0)
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces,
                 "launches": sum(l[name] for l in path_launches)}
        entry.update({k: rc[k] for k in keys + extra_keys if k in rc})
        # the worst error over every shape checked, beside the first
        # shape's times; the other shapes follow
        entry["max_abs_err"] = max([rc["max_abs_err"]]
                                   + [m["max_abs_err"] for m in more])
        entry["other_shapes"] = [
            dict({"operator": m["operator"], "shape": m["shape"]},
                 **{k: m[k] for k in keys + extra_keys if k in m})
            for m in more]
        # the operators of phases 8-10, one launch each against plain
        checked = [h for h in held if h["kernel"] == name]
        if checked:
            entry["max_abs_err"] = max([entry["max_abs_err"]]
                                       + [h["max_abs_err"] for h in checked])
            entry["checked_on_path"] = checked
        line.append(entry)
    print(smi, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
