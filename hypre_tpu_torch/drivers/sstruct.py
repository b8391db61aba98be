"""sstruct driver — mirrors ``src/test/sstruct.c`` and the TEST_sstruct
golden suite.

Counterpart of ``hypre_tpu/drivers/sstruct.py``, with the same flags,
solver ids and output lines. Default problem: two n x n parts glued along
an edge through graph entries (the ``sstruct.in.default`` / ex8 multipart
pattern), assembled as parts + U matrix:

   10  PCG + Split(SMG per part)       11  PCG + Split(PFMG per part)
   20  Split standalone (block-diagonal per-part MG, U couplings lagged)
    3  SysPFMG standalone on a two-variable coupled diffusion system
       (-eps sets the inter-variable coupling)
   28  FAC standalone on a composite AMR Poisson grid with a 2x-refined
       central patch
  120  AMS-based Maxwell on the 2-D edge curl-curl system (-beta sets the
       mass shift), assembled sparsely

    Iterations = N
    Final Relative Residual Norm = X

``run(argv, device=None, dtype=None)`` runs on ``device`` (CUDA unless the
caller names another) in ``dtype`` (float32 unless the caller names
another); ``prepare`` does the same up to the solve and hands back the
set-up case:

    python -m hypre_tpu_torch.drivers.sstruct -solver 11 -n 64
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable

import numpy as np
import torch

SOLVER_IDS = (3, 10, 11, 20, 28, 120)


def two_part_problem(n, dtype=None, device=None):
    """(grid, SStructMatrix): two n x n 5-pt Laplacian parts, cells
    (n-1, j) of part 0 coupled to (0, j) of part 1 both ways."""
    from hypre_tpu_torch.problems.struct_problems import struct_laplacian
    from hypre_tpu_torch.sstruct import SStructGrid
    from hypre_tpu_torch.sstruct.matrix import (
        SStructGraphBuilder, sstruct_matrix,
    )

    grid = SStructGrid(((n, n), (n, n)))
    parts = [struct_laplacian((n, n), dtype=dtype, device=device)
             for _ in range(2)]
    g = SStructGraphBuilder(grid)
    for j in range(n):
        g.add_entry(0, (n - 1, j), 1, (0, j), -1.0)
        g.add_entry(1, (0, j), 0, (n - 1, j), -1.0)
    return grid, sstruct_matrix(parts, grid, g)


def coupled_system(n, eps, dtype=None, device=None):
    """[L, eps I; eps I, L] on one n x n part, L the 5-pt Laplacian: two
    variables coupled at the stencil centre."""
    from hypre_tpu_torch.core.config import resolve_device
    from hypre_tpu_torch.problems.struct_problems import struct_laplacian
    from hypre_tpu_torch.sstruct.syspfmg import SysStructMatrix

    L = struct_laplacian((n, n), dtype=torch.float64, device="cpu")
    st = L.stencil
    S = st.size
    coeffs = np.zeros((2, 2, S, n, n))
    coeffs[0, 0] = np.broadcast_to(L.coeffs.numpy()[:, None, None],
                                   (S, n, n))
    coeffs[1, 1] = coeffs[0, 0]
    ci = st.center_index()
    coeffs[0, 1, ci] = eps
    coeffs[1, 0, ci] = eps
    return SysStructMatrix(
        coeffs=torch.from_numpy(coeffs).to(resolve_device(device),
                                           dtype or torch.float32),
        stencil=st, shape=(n, n))


def curl_curl(n, beta, dtype=None, device=None):
    """C^T C + beta I over the edges of an n x n cell grid (x-edges, then
    y-edges, each in C order), C the cell-by-edge curl with +1 on the
    bottom and right edges and -1 on the top and left: C as ELL, then the
    port's SpGEMM (the reference multiplies a dense C)."""
    from hypre_tpu_torch.core.config import resolve_device
    from hypre_tpu_torch.seq.csr import HostCSR
    from hypre_tpu_torch.seq.ell import EllMatrix, csr_to_ell
    from hypre_tpu_torch.seq.spgemm import ell_add, ell_spgemm, ell_transpose

    device = resolve_device(device)
    x_edges = n * (n + 1)
    ne = x_edges + (n + 1) * n
    i, j = (a.reshape(-1) for a in np.meshgrid(np.arange(n), np.arange(n),
                                               indexing="ij"))
    edges = np.stack([i * (n + 1) + j, x_edges + (i + 1) * n + j,
                      i * (n + 1) + j + 1, x_edges + i * n + j], axis=1)
    signs = np.tile([1.0, 1.0, -1.0, -1.0], (n * n, 1))
    C = csr_to_ell(HostCSR.from_coo(np.repeat(np.arange(n * n), 4),
                                    edges.reshape(-1), signs.reshape(-1),
                                    (n * n, ne)),
                   dtype=torch.float64, device=device)
    CtC = ell_spgemm(ell_transpose(C), C)
    eye = EllMatrix(vals=torch.ones((ne, 1), dtype=torch.float64,
                                    device=device),
                    cols=torch.arange(ne, dtype=torch.int32,
                                      device=device)[:, None], n_cols=ne)
    A = ell_add(1.0, CtC, beta, eye)
    return dataclasses.replace(A, vals=A.vals.to(dtype or torch.float32))


def parse_args(argv):
    a = dict(solver=10, n=16, tol=1e-6, max_iter=200, eps=0.1, beta=0.05)
    i = 0
    while i < len(argv):
        f = argv[i]

        def take():
            nonlocal i
            i += 1
            return argv[i]

        if f == "-solver":
            a["solver"] = int(take())
        elif f == "-n":
            a["n"] = int(take())
        elif f == "-tol":
            a["tol"] = float(take())
        elif f == "-max_iter":
            a["max_iter"] = int(take())
        elif f == "-eps":
            a["eps"] = float(take())
        elif f == "-beta":
            a["beta"] = float(take())
        elif f == "-help":
            print(__doc__)
            raise SystemExit(0)
        else:
            raise SystemExit(f"unknown flag {f}")
        i += 1
    return a


@dataclasses.dataclass
class Case:
    """A set-up sstruct driver case: the parsed flags, the operator, the
    flags' right-hand side (random normal from seed 0, as the reference
    draws it), the solver object (SplitSolver, SysPFMG, FAC or Maxwell)
    and ``solve(rhs=None)`` -> (x, info), for ``b`` or another rhs."""

    args: dict
    A: object
    b: torch.Tensor
    solver: object
    solve: Callable[..., tuple]


def prepare(argv, device=None, dtype=None, optimize="auto") -> Case:
    """Parse ``argv``, build the problem and set up the solver on
    ``device`` (CUDA unless the caller names another) in ``dtype``
    (float32 unless the caller names another). ``optimize``: the kernel
    formats for FAC's and Maxwell's operators and inner BoomerAMGs
    ('auto': on CUDA; True on the CPU runs their plain versions)."""
    from hypre_tpu_torch.core.config import resolve_device
    from hypre_tpu_torch.krylov import pcg
    from hypre_tpu_torch.sstruct import (
        FAC, Maxwell, SplitSolver, SStructGrid, SysPFMG,
    )
    from hypre_tpu_torch.sstruct.fac import composite_poisson_2d

    a = parse_args(argv)
    s, n, tol, mx = a["solver"], a["n"], a["tol"], a["max_iter"]
    if s not in SOLVER_IDS:
        raise SystemExit(f"unknown -solver {s}")
    device = resolve_device(device)
    dtype = dtype or torch.float32
    rng = np.random.default_rng(0)

    def rhs(shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(device, dtype)

    if s in (10, 11, 20):
        _, A = two_part_problem(n, dtype=dtype, device=device)
        b = rhs(A.n_rows)
        if s == 20:
            sp = SplitSolver().setup(A)
            return Case(a, A, b, sp, lambda r=b: sp.solve(
                r, rtol=tol, maxiter=mx))
        sp = SplitSolver(solver="smg" if s == 10 else "pfmg").setup(A)
        return Case(a, A, b, sp, lambda r=b: pcg(
            A.as_linear_op(), r, M=sp.precond(), rtol=tol, maxiter=mx,
            device=device))
    if s == 3:
        A = coupled_system(n, a["eps"], dtype=dtype, device=device)
        b = rhs((2, n, n))
        sp = SysPFMG(max_coarse_size=128).setup(A)
        return Case(a, A, b, sp, lambda r=b: sp.solve(r, rtol=tol,
                                                      maxiter=mx))
    if s == 28:
        q = max(n // 3, 2)
        A, fine_mask, parent, (_, ntot) = composite_poisson_2d(
            n, (q, q), (2 * q, 2 * q), dtype=dtype, device=device)
        b = rhs(ntot)
        fac = FAC().setup(A, fine_mask, parent, device=device,
                          optimize=optimize)
        return Case(a, A, b, fac, lambda r=b: fac.solve(r, rtol=tol,
                                                        maxiter=mx))
    A = curl_curl(n, a["beta"], dtype=dtype, device=device)
    grid = SStructGrid(((n + 1, n + 1),))  # node dims: n x n cells
    b = rhs(A.n_rows)
    mw = Maxwell().setup(A, grid, device=device, optimize=optimize)
    return Case(a, A, b, mw, lambda r=b: mw.solve(r, rtol=tol, maxiter=mx))


def run(argv, device=None, dtype=None) -> tuple[int, float]:
    """``prepare`` and solve, then print the two lines; returns
    (iterations, final relative residual norm)."""
    _, info = prepare(argv, device=device, dtype=dtype).solve()
    iters = int(info.iterations)
    rel = float(info.relative_residual)
    print(f"Iterations = {iters}")
    print(f"Final Relative Residual Norm = {rel:.6e}")
    return iters, rel


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
