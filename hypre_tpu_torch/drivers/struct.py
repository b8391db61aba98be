"""struct driver — mirrors ``src/test/struct.c`` (solver ids at
struct.c:1604-1626).

Counterpart of ``hypre_tpu/drivers/struct.py``, with the same flags,
solver ids and output lines:

    0 = SMG            1 = PFMG           2 = SparseMSG      8 = Jacobi
   10 = SMG-PCG       11 = PFMG-PCG      12 = SparseMSG-PCG  17 = DS-PCG
   18 = PCG           20/21/22 = Hybrid (SMG / PFMG / SparseMSG escalation)
   30 = SMG-GMRES     31 = PFMG-GMRES    32 = SparseMSG-GMRES

    Iterations = N
    Final Relative Residual Norm = X

``run(argv, device=None, dtype=None)`` runs on ``device`` (CUDA unless the
caller names another) in ``dtype`` (float32 unless the caller names
another; the reference takes its type from JAX's x64 switch); ``prepare``
does the same up to the solve and hands back the set-up case:

    python -m hypre_tpu_torch.drivers.struct -solver 11 -n 64 64 1
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable

import numpy as np
import torch

SOLVER_IDS = (0, 1, 2, 8, 10, 11, 12, 17, 18, 20, 21, 22, 30, 31, 32)


def parse_args(argv):
    a = dict(
        solver=1, nx=32, ny=32, nz=1, tol=1e-6, max_iter=200,
        cx=1.0, cy=1.0, cz=1.0, n_pre=1, n_post=1, rhs="ones",
        relax=1,
    )
    i = 0
    while i < len(argv):
        f = argv[i]

        def take(n=1):
            nonlocal i
            vals = argv[i + 1: i + 1 + n]
            i += n
            return vals if n > 1 else vals[0]
        if f == "-solver":
            a["solver"] = int(take())
        elif f == "-n":
            a["nx"], a["ny"], a["nz"] = (int(v) for v in take(3))
        elif f == "-c":
            a["cx"], a["cy"], a["cz"] = (float(v) for v in take(3))
        elif f == "-tol":
            a["tol"] = float(take())
        elif f == "-max_iter":
            a["max_iter"] = int(take())
        elif f == "-v":
            a["n_pre"], a["n_post"] = (int(v) for v in take(2))
        elif f == "-relax":
            a["relax"] = int(take())
        elif f == "-rhsrand":
            a["rhs"] = "rand"
        elif f == "-jump":
            a["jump"] = int(take())
        else:
            raise SystemExit(f"unknown flag {f}")
        i += 1
    return a


@dataclasses.dataclass
class Case:
    """A set-up struct driver case: the parsed flags, the operator, the
    flags' right-hand side, the solver object the id sets up (PFMG, SMG,
    SparseMSG, StructJacobi or StructHybrid; None for ids 17 and 18) and
    ``solve(rhs=None)`` -> (x, info), for ``b`` or a grid-shaped ``rhs``."""

    args: dict
    A: object
    b: torch.Tensor
    mg: object
    solve: Callable[..., tuple]


def prepare(argv, device=None, dtype=None) -> Case:
    """Parse ``argv``, build the problem and set up the solver on
    ``device`` (CUDA unless the caller names another) in ``dtype``
    (float32 unless the caller names another); the solve waits for
    ``Case.solve()``, which may take another right-hand side."""
    from hypre_tpu_torch.core.config import resolve_device
    from hypre_tpu_torch.krylov import gmres, pcg
    from hypre_tpu_torch.problems.struct_problems import struct_laplacian
    from hypre_tpu_torch.struct import (
        PFMG, SMG, SparseMSG, StructHybrid, StructJacobi,
    )
    from hypre_tpu_torch.struct.relax import diag_inverse

    a = parse_args(argv)
    s = a["solver"]
    if s not in SOLVER_IDS:
        raise SystemExit(f"unsupported solver id {s}")
    device = resolve_device(device)
    dtype = dtype or torch.float32
    shape = (a["nx"], a["ny"]) if a["nz"] <= 1 else (a["nx"], a["ny"],
                                                      a["nz"])
    weights = (a["cx"], a["cy"], a["cz"])[: len(shape)]
    A = struct_laplacian(shape, weights=weights, dtype=dtype, device=device)
    if a["rhs"] == "rand":
        b = torch.from_numpy(np.random.default_rng(0).random(shape)).to(
            device, dtype)
    else:
        b = torch.ones(shape, dtype=dtype, device=device)

    relax_name = {0: "jacobi", 1: "jacobi", 2: "rb-gs"}.get(a["relax"],
                                                           "rb-gs")
    kw = dict(rtol=a["tol"], maxiter=a["max_iter"])
    if s in (20, 21, 22):
        # Hybrid with SMG/PFMG/SparseMSG escalation (SparseMSG escalation
        # maps onto the PFMG branch, as in the reference)
        mg = StructHybrid(precond_type="smg" if s == 20 else "pfmg",
                          precond_knobs=dict(num_pre_relax=a["n_pre"],
                                             num_post_relax=a["n_post"])
                          ).setup(A)
        return Case(a, A, b, mg, lambda rhs=b: mg.solve(rhs, rtol=a["tol"]))
    if s in (0, 10, 30):
        mg = SMG(num_pre_relax=a["n_pre"], num_post_relax=a["n_post"])
    elif s in (1, 11, 31):
        mg = PFMG(relax_type=relax_name, num_pre_relax=a["n_pre"],
                  num_post_relax=a["n_post"])
    elif s in (2, 12, 32):
        mg = SparseMSG(jump=a.get("jump", 0))
    elif s == 8:
        mg = StructJacobi()
    else:
        mg = None
    if mg is not None:
        mg = mg.setup(A)
    if s in (0, 1, 2, 8):
        return Case(a, A, b, mg, lambda rhs=b: mg.solve(rhs, **kw))
    if s == 17:
        dinv = diag_inverse(A).reshape(-1)
        M = lambda r: dinv * r  # noqa: E731
    else:
        M = None if mg is None else mg.precond()
    krylov = gmres if s in (30, 31, 32) else pcg
    return Case(a, A, b, mg, lambda rhs=b: krylov(
        A.as_linear_op(), rhs.reshape(-1), M=M, device=device, **kw))


def run(argv, device=None, dtype=None) -> tuple[int, float]:
    """``prepare`` and solve, then print the two lines; returns
    (iterations, final relative residual norm)."""
    _, info = prepare(argv, device=device, dtype=dtype).solve()
    iters = int(info.iterations)
    rel = float(info.relative_residual)
    print(f"Iterations = {iters}")
    print(f"Final Relative Residual Norm = {rel:e}")
    return iters, rel


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
