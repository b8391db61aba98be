"""Saddle-point solvers and preconditioners — Uzawa and block preconditioning.

Counterpart of ``hypre_tpu/precond/saddle.py``, the analogues of the
FEI/LSI solvers for mixed (velocity/pressure) systems:
``FEI_mv/fei-hypre/HYPRE_LSI_UZAWA.cxx`` (Uzawa iteration with an A11
sub-solver and an S22 Schur sub-solver) and ``HYPRE_LSI_blkprec.cxx``
(block factorization preconditioner with a pressure Schur approximation
built from diag(A11)); ``HYPRE_LSI_schur.cxx``'s reduction is
``BlockPrecond.solve_reduced``.

The block system is

    [ A   Bt ] [u]   [f]
    [ B  -C  ] [p] = [g]

with A SPD (velocity), B the divergence and C >= 0 a stabilization. The
blocks stay ELL operators, the A11 solves are BoomerAMG cycles, and
S_hat = B diag(A)^{-1} Bt + C comes from ``ell_spgemm`` once at setup
(the reference calls its C++ SpGEMM). On the card (``optimize``) the
solves apply the blocks, S_hat and the A11 hierarchy through their
kernel formats (DIA for the stencil blocks).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from hypre_tpu_torch.amg.boomeramg import BoomerAMG
from hypre_tpu_torch.core.config import (
    ConvergenceInfo, make_convergence_info, resolve_device, tensors_to,
)
from hypre_tpu_torch.krylov import pcg
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.fastmv import optimize_operator
from hypre_tpu_torch.seq.spgemm import ell_add, ell_spgemm
from hypre_tpu_torch.seq.vector import dot


@dataclasses.dataclass
class SaddleSystem:
    """The 2x2 block operator: velocity block A, divergence B, its
    transpose Bt, stabilization C (None when unstabilized)."""

    A: EllMatrix
    B: EllMatrix
    Bt: EllMatrix
    C: Optional[EllMatrix] = None

    @property
    def n_u(self) -> int:
        return self.A.n_rows

    @property
    def n_p(self) -> int:
        return self.B.n_rows

    def to(self, device) -> "SaddleSystem":
        return tensors_to(self, device)

    def optimized(self) -> "SaddleSystem":
        """The same operator with each block in its kernel format (DIA,
        banded or ELL, ``optimize_operator``): for products only."""
        return SaddleSystem(*(None if M is None else optimize_operator(M)
                              for M in (self.A, self.B, self.Bt, self.C)))

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        u, p = x[: self.n_u], x[self.n_u:]
        top = self.A.mv(u) + self.Bt.mv(p)
        bot = self.B.mv(u)
        if self.C is not None:
            bot = bot - self.C.mv(p)
        return torch.cat([top, bot])


def schur_hat(sys: SaddleSystem) -> EllMatrix:
    """S_hat = B diag(A)^{-1} Bt (+ C), the pressure-block approximation
    HYPRE_LSI_blkprec builds."""
    dinv = 1.0 / sys.A.diagonal()
    B = sys.B
    Bs = dataclasses.replace(B, vals=B.vals * torch.where(
        B.cols >= 0, dinv[B.cols.clamp(min=0).long()],
        torch.zeros_like(B.vals)))
    S = ell_spgemm(Bs, sys.Bt)
    if sys.C is not None:
        S = ell_add(1.0, S, 1.0, sys.C)
    return S


class _SchurParts:
    """What Uzawa and BlockPrecond share: the A11 BoomerAMG, the
    Jacobi-swept S_hat, and the operators the solves apply (``op`` and
    ``S_op``: the blocks and S_hat, in their kernel formats when
    optimized)."""

    inner_cycles: int
    schur_sweeps: int

    def _setup_parts(self, sys: SaddleSystem, device, optimize) -> None:
        target = resolve_device(device)
        if optimize == "auto":
            optimize = target.type == "cuda"
        self.sys = sys = sys.to(target)
        self.op = sys.optimized() if optimize else sys
        self.amg = BoomerAMG(relax="l1-jacobi").setup(
            sys.A, optimize=optimize, device=target)
        self.S = schur_hat(sys)
        self.S_op = optimize_operator(self.S) if optimize else self.S
        d = self.S.diagonal()
        self.s_dinv = torch.where(d != 0, 1.0 / torch.where(
            d != 0, d, torch.ones_like(d)), torch.zeros_like(d))

    def _inv_a(self, r: torch.Tensor) -> torch.Tensor:
        u = torch.zeros_like(r)
        for _ in range(self.inner_cycles):
            u = self.amg.cycle(r, u)
        return u

    def _inv_s(self, r: torch.Tensor) -> torch.Tensor:
        z = self.s_dinv * r
        for _ in range(self.schur_sweeps):
            z = z + self.s_dinv * (r - self.S_op.mv(z))
        return z


@dataclasses.dataclass
class Uzawa(_SchurParts):
    """HYPRE_LSI_Uzawa analogue: the stationary Uzawa iteration

        A u_{k+1} = f - Bt p_k          (A11 sub-solve: AMG cycles)
        p_{k+1}   = p_k + omega * S_hat_inv (B u_{k+1} - C p_k - g)

    (HYPRE_LSI_UZAWA.cxx::solve, A11Solver_/S22Solver_)."""

    omega: float = 0.5
    inner_cycles: int = 2     # AMG V-cycles per A11 solve
    schur_sweeps: int = 4     # Jacobi sweeps on S_hat per pressure update
    maxiter: int = 100
    rtol: float = 1e-8

    sys: Optional[SaddleSystem] = dataclasses.field(default=None, repr=False)
    op: Optional[SaddleSystem] = dataclasses.field(default=None, repr=False)
    amg: Optional[BoomerAMG] = dataclasses.field(default=None, repr=False)
    S: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    S_op: object = dataclasses.field(default=None, repr=False)
    s_dinv: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                       repr=False)

    def setup(self, sys: SaddleSystem, device=None,
              optimize="auto") -> "Uzawa":
        """Build the parts on ``device`` (CUDA unless the caller names
        another); optimize: the kernel formats, 'auto' = on CUDA."""
        self._setup_parts(sys, device, optimize)
        return self

    def solve(self, f: torch.Tensor, g: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, ConvergenceInfo]:
        """Iterate to ||(r_u, r_p)|| < rtol ||(f, g)||, one host read per
        iteration."""
        sys = self.op
        f, g = f.to(self.sys.A.device), g.to(self.sys.A.device)
        p = torch.zeros(sys.n_p, dtype=f.dtype, device=f.device)
        u = torch.zeros(sys.n_u, dtype=f.dtype, device=f.device)
        bnorm = torch.sqrt(dot(f, f) + dot(g, g))
        rel = float("inf")
        it_done = 0
        for it in range(self.maxiter):
            u = self._inv_a(f - sys.Bt.mv(p))
            rp = sys.B.mv(u) - g
            if sys.C is not None:
                rp = rp - sys.C.mv(p)
            p = p + self.omega * self._inv_s(rp)
            ru = f - sys.A.mv(u) - sys.Bt.mv(p)
            rel = float(torch.sqrt(dot(ru, ru) + dot(rp, rp)) / bnorm)
            it_done = it + 1
            if rel < self.rtol:
                break
        return u, p, make_convergence_info(it_done, rel, rel < self.rtol)


@dataclasses.dataclass
class BlockPrecond(_SchurParts):
    """HYPRE_LSI_blkprec analogue: a block-diagonal or block-triangular
    preconditioner for the saddle operator, for FlexGMRES.

    mode='diag':       M^{-1} = blkdiag(A_amg^{-1}, S_hat_inv)
    mode='triangular': also applies the Bt coupling on the back-solve
                       (the reference's block LU option)
    ``solve_reduced`` is the LSI Schur reduction (HYPRE_LSI_schur.cxx)."""

    mode: str = "triangular"
    inner_cycles: int = 1
    schur_sweeps: int = 4

    sys: Optional[SaddleSystem] = dataclasses.field(default=None, repr=False)
    op: Optional[SaddleSystem] = dataclasses.field(default=None, repr=False)
    amg: Optional[BoomerAMG] = dataclasses.field(default=None, repr=False)
    S: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    S_op: object = dataclasses.field(default=None, repr=False)
    s_dinv: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                       repr=False)

    def setup(self, sys: SaddleSystem, device=None,
              optimize="auto") -> "BlockPrecond":
        """Build the parts on ``device`` (CUDA unless the caller names
        another); optimize: the kernel formats, 'auto' = on CUDA."""
        self._setup_parts(sys, device, optimize)
        return self

    def precond(self) -> Callable[[torch.Tensor], torch.Tensor]:
        sys = self.op
        n_u = sys.n_u

        def M(r):
            ru, rp = r[:n_u], r[n_u:]
            # pressure first (the operator carries -C and B u, so
            # S z = -rp gives a consistent sign)
            zp = -self._inv_s(rp)
            if self.mode == "triangular":
                zu = self._inv_a(ru - sys.Bt.mv(zp))
            else:
                zu = self._inv_a(ru)
            return torch.cat([zu, zp])

        return M

    def solve_reduced(self, f: torch.Tensor, g: torch.Tensor,
                      rtol: float = 1e-8, maxiter: int = 200):
        """PCG on S p = B A^{-1} f - g (A^{-1} by AMG cycles), then
        u = A^{-1}(f - Bt p): HYPRE_LSI_schur.cxx's reduced system."""
        sys = self.op
        f, g = f.to(self.sys.A.device), g.to(self.sys.A.device)

        def s_op(p):
            out = sys.B.mv(self._inv_a(sys.Bt.mv(p)))
            if sys.C is not None:
                out = out + sys.C.mv(p)
            return out

        rhs = sys.B.mv(self._inv_a(f)) - g
        p, info = pcg(s_op, rhs, M=self._inv_s, rtol=rtol, maxiter=maxiter,
                      device=f.device)
        u = self._inv_a(f - sys.Bt.mv(p))
        return u, p, info
