"""AME — the Maxwell eigensolver (AMS-preconditioned LOBPCG with gradient
deflation).

Counterpart of ``hypre_tpu/amg/ame.py`` (hypre's ``parcsr_ls/ame.c``).
The smallest eigenpairs of a curl-curl operator A (with mass term) are
hidden under its large gradient near-nullspace, whose eigenvalues (the
mass coefficient) lie below the physical ones. AME runs AMS-preconditioned
LOBPCG on the penalized operator

    A' = A + sigma G G^T,

which leaves divergence-free fields alone and lifts every gradient
eigenvalue by sigma lambda(G^T G), and removes the gradient component of
the iterates with a projection x <- x - G (G^T G)^{-1} G^T x (PCG on the
nodal Gram operator, preconditioned by a BoomerAMG cycle).

``solve(host_f64=True)`` (the default for a float32 operator) runs the
LOBPCG outer loop in float64 — products with A', Rayleigh-Ritz, the
projection's CG — while the float32 AMS and nodal cycles precondition it.
The reference runs that loop on the host, its TPU lacking fast float64;
here it runs on the operator's device (the H100 has float64 units). The
knob keeps the reference's name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hypre_tpu_torch.amg.ams import AMS, f64, product_f64
from hypre_tpu_torch.amg.boomeramg import BoomerAMG
from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.krylov import block_op, lobpcg
from hypre_tpu_torch.krylov.pcg import pcg
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.spgemm import ell_add, ell_transpose


def _columns(f, V: torch.Tensor) -> torch.Tensor:
    """f applied to each column of V."""
    return torch.stack([f(V[:, j].contiguous()) for j in range(V.shape[1])],
                       dim=1)


@dataclasses.dataclass
class AME:
    """HYPRE_AMECreate / SetAMSSolver."""

    block_size: int = 4
    tol: float = 1e-6
    maxiter: int = 200
    proj_rtol: float = 1e-8
    penalty: float = 0.0  # 0 = auto: 10 * mean |diag(A)|

    ams: Optional[AMS] = None
    _A: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    _G: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    _Gt: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    _Ap: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    _gtg_amg: Optional[BoomerAMG] = dataclasses.field(default=None,
                                                      repr=False)
    _sigma: float = dataclasses.field(default=0.0, repr=False)
    _shift: float = dataclasses.field(default=0.0, repr=False)

    def setup(self, A: EllMatrix, G: EllMatrix, coords, device=None,
              optimize="auto") -> "AME":
        """Set up on ``device`` (CUDA unless the caller names another);
        ``optimize`` goes to the inner facades, as in ``AMS.setup``."""
        dev = resolve_device(device)
        A, G = A.to(dev), G.to(dev)
        Gt = ell_transpose(G)
        self._A, self._G, self._Gt = A, G, Gt
        # the penalized operator A' = A + sigma G G^T, explicitly: AMS is
        # set up on it, the spectrum LOBPCG iterates on
        sigma = self.penalty
        if sigma <= 0:
            sigma = 10.0 * float(A.diagonal().abs().mean())
        self._sigma = sigma
        self._Ap = ell_add(1.0, A, sigma, product_f64(G, Gt, A.dtype))
        self.ams = (self.ams or AMS()).setup(self._Ap, G, coords, device=dev,
                                             optimize=optimize)
        # the nodal Gram operator G^T G (a node Laplacian, singular on
        # constants) with a small relative diagonal shift for the f32
        # projection PCG; G maps constants to zero, so the projection
        # does not see the shift
        GtG = product_f64(Gt, G, A.dtype)
        self._shift = float(GtG.diagonal().mean()) * 1e-4
        vals = torch.where(GtG.cols == GtG._row_ids(), GtG.vals + self._shift,
                           GtG.vals)
        self._gtg_amg = BoomerAMG(max_coarse_size=64).setup(
            dataclasses.replace(GtG, vals=vals), device=dev,
            optimize=optimize)
        return self

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        """x <- x - G (G^T G)^{-1} G^T x (remove the gradient part)."""
        G, Gt, shift = self._G, self._Gt, self._shift
        y, _ = pcg(lambda v: Gt.mv(G.mv(v)) + shift * v, Gt.mv(x),
                   M=self._gtg_amg.precond(), rtol=self.proj_rtol,
                   maxiter=100, device=x.device)
        return x - G.mv(y)

    def solve(self, seed: int = 0, host_f64: Optional[bool] = None):
        """Returns (eigenvalues, eigenvectors (n, m) in A's type, residual
        norms). X0 is ``default_rng(seed).standard_normal((n, m))``.

        host_f64 (default: on when A is float32) runs the LOBPCG outer
        loop in float64 with the float32 AMS cycle as its preconditioner,
        on the operator's device (see the module docstring); off, LOBPCG
        runs in A's type with the gradient projection at both ends."""
        A, m = self._A, self.block_size
        if host_f64 is None:
            host_f64 = A.dtype == torch.float32
        Msingle = self.ams.precond()
        if host_f64:
            return self._solve_f64(seed, Msingle)
        X0 = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (A.n_rows, m))).to(device=A.device, dtype=A.dtype)
        X0 = _columns(self._project, X0)
        lam, X, rn = lobpcg(block_op(self._Ap.mv), X0, T=block_op(Msingle),
                            tol=self.tol, maxiter=self.maxiter)
        return lam, _columns(self._project, X), rn

    def _solve_f64(self, seed: int, Msingle):
        """The float64 LOBPCG outer loop (the reference's
        ``_solve_host_f64``), the float32 AMS cycle applied to each
        column."""
        m = self.block_size
        Ap, G, Gt = f64(self._Ap), f64(self._G), f64(self._Gt)
        dt32, dev = self._Ap.dtype, self._Ap.device
        gtg_amg = self._gtg_amg
        n = Ap.n_rows

        def mv(V):
            return _columns(Ap.mv, V)

        def prec(V):
            return _columns(lambda v: Msingle(v.to(dt32)).double(), V)

        def cycle64(r):
            return gtg_amg.cycle(r.to(dt32)).double()

        def project(V):
            # exact f64 gradient removal, V - G (G^T G)^+ G^T V, by CG
            # preconditioned with the f32 nodal AMG cycle
            out = torch.empty_like(V)
            for j in range(V.shape[1]):
                rhs = Gt.mv(V[:, j].contiguous())
                rhs2 = max(float(rhs @ rhs), 1e-300)
                y = torch.zeros_like(rhs)
                r = rhs.clone()
                z = cycle64(r)
                p = z.clone()
                rz = r @ z
                for _ in range(60):
                    Apv = Gt.mv(G.mv(p)) + 1e-12 * p
                    alpha = rz / torch.clamp(p @ Apv, min=1e-300)
                    y = y + alpha * p
                    r = r - alpha * Apv
                    if float(r @ r) < 1e-24 * rhs2:
                        break
                    z = cycle64(r)
                    rz_new = r @ z
                    p = z + (rz_new / rz) * p
                    rz = rz_new
                out[:, j] = V[:, j] - G.mv(y)
            return out

        def rr(S):
            Gm = S.T @ mv(S)
            w, Q = torch.linalg.eigh(S.T @ S)
            keep = w > w.max() * 1e-12
            W = Q[:, keep] / torch.sqrt(w[keep])
            theta, Y = torch.linalg.eigh(W.T @ ((Gm + Gm.T) * 0.5) @ W)
            return theta, W @ Y

        X0 = np.random.default_rng(seed).standard_normal((n, m))
        X = project(torch.from_numpy(X0).to(dev))
        X, _ = torch.linalg.qr(X)
        P = torch.zeros_like(X)
        theta, C = rr(X)
        X, lam = X @ C[:, :m], theta[:m]
        rn = None
        for _ in range(self.maxiter):
            R = mv(X) - X * lam[None, :]
            rn = torch.linalg.vector_norm(R, dim=0)
            if bool((rn <= self.tol * torch.clamp(lam.abs(), min=1.0)).all()):
                break
            S = torch.cat([X, project(prec(R)), P], dim=1)
            theta, C = rr(S)
            Cm = C[:, :m]
            X_new = S @ Cm
            Cp = Cm.clone()
            Cp[:m] = 0.0
            P = S @ Cp
            pn = torch.linalg.vector_norm(P, dim=0)
            P = P / torch.where(pn > 0, pn, torch.ones_like(pn))[None, :]
            X, lam = X_new, theta[:m]
        return lam, project(X).to(self._A.dtype), rn
