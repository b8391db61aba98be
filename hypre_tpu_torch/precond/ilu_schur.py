"""ILU with an iterated Schur complement on the interface (hypre ilu_type
10/11 and 20/21).

Counterpart of ``hypre_tpu/precond/ilu_schur.py``. hypre's ILU-GMRES and
ILU-NSH (``parcsr_ls/par_ilu_setup.c:346-527``, ``par_ilu.h:95-119``)
split the unknowns into interior points and interface points (rows that
couple across subdomains), factor the interior block B with ILU and solve
the interface Schur system

    S z_G = r_G - E B^{-1} r_I,     S = C - E B^{-1} F

(GMRES preconditioned by an ILU of C, or an NSH approximate inverse);
interior unknowns back-substitute, z_I = B^{-1}(r_I - F z_G). The
subdomains are ``nparts`` contiguous row blocks, and every block operator
is a masked ELL matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hypre_tpu_torch.core.config import PAD_COL, resolve_device
from hypre_tpu_torch.krylov.gmres import gmres
from hypre_tpu_torch.precond.ilu import ILU
from hypre_tpu_torch.seq.ell import EllMatrix


def masked_matrix(A: EllMatrix, row_mask, col_mask,
                  identity_rest: bool) -> EllMatrix:
    """A restricted to row_mask x col_mask; with ``identity_rest`` the
    other rows get a unit diagonal in slot 0 (so that their ILU stays
    well-posed)."""
    keep = (row_mask[:, None] & (A.cols >= 0)
            & col_mask[A.cols.clamp(min=0).long()])
    cols = torch.where(keep, A.cols, torch.full_like(A.cols, PAD_COL))
    vals = torch.where(keep, A.vals, torch.zeros_like(A.vals))
    if identity_rest:
        rows = torch.arange(A.n_rows, dtype=cols.dtype, device=A.device)
        cols = cols.clone()
        vals = vals.clone()
        cols[:, 0] = torch.where(row_mask, cols[:, 0], rows)
        vals[:, 0] = torch.where(row_mask, vals[:, 0],
                                 torch.ones_like(vals[:, 0]))
    return EllMatrix(vals=vals, cols=cols, n_cols=A.n_cols)


def interface_split(A: EllMatrix, nparts: int) -> torch.Tensor:
    """True on the interior rows: rows with no entry outside their own
    contiguous block of ceil(n / nparts) rows."""
    n = A.n_rows
    block = -(-n // nparts)
    owner = torch.arange(n, device=A.device) // block
    col_owner = torch.where(A.cols >= 0, A.cols.clamp(min=0) // block,
                            torch.full_like(A.cols, -1))
    crosses = ((A.cols >= 0) & (col_owner != owner[:, None])).any(dim=1)
    return ~crosses


def _blocks(A: EllMatrix, nparts: int, factor_sweeps: int,
            solve_sweeps: int):
    """(interior, ILU of B, C, E, F) of the split."""
    interior = interface_split(A, nparts)
    gamma = ~interior
    B_ilu = ILU(factor_sweeps=factor_sweeps, solve_sweeps=solve_sweeps) \
        .setup(masked_matrix(A, interior, interior, identity_rest=True),
               device=A.device)
    C = masked_matrix(A, gamma, gamma, identity_rest=True)
    E = masked_matrix(A, gamma, interior, identity_rest=False)
    F = masked_matrix(A, interior, gamma, identity_rest=False)
    return interior, B_ilu, C, E, F


@dataclasses.dataclass
class ILUSchurGMRES:
    """hypre ilu_type 10 (ILU-GMRES) object protocol."""

    nparts: int = 4
    factor_sweeps: int = 5
    solve_sweeps: int = 6
    schur_max_iter: int = 5  # hypre ss_max_iter default 5
    schur_k_dim: int = 5

    interior: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                         repr=False)
    B_ilu: Optional[ILU] = dataclasses.field(default=None, repr=False)
    C_ilu: Optional[ILU] = dataclasses.field(default=None, repr=False)
    E: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    F: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    C: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    # the inner GMRES's iteration counts, one per apply
    inner_iterations: list = dataclasses.field(default_factory=list,
                                               repr=False)

    def setup(self, A: EllMatrix, device=None) -> "ILUSchurGMRES":
        """Split and factor on ``device`` (CUDA unless the caller names
        another)."""
        A = A.to(resolve_device(device))
        self.interior, self.B_ilu, self.C, self.E, self.F = _blocks(
            A, self.nparts, self.factor_sweeps, self.solve_sweeps)
        self.C_ilu = ILU(factor_sweeps=self.factor_sweeps,
                         solve_sweeps=self.solve_sweeps).setup(
            self.C, device=A.device)
        return self

    def precond(self):
        interior = self.interior
        gamma = ~interior
        Binv = self.B_ilu.precond()
        Cinv = self.C_ilu.precond()
        E, F, C = self.E, self.F, self.C

        def S_apply(v):
            # S v = C v - E B^{-1} (F v)   (v supported on the interface)
            return C.mv(v) - E.mv(Binv(F.mv(v)))

        def M(r):
            zero = torch.zeros_like(r)
            r_i = torch.where(interior, r, zero)
            r_g = torch.where(gamma, r, zero)
            z_i0 = torch.where(interior, Binv(r_i), zero)
            g = r_g - torch.where(gamma, E.mv(z_i0), zero)
            z_g, info = gmres(
                S_apply, g, M=lambda v: torch.where(gamma, Cinv(v), zero),
                rtol=1e-2, maxiter=self.schur_max_iter,
                k_dim=self.schur_k_dim, device=r.device)
            self.inner_iterations.append(int(info.iterations))
            z_g = torch.where(gamma, z_g, zero)
            z_i = torch.where(interior, z_i0 - Binv(F.mv(z_g)), zero)
            return z_i + z_g

        return M


@dataclasses.dataclass
class ILUSchurNSH:
    """hypre ilu_type 20/21 (ILU-NSH): the interface Schur system is solved
    with an approximate inverse from the Newton-Schulz-Hotelling iteration
    (``par_ilu_setup.c``'s NSH branch, hypre_ILUSetupNSH).

    The interface is small (the boundaries of ``nparts`` row blocks), so
    S_hat = C - E diag(B)^{-1} F is formed dense on it and

        X_{k+1} = X_k (2 I - S_hat X_k),   X_0 = S_hat^T / (||.||_1 ||.||_inf)

    runs as (m, m) matrix products; the apply is one dense product between
    a gather and a scatter. ``max_interface`` caps m (the (n, m) basis and
    the (m, m) inverse are dense)."""

    nparts: int = 4
    factor_sweeps: int = 5
    solve_sweeps: int = 6
    nsh_iters: int = 10
    max_interface: int = 8192

    interior: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                         repr=False)
    B_ilu: Optional[ILU] = dataclasses.field(default=None, repr=False)
    E: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    F: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    g_idx: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                      repr=False)
    X: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)

    def setup(self, A: EllMatrix, device=None) -> "ILUSchurNSH":
        """Split, factor and invert on ``device`` (CUDA unless the caller
        names another)."""
        A = A.to(resolve_device(device))
        interior, self.B_ilu, C, self.E, self.F = _blocks(
            A, self.nparts, self.factor_sweeps, self.solve_sweeps)
        self.interior = interior
        g_idx = torch.nonzero(~interior)[:, 0]
        m = int(g_idx.numel())
        if m > self.max_interface:
            raise ValueError(
                f"interface size {m} exceeds max_interface="
                f"{self.max_interface}; reduce nparts or use ILUSchurGMRES")
        self.g_idx = g_idx

        # dense S_hat on the interface: the masked operators applied to the
        # interface's identity columns
        diag = A.diagonal()
        nz = interior & (diag != 0)
        dinv = torch.where(nz, 1.0 / torch.where(diag != 0, diag,
                                                 torch.ones_like(diag)),
                           torch.zeros_like(diag))
        basis = torch.zeros((A.n_rows, m), dtype=A.dtype, device=A.device)
        basis[g_idx, torch.arange(m, device=A.device)] = 1.0
        S = (C.mv(basis) - self.E.mv(dinv[:, None] * self.F.mv(basis)))[
            g_idx]

        # X0, the scaled transpose, gives ||I - S X0|| < 1 for nonsingular S
        norm1 = S.abs().sum(dim=0).max()
        norminf = S.abs().sum(dim=1).max()
        X = S.T / (norm1 * norminf)
        eye2 = 2.0 * torch.eye(m, dtype=A.dtype, device=A.device)
        for _ in range(self.nsh_iters):
            X = X @ (eye2 - S @ X)
        self.X = X
        return self

    def precond(self):
        interior = self.interior
        Binv = self.B_ilu.precond()
        E, F, X, g_idx = self.E, self.F, self.X, self.g_idx

        def M(r):
            zero = torch.zeros_like(r)
            r_i = torch.where(interior, r, zero)
            r_g = torch.where(~interior, r, zero)
            z_i0 = torch.where(interior, Binv(r_i), zero)
            g = r_g - torch.where(~interior, E.mv(z_i0), zero)
            z_g = zero.index_copy(0, g_idx, X @ g[g_idx])
            z_i = torch.where(interior, z_i0 - Binv(F.mv(z_g)), zero)
            return z_i + z_g

        return M
