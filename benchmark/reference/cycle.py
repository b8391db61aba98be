"""A plain multigrid V-cycle on a hierarchy's level operators, held as
plain (rows, slots) arrays: the cycle that the configuration states
(hypre's V(1,1) with ℓ1-Jacobi, ``-rlx 18``, one sweep down and one up),
computed here in any floating dtype.

Each level is (A, P): A = (vals, cols, n) and P = (vals, cols, n_coarse),
both on the level's n rows. The reference works out the rest itself: the
ℓ1 row norms of each A, and the coarsest operator P^T A P of the last
level with its pseudo-inverse (singular values under 10 max(M, N) eps of
the largest dropped, as hypre's dense coarse solve)."""

from __future__ import annotations

import torch

from reference import sparse

RELAX = {"18": "l1-jacobi"}


def sweeps_of(flags: list) -> int:
    """The sweeps a level of the configuration's cycle makes each way,
    from its ij flags; raises where the flags ask for a cycle that this
    reference does not compute."""
    opts = {f: flags[i + 1] for i, f in enumerate(flags)
            if f in ("-rlx", "-ns", "-CF", "-smtype", "-additive",
                     "-mult_add", "-simple")}
    plain = (RELAX.get(opts.get("-rlx")) == "l1-jacobi"
             and opts.get("-CF", "0") == "0"
             and set(opts) <= {"-rlx", "-ns", "-CF"})
    if not plain:
        raise ValueError(f"the reference cycle computes l1-Jacobi V-cycles "
                         f"only; the flags ask for {opts}")
    return int(opts.get("-ns", 1))


def _cast(part, dtype):
    vals, cols, n = part
    return vals.to(dtype), cols, n


def _nonzero(d: torch.Tensor) -> torch.Tensor:
    """An empty row's norm taken as 1, as hypre's l1_norms does."""
    return torch.where(d > 0, d, torch.ones_like(d))


def galerkin_dense(A, P, dtype=torch.float64,
                   block_bytes: int = 2 ** 30) -> torch.Tensor:
    """P^T A P as a dense (n_coarse, n_coarse) matrix, built a block of
    P's columns at a time so that no temporary passes ``block_bytes``."""
    av, ac, n = A
    pv, pc, nc = P
    width = max(1, block_bytes // (8 * max(n, 1)))
    out = torch.zeros(nc, nc, dtype=dtype, device=pv.device)
    for j0 in range(0, nc, width):
        j1 = min(nc, j0 + width)
        inside = (pc >= j0) & (pc < j1)
        Pj = sparse.dense(pv, torch.where(inside, pc - j0, -1), j1 - j0,
                          dtype)
        out[:, j0:j1] = sparse.rmatmat(pv, pc, nc,
                                       sparse.spmm(av, ac, n, Pj))
    return out


def pinv(M: torch.Tensor) -> torch.Tensor:
    work = M if M.dtype in (torch.float32, torch.float64) else \
        M.to(torch.float32)
    rtol = 10.0 * max(M.shape) * torch.finfo(M.dtype).eps
    return torch.linalg.pinv(work, rtol=rtol).to(M.dtype)


class VCycle:
    """z = M f, one V-cycle from a zero guess, every vector and product
    in ``dtype``."""

    def __init__(self, levels: list, sweeps: int = 1,
                 dtype=torch.float64):
        self.dtype, self.sweeps = dtype, sweeps
        self.A = [_cast(A, dtype) for A, _ in levels]
        self.P = [_cast(P, dtype) for _, P in levels]
        self.l1inv = [1.0 / _nonzero(sparse.abs_row_sums(*A))
                      for A in self.A]
        self.cinv = pinv(galerkin_dense(levels[-1][0], levels[-1][1],
                                        torch.float64).to(dtype))

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        return self._descend(0, f.to(self.dtype))

    def _descend(self, l: int, f: torch.Tensor) -> torch.Tensor:
        if l == len(self.A):
            return self.cinv @ f
        (av, ac, n), (pv, pc, nc) = self.A[l], self.P[l]
        u = torch.zeros_like(f)
        for _ in range(self.sweeps):
            u = u + self.l1inv[l] * (f - sparse.matvec(av, ac, n, u))
        r = f - sparse.matvec(av, ac, n, u)
        e = self._descend(l + 1, sparse.rmatvec(pv, pc, nc, r))
        u = u + sparse.matvec(pv, pc, nc, e)
        for _ in range(self.sweeps):
            u = u + self.l1inv[l] * (f - sparse.matvec(av, ac, n, u))
        return u
