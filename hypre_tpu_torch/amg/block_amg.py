"""Block (nodal systems) AMG — BoomerAMG's systems mode on BSR storage.

Counterpart of ``hypre_tpu/amg/block_amg.py`` (hypre's ``parcsr_block_mv``
path: ``par_csr_block_interp.c``, ``par_csr_block_rap.c``,
``par_csr_block_relax.c``). For systems PDEs with ``bs`` unknowns a node,
nodal AMG

1. condenses A to a nodal matrix, one value per block (a Frobenius or
   row-sum norm, ``par_nodal_systems.c``), negative off the diagonal so
   that the classical strength test applies;
2. coarsens the nodal graph with PMIS, so all unknowns of a node share
   one C/F mark;
3. builds block direct interpolation (hypre_BoomerAMGBuildBlockDirInterp):
   for an F node i, W_ij = -D_i^{-1} (S_n S_p^{-1}) A_ij over its strong C
   nodes j, S_n the sum of its off-diagonal blocks and S_p that over the
   strong C ones (batched bs x bs solves);
4. forms the Galerkin operator on the scalar view with the ELL SpGEMM and
   re-blocks it (P couples whole nodes, so it keeps the nodal structure);
5. smooths with damped block Jacobi.

The setup runs on A's device, but for ``ell_to_bsr`` between levels,
which is host numpy as in the reference; the coarse pseudo-inverse is
formed in float64, as the reference forms it (on the host). No kernel of
the port runs on this path (the reference runs no Pallas kernel there
either): the block product is a batched PyTorch product.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from hypre_tpu_torch.amg.coarsen import coarse_map, pmis
from hypre_tpu_torch.amg.strength import strength_mask
from hypre_tpu_torch.core.config import PAD_COL, resolve_device
from hypre_tpu_torch.seq.bsr import BsrMatrix, ell_to_bsr, safe_block_inverse
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.spgemm import ell_spgemm, ell_transpose


def nodal_norm_matrix(A: BsrMatrix, mode: str = "frobenius") -> EllMatrix:
    """Condensed nodal matrix (par_nodal_systems.c): off-diagonal entries
    get negative block norms, diagonals positive, so the classical
    negative-coupling strength test applies unchanged."""
    if mode == "frobenius":
        norms = torch.sqrt((A.bvals * A.bvals).sum(dim=(-2, -1)))
    elif mode == "rowsum":
        norms = A.bvals.abs().sum(dim=-1).amax(dim=-1)
    else:
        raise ValueError(f"unknown nodal mode {mode!r}")
    rows = torch.arange(A.n_brows, dtype=A.bcols.dtype,
                        device=A.device)[:, None]
    vals = torch.where(A.bcols == rows, norms, -norms)
    vals = torch.where(A.bcols >= 0, vals, torch.zeros_like(vals))
    return EllMatrix(vals=vals, cols=A.bcols, n_cols=A.n_bcols)


def block_direct_interp(A: BsrMatrix, S: torch.Tensor, cf: torch.Tensor,
                        cmap: torch.Tensor, n_coarse: int) -> BsrMatrix:
    """Block direct interpolation (hypre_BoomerAMGBuildBlockDirInterp).
    A singular diagonal block gives inf or nan in the reference, which
    zeroes them; ``solve_ex`` reports it here without raising, and the
    same guard zeroes those rows."""
    nb, k = A.bcols.shape
    bs = A.block_size
    dev = A.device
    rows = torch.arange(nb, dtype=A.bcols.dtype, device=dev)[:, None]
    offd = (A.bcols >= 0) & (A.bcols != rows)
    cols_c = A.bcols.clamp(min=0).long()
    is_strong_c = S & (cf[cols_c] == 1)
    zero = torch.zeros((), dtype=A.dtype, device=dev)

    D = A.block_diagonal()  # (nb, bs, bs)
    S_n = torch.where(offd[..., None, None], A.bvals, zero).sum(dim=1)
    S_p = torch.where(is_strong_c[..., None, None], A.bvals, zero).sum(dim=1)
    eye = torch.eye(bs, dtype=A.dtype, device=dev)[None]
    # rows with no strong C get the identity (their interpolation is empty)
    have_c = is_strong_c.any(dim=1)
    S_p_safe = torch.where(have_c[:, None, None], S_p, eye)
    # Tikhonov guard against near-singular strong-C block sums
    scale = S_p_safe.abs().amax(dim=(-2, -1), keepdim=True)
    S_p_safe = S_p_safe + 1e-10 * torch.clamp(scale, min=1.0) * eye
    # r = S_n S_p^{-1} (hypre BlockMultInv: o = i2 * i1^{-1}), by the
    # transposed solve: block products do not commute
    ratio = torch.linalg.solve_ex(S_p_safe.transpose(-1, -2),
                                  S_n.transpose(-1, -2),
                                  check_errors=False)[0].transpose(-1, -2)
    Dinv_ratio, info = torch.linalg.solve_ex(D, ratio, check_errors=False)
    Dinv_ratio = torch.where(
        (info == 0)[:, None, None] & torch.isfinite(Dinv_ratio), Dinv_ratio,
        zero)
    # W_ij = -(D^{-1} (S_n S_p^{-1})) A_ij (par_csr_block_interp.c:563-600)
    W = -torch.einsum("nab,nkbc->nkac", Dinv_ratio, A.bvals)

    is_c = cf == 1
    keep = is_strong_c & ~is_c[:, None]
    p_cols = torch.where(keep, cmap[cols_c], PAD_COL).to(torch.int32)
    p_vals = torch.where(keep[..., None, None], W, zero)
    own = torch.where(is_c, cmap, PAD_COL)[:, None].to(torch.int32)
    ident = torch.where(is_c[:, None, None, None], eye[:, None], zero)
    return BsrMatrix(bvals=torch.cat([p_vals, ident], dim=1),
                     bcols=torch.cat([p_cols, own], dim=1),
                     n_bcols=int(n_coarse))


@dataclasses.dataclass(frozen=True)
class BLevel:
    A: BsrMatrix
    A_ell: EllMatrix  # scalar view, for the Galerkin product
    P_ell: EllMatrix
    Pt_ell: EllMatrix
    binv: torch.Tensor  # (nb, bs, bs) inverse diagonal blocks


@dataclasses.dataclass
class BlockAMG:
    """Nodal systems BoomerAMG (hypre num_functions > 1, nodal > 0)."""

    strength_threshold: float = 0.25
    max_levels: int = 25
    max_coarse_size: int = 40  # in nodes
    nodal: str = "frobenius"
    num_sweeps: int = 1
    relax_weight: float = 0.8

    levels: Optional[List[BLevel]] = dataclasses.field(default=None,
                                                       repr=False)
    coarse_inv: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                           repr=False)

    def setup(self, A: BsrMatrix, device=None) -> "BlockAMG":
        """Build the levels for A on ``device`` (CUDA unless the caller
        names another; A is moved there)."""
        A = A.to(resolve_device(device))
        levels: List[BLevel] = []
        while (len(levels) < self.max_levels - 1
               and A.n_brows > self.max_coarse_size):
            N = nodal_norm_matrix(A, self.nodal)
            S = strength_mask(N, self.strength_threshold)
            cf = pmis(N, S)
            cmap, n_c = coarse_map(cf)
            n_coarse = int(n_c)
            if n_coarse == 0 or n_coarse >= 0.9 * A.n_brows:
                break
            P = block_direct_interp(A, S, cf, cmap, n_coarse)
            A_ell = A.to_ell()
            P_ell = P.to_ell()
            Pt_ell = ell_transpose(P_ell)
            Ac_ell = ell_spgemm(Pt_ell, ell_spgemm(A_ell, P_ell))
            levels.append(BLevel(
                A=A, A_ell=A_ell, P_ell=P_ell, Pt_ell=Pt_ell,
                binv=safe_block_inverse(A.block_diagonal())))
            A = ell_to_bsr(Ac_ell, A.block_size)

        # coarsest: f64 pseudo-inverse with the reference's cutoff (1e-12
        # of the largest singular value), cast to the operator's type
        Ae = A.to_ell()
        dense = torch.zeros((Ae.n_rows, Ae.n_cols), dtype=torch.float64,
                            device=A.device)
        r = torch.arange(Ae.n_rows, device=A.device)[:, None].expand(
            Ae.cols.shape)
        m = Ae.cols >= 0
        dense.index_put_((r[m], Ae.cols[m].long()), Ae.vals[m].double(),
                         accumulate=True)
        self.coarse_inv = torch.linalg.pinv(dense, rtol=1e-12).to(Ae.dtype)
        self.levels = levels
        return self

    def _smooth(self, lev: BLevel, u, f):
        bs = lev.A.block_size
        for _ in range(self.num_sweeps):
            rb = (f - lev.A.mv(u)).reshape(-1, bs)
            u = u + self.relax_weight * torch.einsum(
                "nab,nb->na", lev.binv, rb).reshape(-1)
        return u

    def cycle(self, f: torch.Tensor,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One V-cycle (block-Jacobi pre- and post-smoothing)."""
        levels = self.levels

        def descend(i, f, u):
            if i == len(levels):
                return self.coarse_inv @ f
            lev = levels[i]
            u = self._smooth(lev, u, f)
            rc = lev.Pt_ell.mv(f - lev.A.mv(u))
            u = u + lev.P_ell.mv(descend(i + 1, rc, torch.zeros_like(rc)))
            return self._smooth(lev, u, f)

        return descend(0, f, torch.zeros_like(f) if u is None else u)

    def precond(self):
        return lambda r: self.cycle(r)
