"""BsrMatrix — block-sparse (block-ELL) storage for nodal systems.

Counterpart of ``hypre_tpu/seq/bsr.py`` (hypre's ParCSRBlockMatrix,
``parcsr_block_mv/par_csr_block_matrix.h``), for systems PDEs whose
unknowns group by node: dense (bs x bs) blocks in a block-ELL slab, so
that the product is a gather and one batched block-vector product,

    y[I] = sum_k  bvals[I, k] @ x[bcols[I, k]]

Storage, conversion both ways, the product, and the inverse diagonal
blocks of the block-Jacobi smoother that hypre's nodal mode uses. The
reference computes the product with ``einsum`` outside any Pallas kernel;
here it is one PyTorch product as well.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hypre_tpu_torch.core.config import PAD_COL, tensors_to
from hypre_tpu_torch.seq.ell import EllMatrix, ell_to_csr
from hypre_tpu_torch.seq.spgemm import _merge_rows


def safe_block_inverse(blocks: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (nb, bs, bs) blocks, 0 where a block is singular
    or its inverse is not finite. The reference's ``jnp.linalg.inv`` gives
    inf or nan there and carries them on; ``torch.linalg.inv`` would
    raise, so the port zeroes such blocks: the block-Jacobi step leaves
    their unknowns as they are."""
    inv, info = torch.linalg.inv_ex(blocks, check_errors=False)
    ok = (info == 0)[:, None, None] & torch.isfinite(inv)
    return torch.where(ok, inv, torch.zeros_like(inv))


@dataclasses.dataclass(frozen=True)
class BsrMatrix:
    """Block ELL: bvals (nbrows, k, bs, bs); bcols (nbrows, k) int32 block
    columns, PAD_COL (-1) on padded slots (whose blocks are 0)."""

    bvals: torch.Tensor
    bcols: torch.Tensor
    n_bcols: int

    @property
    def block_size(self) -> int:
        return self.bvals.shape[-1]

    @property
    def n_brows(self) -> int:
        return self.bvals.shape[0]

    @property
    def n_rows(self) -> int:
        return self.n_brows * self.block_size

    @property
    def n_cols(self) -> int:
        return self.n_bcols * self.block_size

    @property
    def dtype(self):
        return self.bvals.dtype

    @property
    def device(self) -> torch.device:
        return self.bvals.device

    def to(self, device) -> "BsrMatrix":
        return tensors_to(self, device)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x (x flat, scalar-indexed)."""
        xb = x.reshape(self.n_bcols, self.block_size)
        g = xb[self.bcols.clamp(min=0).long()]  # (nb, k, bs)
        g = torch.where((self.bcols >= 0)[..., None], g, torch.zeros_like(g))
        return torch.einsum("nkab,nkb->na", self.bvals, g).reshape(-1)

    def block_diagonal(self) -> torch.Tensor:
        """(nb, bs, bs) diagonal blocks."""
        rows = torch.arange(self.n_brows, dtype=self.bcols.dtype,
                            device=self.device)[:, None]
        hit = (self.bcols == rows)[..., None, None]
        return torch.where(hit, self.bvals,
                           torch.zeros_like(self.bvals)).sum(dim=1)

    def block_jacobi_precond(self):
        """r -> D^{-1} r with D the diagonal blocks, inverted once: hypre's
        nodal block smoother (par_csr_block_relax.c)."""
        inv = safe_block_inverse(self.block_diagonal())
        bs = self.block_size

        def M(r):
            rb = r.reshape(self.n_brows, bs)
            return torch.einsum("nab,nb->na", inv, rb).reshape(-1)

        return M

    def to_ell(self) -> EllMatrix:
        """The scalar view: every block entry, zeros included, at row
        I*bs + a and column J*bs + c, columns ascending within a row — the
        reference's ``csr_to_ell(HostCSR.from_coo(...))``, built on the
        matrix's device."""
        bs = self.block_size
        nb, k = self.bcols.shape
        valid = self.bcols >= 0  # (nb, k)
        c = torch.arange(bs, dtype=torch.int32, device=self.device)
        # scalar row (I, a): slots (K, c) in order, cols bcols[I,K]*bs + c
        cols = self.bcols[:, None, :, None] * bs + c[None, None, None, :]
        cols = torch.where(valid[:, None, :, None], cols,
                           torch.full_like(cols, PAD_COL))
        cols = cols.expand(nb, bs, k, bs).reshape(nb * bs, k * bs)
        vals = self.bvals.permute(0, 2, 1, 3).reshape(nb * bs, k * bs)
        out_cols, out_vals, req = _merge_rows(cols.contiguous(),
                                              vals.contiguous(), k * bs)
        width = max(int(req), 1)
        return EllMatrix(vals=out_vals[:, :width].contiguous(),
                         cols=out_cols[:, :width].contiguous(),
                         n_cols=self.n_cols)


def ell_to_bsr(A: EllMatrix, block_size: int) -> BsrMatrix:
    """Group a scalar matrix into (bs x bs) blocks (hypre's
    ParCSRBlockMatrixConvertFromParCSRMatrix), on the host as in the
    reference, with its layout: block columns ascending within a block
    row. The reference finds each block's slot with a Python loop over the
    distinct (block row, block column) pairs; they come sorted, so the
    slot is the pair's index less the index of its block row's first
    pair."""
    bs = block_size
    if A.n_rows % bs or A.n_cols % bs:
        raise ValueError("matrix dims must be divisible by block_size")
    csr = ell_to_csr(A)
    rows = np.repeat(np.arange(csr.n_rows), csr.row_nnz())
    brow = rows // bs
    bcol = csr.indices // bs
    nbc = A.n_cols // bs
    uniq, inv = np.unique(brow * nbc + bcol, return_inverse=True)
    u_row, u_col = uniq // nbc, uniq % nbc
    nb = A.n_rows // bs
    counts = np.bincount(u_row, minlength=nb)
    k = max(int(counts.max(initial=0)), 1)
    row_first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_of = np.arange(len(uniq)) - row_first[u_row]
    bcols = np.full((nb, k), PAD_COL, np.int32)
    bcols[u_row, slot_of] = u_col
    # the CSR holds each (row, column) once, so every block entry is
    # written once
    bvals = np.zeros((nb, k, bs, bs), np.asarray(csr.data).dtype)
    bvals[brow, slot_of[inv.reshape(-1)], rows % bs, csr.indices % bs] = \
        csr.data
    dev = A.device
    return BsrMatrix(bvals=torch.from_numpy(bvals).to(dev),
                     bcols=torch.from_numpy(bcols).to(dev), n_bcols=nbc)

