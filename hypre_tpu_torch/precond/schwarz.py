"""Additive Schwarz / block-Jacobi preconditioner (parcsr_ls/schwarz.c).

Counterpart of ``hypre_tpu/precond/schwarz.py``. hypre's Schwarz smoothers
solve overlapping subdomain systems with dense factorizations per domain.
Here: contiguous row blocks of ``block_size`` rows (and ``overlap`` rows
on each side), extracted as one (nb, bs, bs) dense batch, inverted once at
setup (``torch.linalg.inv``) and applied as one batched product.

With overlap the rows shared by several blocks sum their blocks'
contributions. The reference scatter-adds them; here each row keeps the
list of its (block, position) slots from setup and gathers them in a
fixed order, so that the sum does not depend on the order of atomics on
the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hypre_tpu_torch.core.config import fold_sum, resolve_device
from hypre_tpu_torch.precond.common import gather_submatrices
from hypre_tpu_torch.seq.ell import EllMatrix


@dataclasses.dataclass
class Schwarz:
    """HYPRE_Schwarz* object protocol (HYPRE_parcsr_ls.h:3651)."""

    block_size: int = 32
    overlap: int = 0
    # 'additive' keeps M symmetric (PCG-safe); 'ras' is restricted
    # additive Schwarz (1 / ownership-count weights), for GMRES
    weighting: str = "additive"

    inv_blocks: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                           repr=False)
    index: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                      repr=False)
    weight: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                       repr=False)
    # (n, c): flat (block * width + position) slots of each row, -1 padded
    owners: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                       repr=False)
    n: int = 0

    def setup(self, A: EllMatrix, device=None) -> "Schwarz":
        """Invert the blocks on ``device`` (CUDA unless the caller names
        another)."""
        A = A.to(resolve_device(device))
        n, dev = A.n_rows, A.device
        bs, ov = self.block_size, self.overlap
        width = bs + 2 * ov
        nb = -(-n // bs)
        starts = torch.arange(nb, device=dev) * bs - ov
        idx = starts[:, None] + torch.arange(width, device=dev)[None, :]
        valid = (idx >= 0) & (idx < n)
        idx = torch.where(valid, idx, torch.full_like(idx, -1))
        self.inv_blocks = torch.linalg.inv(gather_submatrices(
            A, idx.to(torch.int32)))
        self.index = idx
        # each row's slots in ascending (block, position) order: row i sits
        # at position i - start_b of the blocks b whose window holds it
        c = -(-width // bs)
        b_first = torch.div(torch.arange(n, device=dev) + ov - width,
                            bs, rounding_mode="floor") + 1
        blocks = b_first[:, None] + torch.arange(c, device=dev)[None, :]
        pos = torch.arange(n, device=dev)[:, None] - (blocks * bs - ov)
        ok = (blocks >= 0) & (blocks < nb) & (pos >= 0) & (pos < width)
        self.owners = torch.where(ok, blocks * width + pos,
                                  torch.full_like(pos, -1))
        counts = ok.sum(dim=1).to(A.dtype)
        if self.weighting == "ras":
            self.weight = 1.0 / counts.clamp(min=1.0)
        else:
            self.weight = torch.ones(n, dtype=A.dtype, device=dev)
        self.n = n
        return self

    def precond(self):
        inv_b, idx, w, owners = (self.inv_blocks, self.index, self.weight,
                                 self.owners)
        if inv_b is None:
            raise RuntimeError("call setup(A) first")
        valid = idx >= 0
        safe_idx = idx.clamp(min=0)
        own_ok = owners >= 0
        safe_own = owners.clamp(min=0)

        def M(r):
            rb = torch.where(valid, r[safe_idx], torch.zeros_like(r[:1]))
            zb = torch.bmm(inv_b, rb[:, :, None])[:, :, 0].reshape(-1)
            z = fold_sum(torch.where(own_ok, zb[safe_own],
                                     torch.zeros_like(zb[:1])))
            return w * z

        return M
