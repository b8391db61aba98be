"""Block-tridiagonal 2x2 preconditioner (parcsr_ls/block_tridiag.c).

Counterpart of ``hypre_tpu/amg/block_tridiag.py``. For a system split into
two index sets (e.g. velocity and pressure) one application is a block
forward solve

    z_1 = B_11^{-1} r_1
    z_2 = B_22^{-1} (r_2 - A_21 z_1)

with each diagonal block solved approximately by one BoomerAMG cycle,
hypre's HYPRE_BlockTridiagSetIndexSet protocol. The blocks are cut out in
host numpy at setup and live on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hypre_tpu_torch.amg.boomeramg import BoomerAMG
from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.seq.csr import HostCSR
from hypre_tpu_torch.seq.ell import EllMatrix, csr_to_ell, ell_to_csr


def _extract(A: EllMatrix, rows: np.ndarray, cols: np.ndarray) -> EllMatrix:
    """Submatrix A[rows, cols] as a compact EllMatrix on A's device."""
    return _extract_csr(ell_to_csr(A), rows, cols, A.dtype, A.device)


def _extract_csr(csr: HostCSR, rows, cols, dtype, device) -> EllMatrix:
    """Submatrix csr[rows, cols] as an EllMatrix of ``dtype`` on
    ``device``."""
    rmap = -np.ones(csr.shape[0], np.int64)
    rmap[rows] = np.arange(len(rows))
    cmap = -np.ones(csr.shape[1], np.int64)
    cmap[cols] = np.arange(len(cols))
    rr = np.repeat(np.arange(csr.n_rows), csr.row_nnz())
    keep = (rmap[rr] >= 0) & (cmap[csr.indices] >= 0)
    sub = HostCSR.from_coo(
        rmap[rr[keep]], cmap[csr.indices[keep]], csr.data[keep],
        (len(rows), len(cols)))
    return csr_to_ell(sub, dtype=dtype, device=device)


@dataclasses.dataclass
class BlockTridiag:
    """HYPRE_BlockTridiagCreate analogue."""

    amg_knobs: Optional[dict] = None

    def setup(self, A: EllMatrix, index_set1: np.ndarray, optimize="auto",
              device=None) -> "BlockTridiag":
        """Split A by ``index_set1`` and set BoomerAMG up on both diagonal
        blocks, on ``device`` (CUDA unless the caller names another);
        ``optimize`` is the facade's (kernel formats, 'auto' = on CUDA)."""
        target = resolve_device(device)
        n = A.n_rows
        i1 = np.asarray(index_set1, np.int64)
        mask = np.zeros(n, bool)
        mask[i1] = True
        i2 = np.nonzero(~mask)[0]
        self.i1, self.i2 = i1, i2
        knobs = self.amg_knobs or dict(max_coarse_size=64)
        csr = ell_to_csr(A)  # one host copy for the three blocks
        self.A11 = _extract_csr(csr, i1, i1, A.dtype, target)
        self.A21 = _extract_csr(csr, i2, i1, A.dtype, target)
        self.A22 = _extract_csr(csr, i2, i2, A.dtype, target)
        self.B11 = BoomerAMG(**knobs).setup(self.A11, optimize=optimize,
                                            device=target)
        self.B22 = BoomerAMG(**knobs).setup(self.A22, optimize=optimize,
                                            device=target)
        self.n = n
        self._i1t = torch.from_numpy(i1).to(target)
        self._i2t = torch.from_numpy(i2).to(target)
        return self

    def precond(self):
        i1, i2 = self._i1t, self._i2t
        A21, B11, B22, n = self.A21, self.B11, self.B22, self.n

        def M(r):
            z1 = B11.cycle(r[i1])
            z2 = B22.cycle(r[i2] - A21.mv(z1))
            z = torch.zeros(n, dtype=r.dtype, device=r.device)
            z[i1] = z1
            z[i2] = z2
            return z

        return M
