"""FSAI — factored sparse approximate inverse preconditioner.

Counterpart of ``hypre_tpu/precond/fsai.py`` (hypre's FSAI,
``parcsr_ls/par_fsai_setup.c``): a sparse lower-triangular G ~= L^{-1}
(A ~= L L^T), so that M = G^T G approximates A^{-1} and applying M is two
sparse products, with no triangular solve.

Per row i with lower pattern J_i: solve A[J_i, J_i] y = e_i; the diagonal
scaling makes G A G^T unit-diagonal. All rows are one batched (n, k, k)
solve.

Pattern selection (``algo_type``):

- ``static``: the lower triangle of A.
- ``adaptive``: hypre's Kaporin-gradient growth (``par_fsai_setup.c:
  117-136``, hypre_FindKapGrad): ``max_steps`` times, solve the current
  local systems, score every candidate column c < i (the distance-1
  expansion of the pattern and A's own row) by |(A g_i)_c| and admit the
  ``max_step_size`` best. Its (n, C, k+1, kA) candidate lookups run in
  row chunks.

The apply stores G^T at setup (``ell_transpose``) and applies it by
gather, where the reference scatters through G: a scatter-add is atomic
on the card and its float sums then depend on the order of the atomics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hypre_tpu_torch.core.config import PAD_COL, resolve_device
from hypre_tpu_torch.precond.common import (
    gather_submatrices, lookup_chunked, row_pattern_lower,
)
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.slabops import merge_slab
from hypre_tpu_torch.seq.spgemm import ell_transpose


def _solve_rows(A: EllMatrix, pattern: torch.Tensor):
    """Batched local solves on ``pattern`` plus the diagonal (last slot):
    returns (y, yi, full) with y the weights of the unscaled row on
    ``full`` and yi its (i, i) entry (for the scaling)."""
    n, _ = pattern.shape
    row_ids = torch.arange(n, dtype=pattern.dtype,
                           device=pattern.device)[:, None]
    full = torch.cat([pattern, row_ids], dim=1)
    sub = gather_submatrices(A, full)
    rhs = (full == row_ids).to(A.dtype)
    y = torch.linalg.solve(sub, rhs[..., None])[..., 0]
    return y, y[:, -1], full


@dataclasses.dataclass
class FSAI:
    """HYPRE_FSAI* object protocol (HYPRE_parcsr_ls.h:1529)."""

    algo_type: str = "static"  # 'static' | 'adaptive' (hypre algo_type 1)
    max_steps: int = 3  # HYPRE_FSAISetMaxSteps
    max_step_size: int = 3  # HYPRE_FSAISetMaxStepSize
    kap_tolerance: float = 1e-3  # relative Kaporin improvement cutoff

    G: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    Gt: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)

    def setup(self, A: EllMatrix, device=None) -> "FSAI":
        """Build G on ``device`` (CUDA unless the caller names another)."""
        A = A.to(resolve_device(device))
        if self.algo_type == "static":
            pattern = row_pattern_lower(A)
            sub = gather_submatrices(A, pattern)
            row_ids = torch.arange(A.n_rows, dtype=pattern.dtype,
                                   device=A.device)[:, None]
            on_diag = pattern == row_ids
            y = torch.linalg.solve(sub, on_diag.to(A.dtype)[..., None])[..., 0]
            yi = torch.where(on_diag, y, torch.zeros_like(y)).sum(dim=1)
            self._finish(A, y, yi, pattern)
        else:
            self._setup_adaptive(A)
        return self

    def _finish(self, A: EllMatrix, y, yi, pattern) -> None:
        scale = 1.0 / torch.sqrt(yi.clamp(min=1e-300))
        vals = torch.where(pattern >= 0, y * scale[:, None],
                           torch.zeros_like(y))
        self.G = EllMatrix(vals=vals, cols=pattern, n_cols=A.n_cols)
        self.Gt = ell_transpose(self.G)

    def _setup_adaptive(self, A: EllMatrix) -> None:
        n, kA = A.cols.shape
        dev = A.device
        row_ids = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
        width = self.max_steps * self.max_step_size
        # the current pattern (strictly lower columns), grown in place
        pattern = torch.full((n, width), PAD_COL, dtype=torch.int32,
                             device=dev)
        pad = torch.tensor(PAD_COL, dtype=torch.int32, device=dev)
        yi_prev = None
        for step in range(self.max_steps):
            y, yi, full = _solve_rows(A, pattern)
            if yi_prev is not None:
                # kap_tolerance: rows whose Kaporin functional (1/yi) stopped
                # improving stop growing
                improved = yi > yi_prev * (1.0 + self.kap_tolerance)
            else:
                improved = torch.ones(n, dtype=torch.bool, device=dev)
            yi_prev = yi
            if step == self.max_steps - 1:
                break
            # candidates: strictly lower A-neighbours of i and of the
            # current pattern's entries (distance-1 expansion)
            own = torch.where((A.cols >= 0) & (A.cols < row_ids), A.cols, pad)
            nb = A.cols[pattern.clamp(min=0).long()]  # (n, width, kA)
            nb = torch.where((pattern[:, :, None] >= 0) & (nb >= 0)
                             & (nb < row_ids[:, :, None]), nb, pad)
            cand = torch.cat([own, nb.reshape(n, width * kA)], dim=1)
            in_pat = (cand[:, :, None] == pattern[:, None, :]).any(dim=2)
            cand = torch.where(in_pat, pad, cand)
            # Kaporin gradient |(A g)_c|, g the current unscaled row
            kp = full.shape[1]
            shape = cand.shape + (kp,)
            a_cp = lookup_chunked(A, cand[:, :, None].expand(shape),
                                  full[:, None, :].expand(shape))
            kap = torch.einsum("ncp,np->nc", a_cp, y).abs()
            kap = torch.where((cand >= 0) & improved[:, None], kap,
                              torch.full_like(kap, -1.0))
            # merge duplicate candidates. The reference divides each merged
            # sum by the first output of a merge of ones, which is the
            # merged COLUMN index, not the count (fsai.py:132-133); the
            # port keeps that divisor so that it picks the same columns
            # (ROADMAP.md Queue 3)
            mc, mv, _ = merge_slab(cand, kap, cand.shape[1])
            cnt, _, _ = merge_slab(cand, torch.ones_like(kap), cand.shape[1])
            cnt = cnt.to(mv.dtype)
            mv = torch.where(cnt > 0, mv / cnt.clamp(min=1.0),
                             torch.full_like(mv, -1.0))
            score = torch.where(mc >= 0, mv, torch.full_like(mv, -torch.inf))
            order = torch.sort(-score, dim=1, stable=True).indices
            take = torch.gather(mc, 1, order[:, :self.max_step_size])
            lo = step * self.max_step_size
            pattern = pattern.clone()
            pattern[:, lo:lo + self.max_step_size] = take.to(torch.int32)
        self._finish(A, y, yi, full)

    def precond(self):
        """M r = G^T (G r) (par_fsai_solve.c applies the same pair)."""
        G, Gt = self.G, self.Gt
        if G is None:
            raise RuntimeError("call setup(A) first")
        return lambda r: Gt.mv(G.mv(r))
