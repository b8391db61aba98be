"""Pattern and gather helpers shared by the preconditioner family.

Counterpart of ``hypre_tpu/precond/common.py``. The recurring primitive:
given a per-row index pattern J (n, k) into a matrix, gather the dense
submatrices A[J_i, J_i] as an (n, k, k) batch, with identity rows and
columns in the padded slots (-1) so that batched factorizations stay
nonsingular. It replaces hypre's per-row hash lookups (e.g.
``par_fsai_setup.c``'s ExtractSubSystems).

The reference forms each lookup's (rows..., kA) match tensor in one piece.
Here the batched lookups run over row chunks of at most ``CHUNK_ELEMENTS``
match elements (rows are independent, so the chunks give the same values),
which bounds the card's memory at n = 2 097 152.
"""

from __future__ import annotations

import torch

from hypre_tpu_torch.core.config import PAD_COL, fold_sum
from hypre_tpu_torch.seq.ell import EllMatrix

# element count of one chunk's largest intermediate
CHUNK_ELEMENTS = 1 << 26

_BIG = 2**30  # sort key of the padding; larger than any column index


def row_chunks(n: int, per_row: int):
    """(lo, hi) row ranges holding at most CHUNK_ELEMENTS // per_row rows."""
    step = max(CHUNK_ELEMENTS // max(per_row, 1), 1)
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def lookup(A: EllMatrix, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """A[rows, cols] for index tensors of one shape; a missing entry, or a
    negative row, gives 0."""
    rsafe = rows.clamp(min=0).long()
    rvals = A.vals[rsafe]  # (..., kA)
    rcols = A.cols[rsafe]
    match = (rcols == cols[..., None]) & (rcols >= 0) & (rows >= 0)[..., None]
    return fold_sum(torch.where(match, rvals, torch.zeros_like(rvals)),
                    dim=-1)


def lookup_chunked(A: EllMatrix, rows: torch.Tensor,
                   cols: torch.Tensor) -> torch.Tensor:
    """``lookup`` over chunks of the leading axis (the same values)."""
    n = rows.shape[0]
    per_row = max(rows[:1].numel(), 1) * A.k
    return torch.cat([lookup(A, rows[lo:hi], cols[lo:hi])
                      for lo, hi in row_chunks(n, per_row)]) if n else \
        lookup(A, rows, cols)


def gather_submatrices(A: EllMatrix, pattern: torch.Tensor) -> torch.Tensor:
    """(n, k, k) dense blocks A[J_i, J_i]; padded slots are identity."""
    n, k = pattern.shape
    rows = pattern[:, :, None].expand(n, k, k)
    cols = pattern[:, None, :].expand(n, k, k)
    sub = lookup_chunked(A, rows, cols)
    valid = pattern >= 0
    pair_valid = valid[:, :, None] & valid[:, None, :]
    eye = torch.eye(k, dtype=A.dtype, device=A.device)[None]
    return torch.where(pair_valid, sub, eye)


def row_pattern_lower(A: EllMatrix) -> torch.Tensor:
    """Per-row pattern {j : A_ij != 0, j <= i}, diagonal guaranteed, sorted
    ascending with -1 padding (the FSAI/ILU static level-0 pattern)."""
    n, _ = A.cols.shape
    row_ids = torch.arange(n, dtype=A.cols.dtype, device=A.device)[:, None]
    keep = (A.cols >= 0) & (A.cols <= row_ids)
    cols = torch.where(keep, A.cols, torch.full_like(A.cols, _BIG))
    # append the diagonal unconditionally, then sort and dedupe
    cols = torch.sort(torch.cat([cols, row_ids], dim=1), dim=1).values
    dup = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=A.device),
                     cols[:, 1:] == cols[:, :-1]], dim=1)
    cols = torch.sort(torch.where(dup, torch.full_like(cols, _BIG), cols),
                      dim=1).values
    return torch.where(cols < _BIG, cols, torch.full_like(cols, PAD_COL))


def sorted_rows(cols: torch.Tensor):
    """Each row's columns in ascending order (padding last, as _BIG) and
    the slot each sorted position came from."""
    key = torch.where(cols >= 0, cols, torch.full_like(cols, _BIG))
    skey, perm = torch.sort(key, dim=1, stable=True)
    return skey.contiguous(), perm.to(torch.int32)


def pair_slots(cols: torch.Tensor, skey: torch.Tensor, perm: torch.Tensor,
               lo: int, hi: int) -> torch.Tensor:
    """For rows lo..hi-1 of an (n, k) pattern: flat index c_a * k + s of
    the slot s where row c_a = cols[i, a] holds column c_b = cols[i, b],
    shape (hi - lo, k, k), or -1 where it holds none (or either slot is
    padding). A binary search in the sorted columns of row c_a: the
    reference's (n, k, k, k) one-hot match at O(n k^2 log k). Rows hold
    each column once."""
    k = cols.shape[1]
    c = cols[lo:hi]
    ca = c.clamp(min=0).long()
    row_keys = skey[ca]  # (m, k, k): sorted columns of row c_a
    want = c[:, None, :].expand(-1, k, -1).contiguous()
    pos = torch.searchsorted(row_keys, want).clamp(max=k - 1)
    hit = torch.gather(row_keys, 2, pos) == want
    slot = torch.gather(perm[ca], 2, pos).long()
    valid = hit & (c >= 0)[:, :, None] & (c >= 0)[:, None, :]
    flat = ca[:, :, None] * k + slot
    return torch.where(valid, flat, torch.full_like(flat, -1))
