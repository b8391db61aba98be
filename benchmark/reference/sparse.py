"""Products with a sparse matrix held as plain (rows, slots) arrays: row i
holds vals[i, s] at column cols[i, s]; a slot with a column outside
[0, n_cols) is empty. Used to judge a hierarchy's operators, read from
the program's output, against the reference's own operator."""

from __future__ import annotations

import torch


def _valid(cols: torch.Tensor, n_cols: int) -> torch.Tensor:
    return (cols >= 0) & (cols < n_cols)


def _masked(vals, cols, n_cols: int, dtype):
    ok = _valid(cols, n_cols)
    c = torch.where(ok, cols, torch.zeros_like(cols)).long()
    v = torch.where(ok, vals.to(dtype), torch.zeros((), dtype=dtype,
                                                    device=vals.device))
    return v, c


def matvec(vals, cols, n_cols: int, x: torch.Tensor) -> torch.Tensor:
    """y = M x in x's dtype."""
    v, c = _masked(vals, cols, n_cols, x.dtype)
    return (v * x[c]).sum(dim=1)


def rmatvec(vals, cols, n_cols: int, y: torch.Tensor) -> torch.Tensor:
    """x = M^T y (length n_cols) in y's dtype."""
    v, c = _masked(vals, cols, n_cols, y.dtype)
    out = torch.zeros(n_cols, dtype=y.dtype, device=y.device)
    out.index_add_(0, c.reshape(-1), (v * y[:, None]).reshape(-1))
    return out


def spmm(vals, cols, n_cols: int, X: torch.Tensor) -> torch.Tensor:
    """M X for a dense X of n_cols rows, in X's dtype, a slot at a time."""
    v, c = _masked(vals, cols, n_cols, X.dtype)
    out = torch.zeros(vals.shape[0], X.shape[1], dtype=X.dtype,
                      device=X.device)
    for s in range(v.shape[1]):
        out += v[:, s, None] * X[c[:, s]]
    return out


def rmatmat(vals, cols, n_cols: int, Y: torch.Tensor) -> torch.Tensor:
    """M^T Y (n_cols rows) for a dense Y, in Y's dtype, a slot at a
    time."""
    v, c = _masked(vals, cols, n_cols, Y.dtype)
    out = torch.zeros(n_cols, Y.shape[1], dtype=Y.dtype, device=Y.device)
    for s in range(v.shape[1]):
        out.index_add_(0, c[:, s], v[:, s, None] * Y)
    return out


def dense(vals, cols, n_cols: int, dtype=torch.float64) -> torch.Tensor:
    """M as a dense (rows, n_cols) matrix (small operators only)."""
    v, c = _masked(vals, cols, n_cols, dtype)
    out = torch.zeros(vals.shape[0], n_cols, dtype=dtype,
                      device=vals.device)
    rows = torch.arange(vals.shape[0], device=vals.device)[:, None] \
        .expand_as(c)
    out.index_put_((rows, c), v, accumulate=True)
    return out


def abs_row_sums(vals, cols, n_cols: int) -> torch.Tensor:
    """sum_j |m_ij| of each row, in vals' dtype."""
    v, _ = _masked(vals, cols, n_cols, vals.dtype)
    return v.abs().sum(dim=1)


def stored(cols, n_cols: int) -> int:
    """Number of stored entries (slots with a valid column)."""
    return int(_valid(cols, n_cols).sum())
