"""The yardstick of the kernel rooflines: the table of peaks and the bytes
and operations of the function a sparse product applies, counted from the
operator's own shape and never from the layout that implements it.

y = M x with M of n_rows x n_cols and nnz stored nonzeros moves at least:
y written once (n_rows values), one value per stored nonzero, x read at
min(nnz, n_cols) values, and, where M has no fixed stencil, one int32
column per stored nonzero. A stencil operator's pattern is its list of
offsets, so none of its columns are counted: the DIA format reads none,
and counting them would put its share over 100 %.
It performs 2 nnz operations."""

from __future__ import annotations

# Published peaks (NVIDIA H100 SXM5 80 GB data sheet, dense, no sparsity;
# rates assume the card's full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "flops": {"float32": 67e12, "float64": 34e12},
    },
}


def peak(kind: str) -> dict | None:
    return PEAKS.get(kind)


def spmv_bytes(n_rows: int, n_cols: int, nnz: int, value_bytes: int,
               stencil: bool) -> int:
    index_bytes = 0 if stencil else 4
    return (value_bytes * (n_rows + min(nnz, n_cols) + nnz)
            + index_bytes * nnz)


def stored_nonzeros(M) -> int:
    """Stored nonzeros of an operator, whatever its layout: an ELL
    layout's slots with a column in range, a DIA layout's nonzero plane
    entries."""
    if hasattr(M, "cols"):
        return int(((M.cols >= 0) & (M.cols < M.n_cols)).sum())
    if hasattr(M, "dvals"):
        return int((M.dvals != 0).sum())
    raise TypeError(f"no count of stored nonzeros for {type(M).__name__}")


def spmv_flops(nnz: int) -> int:
    return 2 * nnz


def bound_s(nbytes: float, flops: float, dtype: str, kind: str) -> float | None:
    """The least time the card could take for this work, or None for a
    card with no row in the table."""
    p = peak(kind)
    if p is None:
        return None
    return max(nbytes / p["hbm_bytes_per_s"], flops / p["flops"][dtype])
