"""Matrix and vector IO — MatrixMarket, hypre's IJ ASCII, and ``.npz``.

Counterpart of ``hypre_tpu/io.py``: the MatrixMarket reader and writer
(``utilities/mmio.c``), the PrintIJ format the drivers' ``-fromfile``
flags read (``par_csr_matrix.c:485,582,644``), and the ``.npz``
checkpoint (``vals``, ``cols``, ``n_cols``), whose layout is the
reference's, so that a file either package writes loads in the other.
Readers return a host ``HostCSR``; ``load_matrix`` and ``load_vector``
return tensors on the requested device (CUDA unless the caller names
another).
"""

from __future__ import annotations

import numpy as np
import torch

from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.seq.csr import HostCSR
from hypre_tpu_torch.seq.ell import EllMatrix, _np_dtype, ell_to_csr


def _host_csr(A) -> HostCSR:
    return ell_to_csr(A) if isinstance(A, EllMatrix) else A


def _triplets(csr: HostCSR):
    return np.repeat(np.arange(csr.n_rows), csr.row_nnz()), csr.indices, \
        csr.data


# ---------------------------------------------------------------------------
# MatrixMarket (utilities/mmio.c analogue)
# ---------------------------------------------------------------------------


def read_matrix_market(path: str) -> HostCSR:
    """Parse a MatrixMarket coordinate file (real/integer/pattern,
    general/symmetric/skew-symmetric)."""
    with open(path) as f:
        header = f.readline().strip().lower().split()
        if len(header) < 4 or header[0] != "%%matrixmarket":
            raise ValueError(f"not a MatrixMarket file: {path}")
        if header[2] != "coordinate":
            raise ValueError("only coordinate (sparse) format is supported")
        field = header[3] if len(header) > 3 else "real"
        symmetry = header[4] if len(header) > 4 else "general"
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        m, n, nnz = (int(t) for t in line.split())
        data = np.loadtxt(f, ndmin=2) if nnz else np.zeros((0, 3))
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    vals = data[:, 2] if field != "pattern" and data.shape[1] > 2 \
        else np.ones(len(rows))
    if symmetry in ("symmetric", "skew-symmetric"):
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows, cols = (np.concatenate([rows, cols[off]]),
                      np.concatenate([cols, rows[off]]))
        vals = np.concatenate([vals, sign * vals[off]])
    return HostCSR.from_coo(rows, cols, vals, (m, n), sum_duplicates=False)


def write_matrix_market(path: str, A: HostCSR | EllMatrix) -> None:
    csr = _host_csr(A)
    rows, cols, vals = _triplets(csr)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{csr.shape[0]} {csr.shape[1]} {csr.nnz}\n")
        f.write("".join(f"{r + 1} {c + 1} {v:.17g}\n"
                        for r, c, v in zip(rows.tolist(), cols.tolist(),
                                           vals.tolist())))


# ---------------------------------------------------------------------------
# Native checkpoint format (hypre_ParCSRMatrixPrint/Read analogue)
# ---------------------------------------------------------------------------


def save_matrix(path: str, A: EllMatrix) -> None:
    """One .npz per matrix (replaces hypre's per-rank ASCII files)."""
    np.savez_compressed(path, vals=A.vals.cpu().numpy(),
                        cols=A.cols.cpu().numpy(), n_cols=np.int64(A.n_cols))


def load_matrix(path: str, dtype=None, device=None) -> EllMatrix:
    """The EllMatrix of a ``.npz`` checkpoint on ``device``; ``dtype``
    casts the values (default: as stored)."""
    device = resolve_device(device)
    z = np.load(path)
    vals = z["vals"] if dtype is None else z["vals"].astype(_np_dtype(dtype))
    return EllMatrix(vals=torch.from_numpy(vals).to(device),
                     cols=torch.from_numpy(z["cols"]).to(device),
                     n_cols=int(z["n_cols"]))


def save_vector(path: str, v) -> None:
    v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    np.savez_compressed(path, v=v)


def load_vector(path: str, device=None) -> torch.Tensor:
    return torch.from_numpy(np.load(path)["v"]).to(resolve_device(device))


# ---------------------------------------------------------------------------
# Reference ASCII IJ format (hypre_ParCSRMatrixPrintIJ, par_csr_matrix.c:644)
# ---------------------------------------------------------------------------


def read_ij_ascii(path: str) -> HostCSR:
    """Parse PrintIJ output: a header line ``ilower iupper jlower jupper``
    and ``I J %.14e`` triplets (par_csr_matrix.c:729,745), indices offset
    by ilower/jlower. One rank's file; concatenate the per-rank files of a
    multi-rank dump without their header lines first."""
    with open(path) as f:
        head = f.readline().split()
        if len(head) != 4:
            raise ValueError(f"not an IJ ASCII file (bad header): {path}")
        ilower, iupper, jlower, jupper = (int(t) for t in head)
        rows, cols, vals = [], [], []
        for line in f:
            toks = line.replace(",", " ").split()
            if not toks:
                continue
            rows.append(int(toks[0]) - ilower)
            cols.append(int(toks[1]) - jlower)
            vals.append(float(toks[2]) if len(toks) > 2 else 1.0)
    shape = (iupper - ilower + 1, jupper - jlower + 1)
    return HostCSR.from_coo(
        np.asarray(rows, np.int64), np.asarray(cols, np.int64),
        np.asarray(vals), shape, sum_duplicates=False)


def write_ij_ascii(path: str, A: HostCSR | EllMatrix, base: int = 0) -> None:
    """Write the PrintIJ format (0-based by default, as HYPRE_IJMatrixPrint's
    base_i=0 path)."""
    csr = _host_csr(A)
    m, n = csr.shape
    rows, cols, vals = _triplets(csr)
    with open(path, "w") as f:
        f.write(f"{base} {m - 1 + base} {base} {n - 1 + base}\n")
        f.write("".join(f"{r + base} {c + base} {v:.14e}\n"
                        for r, c, v in zip(rows.tolist(), cols.tolist(),
                                           vals.tolist())))


def read_any_matrix(path: str) -> HostCSR:
    """Dispatch on file content: MatrixMarket, IJ ASCII, or the ``.npz``
    checkpoint (the ij driver's -fromfile accepts all three)."""
    if path.endswith(".npz"):
        return ell_to_csr(load_matrix(path, device="cpu"))
    with open(path) as f:
        first = f.readline().strip()
    if first.lower().startswith("%%matrixmarket"):
        return read_matrix_market(path)
    return read_ij_ascii(path)
