"""``ij_mm``: the SpGEMM benchmark driver (hypre's ``src/test/ij_mm.c``,
jobs of ``src/test/TEST_bench/benchmark_spgemm.jobs``).

Counterpart of ``hypre_tpu/drivers/ij_mm.py``. Times the port's sparse
matrix-matrix products (``seq/spgemm.py``: ``ell_spgemm``, which routes
stencil pairs to ``stencil_spgemm`` and large products to row chunks) on
the generator Laplacians and prints hypre's line

    Device Parcsr Matrix-by-Matrix wall clock time = T seconds

Jobs follow ij_mm.c's -job numbering:

  1  C = A * A           (default)
  2  C = A^T * A
  4  C = P^T * A * P     (P = one real AMG interpolation level)
  5  C = Diag(A) * A

Flags: -n nx ny nz, -5pt | -9pt | -7pt | -27pt, -job J, -rep R,
-verify 1 (C against the host C++ Gustavson product of ``native.py``,
entry by entry). On the card each product is timed by CUDA events over
``rep`` products after a warm-up and a synchronize; on the CPU by the
host clock. ``run(argv, device=None, dtype=None)`` runs on ``device``
(CUDA unless the caller names another) in ``dtype`` (float32 unless
named).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from hypre_tpu_torch.core.config import resolve_device


def _build(problem: str, nx: int, ny: int, nz: int, dtype, device):
    from hypre_tpu_torch.problems.laplacian import (
        laplacian_2d_5pt, laplacian_2d_9pt, laplacian_3d_7pt,
        laplacian_3d_27pt,
    )

    kw = dict(dtype=dtype, device=device)
    if problem == "5pt":
        return laplacian_2d_5pt(nx, ny, **kw)
    if problem == "9pt":
        return laplacian_2d_9pt(nx, ny, **kw)
    if problem == "27pt":
        return laplacian_3d_27pt(nx, ny, max(nz, 2), **kw)
    return laplacian_3d_7pt(nx, ny, max(nz, 2), **kw)


def parse(argv) -> dict:
    a = dict(problem="7pt", nx=32, ny=32, nz=32, job=1, rep=10, verify=0)
    i = 0
    while i < len(argv):
        f = argv[i]
        if f == "-n":
            a["nx"], a["ny"], a["nz"] = (int(v) for v in argv[i + 1: i + 4])
            i += 3
        elif f in ("-5pt", "-9pt", "-7pt", "-27pt"):
            a["problem"] = f[1:]
        elif f in ("-job", "-rep", "-verify"):
            a[f[1:]] = int(argv[i + 1])
            i += 1
        elif f == "-help":
            print(__doc__)
            raise SystemExit(0)
        else:
            raise ValueError(f"ij_mm: unknown flag {f!r}")
        i += 1
    if a["job"] not in (1, 2, 4, 5):
        raise ValueError(f"ij_mm: -job {a['job']} is not one of 1, 2, 4, 5")
    return a


def interpolation(A):
    """One real coarsening of A: strength, PMIS and ext+i (job 4's P)."""
    from hypre_tpu_torch.amg.coarsen import coarse_map, pmis
    from hypre_tpu_torch.amg.interp import ext_plus_i_interp
    from hypre_tpu_torch.amg.strength import strength_mask

    S = strength_mask(A, 0.25)
    cf = pmis(A, S)
    cmap, n_c = coarse_map(cf)
    return ext_plus_i_interp(A, S, cf, cmap, int(n_c))


def product_of(job: int, A, B):
    """The job's product as a zero-argument call, at the widths the first
    product needs (found once, so that the timed calls run one pass)."""
    from hypre_tpu_torch.seq.ell import EllMatrix
    from hypre_tpu_torch.seq.spgemm import ell_spgemm, ell_transpose

    if job == 5:
        d = A.diagonal()
        return lambda: EllMatrix(vals=d[:, None] * A.vals, cols=A.cols,
                                 n_cols=A.n_cols)
    if job == 1:
        w = ell_spgemm(A, A).k
        return lambda: ell_spgemm(A, A, w)
    if job == 2:
        T = ell_transpose(A)
        w = ell_spgemm(T, A).k
        return lambda: ell_spgemm(ell_transpose(A, T.k), A, w)
    AP = ell_spgemm(A, B)
    T = ell_transpose(B)
    w = ell_spgemm(T, AP).k
    return lambda: ell_spgemm(ell_transpose(B, T.k),
                              ell_spgemm(A, B, AP.k), w)


def oracle(job: int, A, B):
    """The job's product by the host C++ kernels (CSR, float64), as
    (indptr, indices, values) with each row's columns sorted."""
    from hypre_tpu_torch import native
    from hypre_tpu_torch.amg.hierarchy import _ell_to_csr_arrays
    from hypre_tpu_torch.seq.csr import HostCSR

    n, Ap, Aj, Ax = _ell_to_csr_arrays(A)
    m = A.n_cols
    if job == 1:
        C = native.spgemm(n, m, Ap, Aj, Ax, Ap, Aj, Ax)
    elif job == 2:
        Tp, Tj, Tx = native.transpose(n, m, Ap, Aj, Ax)
        C = native.spgemm(m, n, Tp, Tj, Tx, Ap, Aj, Ax)
    elif job == 4:
        _, Pp, Pj, Px = _ell_to_csr_arrays(B)
        nc = B.n_cols
        APp, APj, APx = native.spgemm(n, m, Ap, Aj, Ax, Pp, Pj, Px)
        Tp, Tj, Tx = native.transpose(n, nc, Pp, Pj, Px)
        C = native.spgemm(nc, n, Tp, Tj, Tx, APp, APj, APx)
    else:
        d = np.zeros(n)
        rows = np.repeat(np.arange(n), np.diff(Ap))
        np.add.at(d, rows[Aj == rows], Ax[Aj == rows])
        C = (Ap, Aj, Ax * d[rows])
    Cp, Cj, Cx = C
    rows = np.repeat(np.arange(len(Cp) - 1), np.diff(Cp))
    return HostCSR.from_coo(rows, Cj, Cx, (len(Cp) - 1, int(Cj.max()) + 1
                                           if len(Cj) else 0))


def verify(job: int, C, A, B, dtype) -> tuple[bool, str]:
    """C's pattern equal to the oracle's and its values within the dtype's
    tolerance (relative to the largest |entry|)."""
    from hypre_tpu_torch.seq.ell import ell_to_csr

    got = ell_to_csr(C)
    ref = oracle(job, A, B)
    nc = max(got.shape[1], ref.shape[1])
    same = (np.array_equal(got.indptr, ref.indptr)
            and np.array_equal(got.indices, ref.indices))
    if not same:
        return False, f"pattern differs (nnz {got.nnz} vs oracle {ref.nnz})"
    scale = max(float(np.abs(ref.data).max(initial=0.0)), 1.0)
    err = float(np.abs(got.data - ref.data).max(initial=0.0)) / scale
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    return err <= tol, (f"max |C - oracle| / max|oracle| = {err:.3e}, "
                        f"nnz {got.nnz}, {nc} columns")


def run(argv, device=None, dtype=None) -> float:
    """Run one ij_mm job; prints hypre's timing line and returns the
    seconds per product."""
    a = parse(list(argv))
    device = resolve_device(device)
    dtype = dtype or torch.float32
    A = _build(a["problem"], a["nx"], a["ny"], a["nz"], dtype, device)
    job, rep = a["job"], max(a["rep"], 1)
    B = interpolation(A) if job == 4 else None
    product = product_of(job, A, B)
    C = product()  # warm: the width search is done, caches are hot
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(rep):
            product()
        stop.record()
        torch.cuda.synchronize(device)
        dt = start.elapsed_time(stop) / 1e3 / rep
    else:
        t0 = time.perf_counter()
        for _ in range(rep):
            product()
        dt = (time.perf_counter() - t0) / rep
    if a["verify"]:
        ok, what = verify(job, C, A, B, dtype)
        print(f"verify: {'passed' if ok else 'FAILED'} ({what})")
        if not ok:
            raise SystemExit(1)
    print(f"Device Parcsr Matrix-by-Matrix wall clock time = {dt:.6f} "
          "seconds")
    return dt


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
