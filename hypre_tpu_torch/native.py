"""ctypes bindings of the host C++ setup kernels.

Counterpart of ``hypre_tpu/native.py``. The AMG setup is irregular host
graph work, the part hypre writes in C (strength, coarsening,
interpolation, RAP); ``hypre_tpu_torch/csrc/hypre_tpu_native.cpp`` holds
C++/OpenMP kernels over plain CSR arrays, byte for byte the reference's
source, so that both packages build the same hierarchy. Nothing is built
when the module is imported: the first call builds the library with g++
(the reference Makefile's flags) into ``hypre_tpu_torch/_build/`` under a
name that carries a hash of the source and the flags, written through a
per-process temporary file and an atomic rename, so that workers that
build at the same time never load half a file. ``available()`` is False
when the build fails; ``build()`` raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "hypre_tpu_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-fPIC", "-std=c++17",
             "-shared"]

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32 = ctypes.c_int32
_f64 = ctypes.c_double

SIGNATURES = {
    "strength_mask": [_i32, _i32p, _i32p, _f64p, _f64, _f64, _u8p],
    "pmis_coarsen": [_i32, _i32p, _i32p, _u8p, _i32, _i32p],
    "rs_coarsen": [_i32, _i32p, _i32p, _u8p, _i32p],
    "spgemm_symbolic": [_i32, _i32, _i32p, _i32p, _i32p, _i32p, _i32p],
    "spgemm_numeric": [_i32, _i32, _i32p, _i32p, _f64p, _i32p, _i32p, _f64p,
                       _i32p, _i32p, _f64p],
    "csr_transpose": [_i32, _i32, _i32p, _i32p, _f64p, _i32p, _i32p, _f64p],
    "extpi_symbolic": [_i32, _i32p, _i32p, _u8p, _i32p, _i32p],
    "extpi_numeric": [_i32, _i32p, _i32p, _f64p, _u8p, _i32p, _i32p, _i32p,
                      _i32p, _f64p],
    "interp_truncate": [_i32, _i32p, _i32p, _f64p, _i32, _f64],
    "csr_matvec": [_i32, _i32p, _i32p, _f64p, _f64p, _f64p],
    "direct_symbolic": [_i32, _i32p, _i32p, _u8p, _i32p, _i32p],
    "direct_numeric": [_i32, _i32p, _i32p, _f64p, _u8p, _i32p, _i32p, _i32p,
                       _i32p, _f64p],
}

_lib = None
_error: str | None = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libhypre_tpu_native_{digest}.so"


def build():
    """The loaded library, built at first use. Raises with g++'s output
    when the build fails (and again at every later call)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            try:
                proc = subprocess.run(
                    ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                    capture_output=True, text=True)
            except OSError as exc:
                _error = f"the host setup library cannot be built: {exc}"
                raise RuntimeError(_error) from exc
            if proc.returncode != 0:
                _error = ("g++ failed to build the host setup library:\n"
                          + proc.stdout + proc.stderr)
                raise RuntimeError(_error)
            os.replace(tmp, path)  # atomic: no reader sees half a file
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
        lib.interp_truncate.restype = _i32
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        build()
    except (RuntimeError, OSError):
        return False
    return True


# -- numpy-level wrappers (CSR = (indptr i32, indices i32, data f64)) ---------


def strength(n, Ap, Aj, Ax, theta: float, max_row_sum: float = 1.0
             ) -> np.ndarray:
    S = np.zeros(len(Aj), np.uint8)
    build().strength_mask(n, Ap, Aj, Ax, theta, max_row_sum, S)
    return S


def pmis(n, Ap, Aj, S, row_offset: int = 0) -> np.ndarray:
    cf = np.zeros(n, np.int32)
    build().pmis_coarsen(n, Ap, Aj, S, row_offset, cf)
    return cf


def rs(n, Ap, Aj, S) -> np.ndarray:
    cf = np.zeros(n, np.int32)
    build().rs_coarsen(n, Ap, Aj, S, cf)
    return cf


def spgemm(n, m, Ap, Aj, Ax, Bp, Bj, Bx):
    lib = build()
    Cp = np.zeros(n + 1, np.int32)
    lib.spgemm_symbolic(n, m, Ap, Aj, Bp, Bj, Cp)
    nnz = int(Cp[-1])
    Cj = np.zeros(nnz, np.int32)
    Cx = np.zeros(nnz, np.float64)
    lib.spgemm_numeric(n, m, Ap, Aj, Ax, Bp, Bj, Bx, Cp, Cj, Cx)
    return Cp, Cj, Cx


def transpose(n, m, Ap, Aj, Ax):
    nnz = int(Ap[-1])
    Tp = np.zeros(m + 1, np.int32)
    Tj = np.zeros(nnz, np.int32)
    Tx = np.zeros(nnz, np.float64)
    build().csr_transpose(n, m, Ap, Aj, Ax, Tp, Tj, Tx)
    return Tp, Tj, Tx


def extpi_interp(n, Ap, Aj, Ax, S, cf, cmap):
    lib = build()
    Pp = np.zeros(n + 1, np.int32)
    lib.extpi_symbolic(n, Ap, Aj, S, cf, Pp)
    nnz = int(Pp[-1])
    Pj = np.zeros(nnz, np.int32)
    Px = np.zeros(nnz, np.float64)
    lib.extpi_numeric(n, Ap, Aj, Ax, S, cf, cmap, Pp, Pj, Px)
    # drop the sentinel (-1) slots: rows with positive strong off-diagonals
    # get fewer numeric entries than the symbolic bound (extpi_numeric)
    keep = Pj >= 0
    if not keep.all():
        rows = np.repeat(np.arange(n), np.diff(Pp))
        counts = np.bincount(rows[keep], minlength=n).astype(np.int32)
        Pp = np.zeros(n + 1, np.int32)
        np.cumsum(counts, out=Pp[1:])
        Pj, Px = Pj[keep], Px[keep]
    return Pp, Pj, Px


def truncate(n, Pp, Pj, Px, max_elmts: int, trunc_factor: float):
    """Truncate P in place; returns the compacted (Pp, Pj, Px)."""
    nnz = int(build().interp_truncate(n, Pp, Pj, Px, max_elmts, trunc_factor))
    return Pp, Pj[:nnz], Px[:nnz]


def matvec(n, Ap, Aj, Ax, x) -> np.ndarray:
    y = np.zeros(n, np.float64)
    build().csr_matvec(n, Ap, Aj, Ax, np.ascontiguousarray(x, np.float64), y)
    return y


def direct_interp(n, Ap, Aj, Ax, S, cf, cmap):
    lib = build()
    Pp = np.zeros(n + 1, np.int32)
    lib.direct_symbolic(n, Ap, Aj, S, cf, Pp)
    nnz = int(Pp[-1])
    Pj = np.zeros(nnz, np.int32)
    Px = np.zeros(nnz, np.float64)
    lib.direct_numeric(n, Ap, Aj, Ax, S, cf, cmap, Pp, Pj, Px)
    return Pp, Pj, Px
