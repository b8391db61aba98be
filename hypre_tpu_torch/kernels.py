"""Build, load and count the hand-written CUDA kernels.

Each ``.cu`` source in ``hypre_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes``. Nothing is built when the package is imported: the first
wrapper that launches a kernel builds every library that is missing, one
``nvcc`` per source, all started together. Libraries go to
``hypre_tpu_torch/_build/`` under a name that carries a hash of the
source, so an edited source is rebuilt and a stale library never loads.

Every wrapper adds one to its entry in ``LAUNCHES`` where it launches its
kernel, and nowhere else; ``reset_launches`` sets the counts to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# source stem -> {C function: argtypes}; every function returns the
# cudaError_t of its launch as an int
SIGNATURES = {
    "dia_spmv": {
        "hypre_dia_spmv_f32": [_P, _P, _P, _P, _LL, _LL, _I, _P],
        "hypre_dia_spmv_f64": [_P, _P, _P, _P, _LL, _LL, _I, _P],
        "hypre_dia_spmv_static_f32": [_P, _P, _P, _P, _LL, _LL, _I, _P],
        "hypre_dia_spmv_static_f64": [_P, _P, _P, _P, _LL, _LL, _I, _P],
        **{f"hypre_dia_rows_{t}": [_P] * 8 + [_LL, _LL, _I, _LL, _I, _P]
           for t in ("f32", "f64")},
    },
    "banded_spmv": {
        "hypre_banded_spmv": [_P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _P],
        "hypre_banded_spmv_t": [_P, _P, _P, _P, _P, _P, _LL, _I, _P],
    },
}

LAUNCHES = {"dia_spmv": 0, "dia_spmv_static": 0, "dia_rows": 0,
            "banded_spmv": 0, "banded_spmv_t": 0}

# nvcc's -Xptxas -v report of the last build in this process, per source
BUILD_LOG: dict = {}

_libs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib_path(stem: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{stem}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}_{digest}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_all() -> dict:
    """Build every missing library, one nvcc per source, all started
    together; returns {stem: library path}. Raises with nvcc's output if a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {stem: _lib_path(stem) for stem in SIGNATURES}
    missing = {s: p for s, p in paths.items() if not p.exists()}
    if missing:
        nvcc = _nvcc()
        procs = {}
        for stem, path in missing.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs[stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
        failed = []
        for stem, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[stem] = out
            if proc.returncode != 0:
                failed.append(f"{stem}.cu:\n{out}")
            else:
                os.replace(tmp, path)  # atomic: no reader sees half a file
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built at first use."""
    with _lock:
        if stem not in _libs:
            path = build_all()[stem]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[stem].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[stem] = lib
        return _libs[stem]


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Check what a kernel takes: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
