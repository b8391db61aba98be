"""Priming before first use: build the libraries, rehearse a setup, and
remember the shapes that were set up.

Counterpart of ``hypre_tpu/warmup.py``. The reference compiles one XLA
program suite per static shape signature, so its first setup of a new
(row bucket, k, stencil structure) signature costs minutes, and priming
moves that cost to install time. On the card nothing is compiled per
shape: the kernels are four CUDA sources and one C++ source, built once
into shared libraries named by the hash of their source (``kernels.py``,
``native.py``). What is left to prime is that build (seconds of ``nvcc``
and ``g++`` at first use) and the device setup's ladder: a completed
setup records its per-level sizes and widths in the shape registry, and a
later setup of the same shape and knobs replays them with one host read
(``amg/device_setup.py``).

The shape registry is a JSON file, ``$HYPRE_TPU_TORCH_SHAPE_REGISTRY`` or
``~/.cache/hypre_tpu_torch_shapes.json``, with the reference's key strings:
``n|k|shifts`` (``shape_seen``), ``sig|bucket|k`` (setup signatures) and
``ladder|sig|ksig`` (recorded setup ladders). Every write takes a lock
file, re-reads the file, merges its entries in, writes a temporary file
in the same directory and renames it over the old one: an entry written
by another process survives, and a reader never sees a partial file.

Public entry points:

- ``warmup(A, ...)``: build the libraries and rehearse the setup and a
  short solve on a scaled copy of A.
- ``warmup_family(stencil='7pt', n_max=...)``: ``warmup`` for each row
  bucket of a stencil family up to a size.
- ``novel_shape_report(A)``: whether A's setup signature was set up
  before (the warning ``BoomerAMG.setup`` gives on the device backend).
- ``python -m hypre_tpu_torch.warmup 7pt [n_max]``: ``warmup_family``
  from the command line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

REGISTRY_ENV = "HYPRE_TPU_TORCH_SHAPE_REGISTRY"

# setup signatures primed in this process
_PRIMED: set = set()
# entries this process wrote, laid over the file when it is read (a write
# that could not reach the disk is still remembered here)
_LOCAL: dict = {}


def _log(msg: str) -> None:
    print(f"[hypre_tpu_torch.warmup] {msg}", file=sys.stderr, flush=True)


def enable_persistent_cache(path: str | None = None) -> str:
    """The directory the kernel and host-setup libraries are built into and
    loaded from, named by the hash of their sources, so that it persists
    across processes. A ``path`` moves both library builds there; a library
    already loaded in this process stays loaded. Returns the directory."""
    from hypre_tpu_torch import kernels, native

    if path is not None:
        kernels.BUILD_DIR = native.BUILD_DIR = Path(path).expanduser()
    return str(kernels.BUILD_DIR)


# ---------------------------------------------------------------------------
# the shape registry
# ---------------------------------------------------------------------------


def _shape_reg_path() -> str:
    return os.environ.get(
        REGISTRY_ENV, os.path.expanduser("~/.cache/hypre_tpu_torch_shapes.json"))


def _read_file(path: str) -> dict:
    try:
        with open(path) as f:
            reg = json.load(f)
    except (OSError, ValueError):
        return {}
    return reg if isinstance(reg, dict) else {}


def read_registry() -> dict:
    """The registry as it stands: the file, with this process's own
    entries laid over it."""
    return {**_read_file(_shape_reg_path()), **_LOCAL}


@contextlib.contextmanager
def _locked(path: str):
    """An exclusive lock on ``path + '.lock'`` (none where fcntl is
    missing: the rename alone still keeps the file whole)."""
    try:
        import fcntl
    except ImportError:  # pragma: no cover - not POSIX
        yield
        return
    with open(path + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def update_registry(entries: dict) -> None:
    """Merge ``entries`` into the registry file: under the lock, read the
    file as it is now, add the entries, write a temporary file beside it
    and rename it over the old one. A write that fails leaves the old file
    as it was; the entries are kept in this process either way."""
    _LOCAL.update(entries)
    path = _shape_reg_path()
    tmp = None
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with _locked(path):
            reg = _read_file(path)
            reg.update(entries)
            fd, tmp = tempfile.mkstemp(prefix=".shapes.", suffix=".tmp",
                                       dir=os.path.dirname(path) or ".")
            with os.fdopen(fd, "w") as f:
                json.dump(reg, f)
            os.replace(tmp, path)
            tmp = None
    except (OSError, TypeError, ValueError) as exc:
        _log(f"shape registry {path} not written: {exc!r:.200}")
    finally:
        if tmp is not None:
            with contextlib.suppress(OSError):
                os.remove(tmp)


def shape_key(n_rows: int, k: int, shifts) -> str:
    """The registry's ``n|k|shifts`` key of a shape: the one builder of it,
    for ``shape_seen`` and for the device setup's ladders."""
    sh = "none" if shifts is None else ",".join(str(int(s)) for s in shifts)
    return f"{n_rows}|{k}|{sh}"


def _shape_key(A) -> str:
    return shape_key(A.n_rows, A.k, A.shifts)


def _sig_key(sig: tuple) -> str:
    return f"sig|{sig[0]}|{sig[1]}"


def shape_seen(A, record: bool = True) -> bool:
    """True when this exact (n_rows, k, shifts) was recorded before, by
    this process or by an earlier one sharing the registry: the facade
    then runs the specialized solve (the static DIA kernel, with the
    offsets compiled in). False on first sight, and then (record=True)
    the shape is recorded."""
    key = _shape_key(A)
    seen = key in read_registry()
    if record and not seen:
        update_registry({key: 1})
    return seen


def setup_signature(A) -> tuple:
    """(row bucket, k, stencil structure): the reference's key for the
    setup programs a matrix resolves to, computed the same way."""
    from hypre_tpu_torch.amg.device_setup import _row_bucket
    from hypre_tpu_torch.seq.slabops import make_stencil_pack

    nb = _row_bucket(A.n_rows)
    if A.shifts is None:
        return (nb, int(A.k), None)
    sp = make_stencil_pack(A.shifts, nb, with_d2=True)
    return (nb, int(A.k), (sp.margin, sp.pair_idx, sp.d2))


def is_primed(A) -> bool:
    return setup_signature(A) in _PRIMED


def novel_shape_report(A) -> tuple[bool, str]:
    """(novel, message) for A's setup signature. novel is True when
    neither this process (``warmup``) nor an earlier process sharing the
    registry has set up A's (row bucket, k, stencil structure)."""
    sig = setup_signature(A)
    if sig in _PRIMED:
        return False, "setup signature primed in this process"
    if _sig_key(sig) in read_registry():
        return False, ("setup signature seen by an earlier process; its "
                       "kernel libraries are built")
    return True, (
        f"novel setup signature (row bucket {sig[0]}, k={sig[1]}): nothing "
        "is compiled per shape on the card, but the first use in this "
        "checkout builds any missing kernel library with nvcc (and the "
        "host setup library with g++), and the first device setup of the "
        "shape records its ladder before later setups can replay it. "
        "Prime it with hypre_tpu_torch.warmup.warmup(A) or warmup_family.")


def _record_setup_signature(A) -> None:
    """Record A's setup signature, in this process and in the registry."""
    sig = setup_signature(A)
    _PRIMED.add(sig)
    if _sig_key(sig) not in read_registry():
        update_registry({_sig_key(sig): 1})


# ---------------------------------------------------------------------------
# priming
# ---------------------------------------------------------------------------


def warmup(A, setup_kwargs: dict | None = None, solve: bool = True,
           repeats: int = 2, device=None) -> float:
    """Prime A's setup and solve on ``device`` (CUDA unless the caller
    names another): build every kernel library (on CUDA) and the host
    setup library, run ``repeats`` device setups of a scaled copy of A
    with the reference's knobs and one shared ``width_plan`` (the first
    records the setup ladder, the later ones replay it), then a
    5-iteration PCG on the optimized hierarchy. Records A's signature and
    returns the seconds spent."""
    from hypre_tpu_torch import kernels, native
    from hypre_tpu_torch.amg.device_setup import setup_hierarchy_device
    from hypre_tpu_torch.amg.hierarchy import (
        amg_cycle, make_smoother, optimize_hierarchy,
    )
    from hypre_tpu_torch.core.config import resolve_device
    from hypre_tpu_torch.krylov import pcg
    from hypre_tpu_torch.seq.fastmv import optimize_operator

    device = resolve_device(device)
    t0 = time.perf_counter()
    if device.type == "cuda":
        kernels.build_all()
    native.available()
    A = A.to(device)
    kw = dict(max_coarse_size=1500, relax="chebyshev", agg_num_levels=1,
              coarse_drop_tol=0.02, transfer_dia=True)
    kw.update(setup_kwargs or {})
    kw.setdefault("width_plan", {})
    hier = None
    for rep in range(max(repeats, 1)):
        Ax = dataclasses.replace(A, vals=A.vals * float(2 ** (rep + 1)))
        hier = optimize_hierarchy(
            setup_hierarchy_device(Ax, device=device, **kw), device=device)
    if solve and hier is not None:
        smoother = make_smoother("chebyshev", 1.0, 2, 0.3)
        Af = optimize_operator(dataclasses.replace(A, vals=A.vals * 2.0),
                               dia_detect="shifts")
        # amg_cycle pads a true-size vector to a row-bucketed hierarchy
        b = torch.ones(A.n_rows, dtype=A.dtype, device=device)
        pcg(Af.mv, b, M=lambda r: amg_cycle(hier, r, smoother=smoother),
            rtol=1e-6, maxiter=5, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    _record_setup_signature(A)
    dt = time.perf_counter() - t0
    _log(f"primed bucket {setup_signature(A)[0]} k={A.k} in {dt:.1f}s")
    return dt


def warmup_family(stencil: str = "7pt", n_max: int = 2 ** 21,
                  n_min: int = 2 ** 15, dtype=None,
                  setup_kwargs: dict | None = None, device=None) -> list:
    """``warmup`` for each row bucket of a stencil family in [n_min,
    n_max]: the largest grid of each bucket, as the reference walks the
    ladder. Returns [(bucket, seconds)] (NaN for a bucket that failed)."""
    from hypre_tpu_torch.amg.device_setup import _row_bucket
    from hypre_tpu_torch.core.config import resolve_device
    from hypre_tpu_torch.problems.laplacian import (
        laplacian_2d_5pt, laplacian_2d_9pt, laplacian_3d_7pt,
        laplacian_3d_27pt,
    )

    device = resolve_device(device)
    dtype = dtype or torch.float32
    makers = {
        "7pt": lambda s: laplacian_3d_7pt(s, s, s, dtype=dtype, device=device),
        "27pt": lambda s: laplacian_3d_27pt(s, s, s, dtype=dtype,
                                            device=device),
        "5pt": lambda s: laplacian_2d_5pt(s, s, dtype=dtype, device=device),
        "9pt": lambda s: laplacian_2d_9pt(s, s, dtype=dtype, device=device),
    }
    dim = 3 if stencil in ("7pt", "27pt") else 2
    make = makers[stencil]
    done, seen = [], set()
    s = 8
    while True:
        n = s ** dim
        if n > n_max:
            break
        b = _row_bucket(n)
        if n >= n_min and b not in seen:
            seen.add(b)
            try:
                done.append((b, warmup(make(s), setup_kwargs=setup_kwargs,
                                       device=device)))
            except Exception as e:  # noqa: BLE001 - reported, ladder goes on
                _log(f"bucket {b} failed: {e!r:.200}")
                done.append((b, float("nan")))
        # the next grid edge that can land in a new bucket
        s2 = s + 1
        while s2 ** dim <= n_max and _row_bucket(s2 ** dim) in seen:
            s2 += 1
        s = s2
    return done


def _main(argv=None) -> int:
    """Install-time priming: ``python -m hypre_tpu_torch.warmup 7pt
    [n_max]`` builds the libraries and primes the stencil family's row
    buckets on the card."""
    import argparse

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("family", nargs="?", default="7pt",
                    choices=("7pt", "27pt", "5pt", "9pt"))
    ap.add_argument("n_max", nargs="?", type=int, default=2 ** 21)
    args = ap.parse_args(argv)
    _log(f"libraries in {enable_persistent_cache()}")
    for b, secs in warmup_family(args.family, n_max=args.n_max):
        _log(f"bucket {b}: {secs:.1f}s")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(_main())
