#!/usr/bin/env python3
"""Time schedule variants of the row-list DIA kernel on one CUDA card.

    python3 tune_dia_rows.py [PARENT_DIA_SPMV_CU]

Builds ``hypre_tpu_torch/csrc/dia_spmv.cu`` once per variant of its
row-list constants (``kSlotsPerThread``, ``kSlotUnroll``, ``kGroupUnroll``,
``kZeroRowsPerThread``; nvcc with the package's flags, all variants built
at once), then times each variant's ``hypre_dia_rows_f32`` by CUDA events
on three float32 layouts of 2^21 rows shaped like the main path's: P
(every row listed, 1-2 entries of 64 planes), P^T (6 % of the rows listed,
20-30 entries each, 4 lanes) and U (two planes at +-2^20, 2048 listed
rows of one entry). Every variant must give the bits of the dense plain
version. With a path to an earlier ``dia_spmv.cu`` (whose row-list entry
took a pointer per row, as the source before the list of non-empty rows
did), that source is built and timed too, on the same nonzeros in its own
layout, in turns with the current source (earlier, current, current,
earlier). Prints one JSON line per variant and layout, and the card's
name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
# (kSlotsPerThread, kSlotUnroll, kGroupUnroll, kZeroRowsPerThread); the
# first is the source's own
VARIANTS = [(2, 4, 4, 4), (2, 2, 4, 4), (4, 4, 4, 4), (2, 4, 2, 2)]
NAMES = ("kSlotsPerThread", "kSlotUnroll", "kGroupUnroll",
         "kZeroRowsPerThread")


def build(src: str, tmp: str, parent: str | None) -> list:
    """One library per variant (and the earlier source's, last), nvcc
    started for all at once."""
    sys.path.insert(0, HERE)
    from hypre_tpu_torch import kernels

    nvcc = kernels._nvcc()
    procs = []
    texts = []
    for values in VARIANTS:
        text = src
        for name, v in zip(NAMES, values):
            text, count = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {v};", text)
            if count != 1:
                raise RuntimeError(f"{name} not found in dia_spmv.cu")
        texts.append(text)
    if parent:
        with open(parent) as f:
            texts.append(f.read())
    for k, text in enumerate(texts):
        cu = os.path.join(tmp, f"v{k}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(tmp, f"libv{k}.so")
        flags = list(kernels.NVCC_FLAGS)
        procs.append((subprocess.Popen(
            [nvcc, *flags, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so))
    libs = []
    for proc, so in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out}")
        # the row-list kernel's registers and spills, from ptxas
        lines = out.splitlines()
        for k, line in enumerate(lines):
            if "dia_rows_kernel" in line and "Function properties" in line:
                print(json.dumps({"variant": os.path.basename(so),
                                  "kernel": line.split()[-1][-60:],
                                  "ptxas": " ".join(lines[k + 1:k + 3])}),
                      flush=True)
        fn = ctypes.CDLL(so).hypre_dia_rows_f32
        fn.restype = ctypes.c_int
        libs.append(fn)
    for fn in libs[:len(VARIANTS)]:
        fn.argtypes = kernels.SIGNATURES["dia_spmv"]["hypre_dia_rows_f32"]
    if parent:
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        libs[-1].argtypes = [P] * 7 + [LL, LL, I, LL, I, P]
    return libs


def parent_layout(torch, C):
    """The earlier source's layout of the same nonzeros: a pointer per row
    (n + 1), the listed rows only where it runs lanes groups."""
    n = C.n_rows
    counts = torch.zeros(n, dtype=torch.int64, device=C.device)
    per_slot = (C.r_ptr[1:] - C.r_ptr[:-1]).long()
    if C.r_rows is None:
        counts = per_slot
    else:
        counts[C.r_rows.long()] = per_slot
    ptr = torch.zeros(n + 1, dtype=torch.int32, device=C.device)
    torch.cumsum(counts, 0, out=ptr[1:])
    listed = torch.nonzero(counts)[:, 0].to(torch.int32)
    return ptr, (listed if C.r_lanes > 1 else None)


def layouts(torch, dia):
    n = 1 << 21
    g = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    # P: every row 1-2 entries of 64 planes
    dv = torch.zeros(64, n, device="cuda")
    first = torch.randint(0, 32, (n,), generator=g, device="cuda")
    two = torch.rand(n, generator=g, device="cuda") < 0.5
    rows = torch.arange(n, device="cuda")
    dv[first, rows] = 1.0 + torch.rand(n, generator=g, device="cuda")
    dv[(first + 32)[two], rows[two]] = 0.5
    out["P"] = dia.DiaMatrix(dvals=dv, offsets=tuple(range(-4096, 4096, 128)),
                             n_cols=n)
    # P^T: 6 % of the rows with 20-30 entries
    dv = torch.zeros(64, n, device="cuda")
    listed = torch.randperm(n, generator=g, device="cuda")[: n * 6 // 100]
    m = len(listed)
    lens = torch.randint(20, 31, (m,), generator=g, device="cuda")
    rank = torch.rand(m, 64, generator=g, device="cuda").argsort(1).argsort(1)
    hit = rank < lens[:, None]
    dv[:, listed] = torch.where(hit, torch.rand(m, 64, generator=g,
                                                 device="cuda") + 0.5,
                                torch.zeros((), device="cuda")).T
    out["Pt"] = dia.DiaMatrix(dvals=dv,
                              offsets=tuple(range(-4096, 4096, 128)),
                              n_cols=n)
    # U: two planes at +-n/2, 2048 listed rows of one entry
    dv = torch.zeros(2, n, device="cuda")
    near = torch.arange(n // 2 - 1024, n // 2 + 1024, device="cuda")
    dv[(near >= n // 2).long(), near] = 1.5
    out["U"] = dia.DiaMatrix(dvals=dv, offsets=(-(n // 2), n // 2),
                             n_cols=n)
    return {k: dia.compact_dia(M) for k, M in out.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_dia_rows: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from hypre_tpu_torch import kernels
    from hypre_tpu_torch.seq import dia

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with open(os.path.join(HERE, "hypre_tpu_torch", "csrc",
                           "dia_spmv.cu")) as f:
        src = f.read()
    parent = sys.argv[1] if len(sys.argv) > 1 else None
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(src, tmp, parent)
        for label, C in layouts(torch, dia).items():
            n = C.n_rows
            x = torch.rand(n, device="cuda")
            ref = dia.dia_spmv_plain(C.dvals, C.offsets, x, C.margin)
            n_list = n if C.r_rows is None else C.r_rows.numel()
            bounds = cs.row_list_bounds(C, torch)

            def ptr(t):
                return None if t is None else t.data_ptr()

            runs = []
            for values, fn in zip(VARIANTS, fns):
                y = torch.empty(n, device="cuda")

                def launch(fn=fn, y=y):
                    err = fn(ptr(C.r_rows), C.r_ptr.data_ptr(),
                             C.r_ids.data_ptr(), C.r_vals.data_ptr(),
                             ptr(C.r_mask), C.offsets.data_ptr(),
                             x.data_ptr(), y.data_ptr(), n, n, C.D, n_list,
                             C.r_lanes, kernels.stream_of(x))
                    kernels.check(err, "dia_rows variant")

                runs.append((dict(zip(NAMES, values)), launch, y))
            if parent:
                old_ptr, old_rows = parent_layout(torch, C)
                y_old = torch.empty(n, device="cuda")

                def launch_old(fn=fns[-1], y=y_old):
                    err = fn(old_ptr.data_ptr(), C.r_ids.data_ptr(),
                             C.r_vals.data_ptr(), ptr(old_rows),
                             C.offsets.data_ptr(), x.data_ptr(),
                             y.data_ptr(), n, n, C.D,
                             0 if old_rows is None else old_rows.numel(),
                             C.r_lanes, kernels.stream_of(x))
                    kernels.check(err, "earlier dia_rows")

                old = ({"source": "earlier"}, launch_old, y_old)
                runs = [old, runs[0], runs[0], old] + runs[1:]
            for what, launch, y in runs:
                launch()
                torch.cuda.synchronize()
                if not torch.equal(y, ref):
                    raise RuntimeError(f"{what} on {label} differs from the "
                                       "dense plain version")
                print(json.dumps({
                    "layout": label, "lanes": C.r_lanes, **what,
                    "ms": cs.time_ms(launch, torch),
                    "bound_ms": bounds["bound_ms"],
                    "nnz_bound_ms": bounds["nnz_bound_ms"]}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
