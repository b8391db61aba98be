#!/usr/bin/env python3
"""Smoke run of hypre_tpu_torch on one CUDA card: build, check, solve.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. Device: the card's name and power limit; build every CUDA kernel from
   ``hypre_tpu_torch/csrc`` and print nvcc's ``-Xptxas -v`` report.
2. Main path at 128^3, float32: ``laplacian_3d_7pt`` -> ``setup_hierarchy``
   (pure setup: PMIS, ext+i, p_max_elmts=4, Chebyshev, max_coarse_size=1500)
   -> ``optimize_hierarchy`` -> ``pcg`` with the AMG V-cycle preconditioner
   at rtol 1e-6, once with the dynamic DIA kernel (``specialize=False``) and
   once with the static one (``specialize=True``). Kernel launch counts are
   set to 0 just before each path and read just after; every kernel of a
   path must have launched, the solve must converge within ITERATION_LIMIT
   iterations, the two paths must take the same number of iterations, and
   the true relative residual must stay under TRUE_RESIDUAL_LIMIT (the
   float32 floor, below).
3. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes, with times (CUDA events), bounds and the time of one
   PyTorch call that computes the same function (``library_ms``: a CSR
   matrix product). The transpose kernel must also give the same bits in
   two runs; its schedule's size and build time are printed.
4. Card against CPU: the same path at 24^3 in float64 and at 48^3 in
   float32 (where the banded kernels run) on the card and on the CPU
   (plain versions) must give the same level sizes, operator formats and
   PCG iteration count.
5. One ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

It needs one CUDA card; it imports nothing of JAX or of ``hypre_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # H100 SXM, no tensor cores
N_MAIN = 128
N_PARITY = 24
# The true residual of a float32 solution cannot fall below the rounding of
# x itself: with b = ones, x grows as n^2 (max ~930 at 128^3) and A times
# x's rounding error is ~1.2e-5 * (n/32)^2 of ||b|| (port on the CPU, n =
# 32/48/64: 1.24e-5, 2.79e-5, 4.98e-5, the same at rtol 1e-6 and 1e-7),
# about 2e-4 at 128^3. The limit keeps a 5x margin over that floor; the
# float64 run of phase 4 holds the solver to rtol 1e-8.
TRUE_RESIDUAL_LIMIT = 1e-3
# Both 128^3 solves take 9 iterations on the H100; a kernel that is wrong
# but not broken inside the V-cycle weakens the preconditioner, which shows
# as more iterations or as the two paths disagreeing.
ITERATION_LIMIT = 12
# f32 card-vs-CPU size: level-0 P holds ~440k elements there, above
# fastmv.MIN_BANDED_ELEMENTS, so the solve runs kernels 3 and 4.
N_PARITY_BANDED = 48
SETUP_KW = dict(setup_backend="jax", coarsen="pmis", interp="ext+i",
                p_max_elmts=4, relax="chebyshev", agg_num_levels=0,
                max_coarse_size=1500)
SOURCES = {
    "dia_spmv": ("hypre_tpu_torch/csrc/dia_spmv.cu",
                 "hypre_tpu/seq/dia.py:350 (_dia_kernel)"),
    "dia_spmv_static": ("hypre_tpu_torch/csrc/dia_spmv.cu",
                        "hypre_tpu/seq/dia.py:446 (_dia_kernel_static)"),
    "banded_spmv": ("hypre_tpu_torch/csrc/banded_spmv.cu",
                    "hypre_tpu/seq/fastmv.py:156 (_spmv_kernel)"),
    "banded_spmv_t": ("hypre_tpu_torch/csrc/banded_spmv.cu",
                      "hypre_tpu/seq/fastmv.py:212 (_spmv_t_kernel)"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, torch, warmup: int = 5, reps: int = 50) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls.

    A launch costs the host more than a small kernel costs the card, so
    back-to-back calls would time the host. The card is first held busy
    with a sleep kernel longer than the host needs to enqueue all the
    calls; the events then bracket the calls' device work only."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    # 2 cycles per ns bounds the SM clock from above (H100: 1.98 GHz)
    torch.cuda._sleep(int(min(2 * host_s * reps, 5.0) * 2e9) + 1000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def level_sizes(hier) -> list:
    return [lv.A.n_rows for lv in hier.levels] + [hier.coarse_inv.shape[0]]


def solve(H, hier_fast, A_fast, b, device, rtol):
    sm = H.make_smoother("chebyshev", 1.0, 2, 0.3)
    return H.pcg(A_fast.mv, b,
                 M=lambda r: H.amg_cycle(hier_fast, r, smoother=sm),
                 rtol=rtol, maxiter=100, device=device)


def run_main_path(H, kernels, torch, specialize: bool, hier=None):
    """One main-path run on the card; returns (hier, fast, launches)."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    A = H.laplacian_3d_7pt(N_MAIN, N_MAIN, N_MAIN, dtype=torch.float32,
                           device="cuda")
    if hier is None:
        hier = H.setup_hierarchy(A, device="cuda", **SETUP_KW)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = H.optimize_hierarchy(hier, gather_precision=0,
                                specialize=specialize, device="cuda")
    torch.cuda.synchronize()
    optimize_s = time.perf_counter() - t0
    b = torch.ones(A.n_rows, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    x, info = solve(H, fast, fast.levels[0].A, b, "cuda", 1e-6)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    # the true residual of the f32 solution, evaluated in f64
    A64 = H.laplacian_3d_7pt(N_MAIN, N_MAIN, N_MAIN, dtype=torch.float64,
                             device="cuda")
    b64 = b.double()
    true_rel = float(torch.linalg.vector_norm(b64 - A64.mv(x.double()))
                     / torch.linalg.vector_norm(b64))
    record = {
        "path": "specialized" if specialize else "dynamic",
        "n": A.n_rows, "levels": level_sizes(hier),
        "formats": [[type(lv.A).__name__, type(lv.P).__name__]
                    for lv in fast.levels],
        "setup_s": setup_s, "optimize_s": optimize_s, "solve_s": solve_s,
        "iterations": int(info.iterations),
        "converged": bool(info.converged),
        "relative_residual": float(info.relative_residual),
        "true_relative_residual": true_rel, "launches": launches,
    }
    log(json.dumps(record))
    require(bool(info.converged), f"{record['path']} solve did not converge")
    require(true_rel <= TRUE_RESIDUAL_LIMIT,
            f"true relative residual {true_rel} > {TRUE_RESIDUAL_LIMIT}")
    require(record["iterations"] <= ITERATION_LIMIT,
            f"{record['iterations']} iterations > {ITERATION_LIMIT}")
    require(bool(torch.isfinite(x).all()), "non-finite solution")
    return hier, fast, launches, record["iterations"]


def per_iteration_launches(H, kernels, torch, fast):
    """Launches of one PCG iteration (one A.mv and one V-cycle), counted,
    beside the per-level tally the cycle's structure predicts."""
    sm = H.make_smoother("chebyshev", 1.0, 2, 0.3)
    r = torch.ones(fast.levels[0].A.n_rows, dtype=torch.float32,
                   device="cuda")
    kernels.reset_launches()
    fast.levels[0].A.mv(r)
    H.amg_cycle(fast, r, smoother=sm)
    torch.cuda.synchronize()
    counted = dict(kernels.LAUNCHES)
    per_level = []
    for li, lv in enumerate(fast.levels):
        a_mvs = 2 * 2 + 1 + (1 if li == 0 else 0)  # Chebyshev 2+2, residual, Krylov
        per_level.append({
            "level": li, "A": type(lv.A).__name__, "A_mv": a_mvs,
            "P": type(lv.P).__name__, "P_mv": 1,
            "restrict": "banded_spmv_t" if lv.Pt is None else
            type(lv.Pt).__name__,
        })
    log(json.dumps({"launches_per_pcg_iteration": counted,
                    "per_level": per_level}))
    return counted


def rel_err(a, b, torch) -> tuple[float, float]:
    diff = float((a.double() - b.double()).abs().max())
    scale = float(b.double().abs().max())
    return diff / max(scale, 1e-300), diff


def csr_of(ell, torch):
    """torch CSR tensor of an ELL matrix (yardstick for library_ms only)."""
    warnings.filterwarnings("ignore", message="Sparse")
    mask = ell.cols >= 0
    counts = mask.sum(dim=1)
    crow = torch.zeros(ell.n_rows + 1, dtype=torch.int64, device=ell.device)
    crow[1:] = torch.cumsum(counts, 0)
    return torch.sparse_csr_tensor(crow, ell.cols[mask].long(),
                                   ell.vals[mask], size=ell.shape)


def check_kernels(H, torch, hier, fast):
    from hypre_tpu_torch.seq import dia as dia_mod
    from hypre_tpu_torch.seq import fastmv
    from hypre_tpu_torch.seq.spgemm import ell_transpose

    rng = np.random.default_rng(0)
    results = {}

    # kernels 1 and 2: DIA at 128^3, D=7, f32 and f64
    A = H.laplacian_3d_7pt(N_MAIN, N_MAIN, N_MAIN, dtype=torch.float32,
                           device="cuda")
    dia32 = dia_mod.try_dia(A)
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        dvals = dia32.dvals.to(dtype).contiguous()
        csr = csr_of(H.laplacian_3d_7pt(N_MAIN, N_MAIN, N_MAIN, dtype=dtype,
                                        device="cuda"), torch)
        n, D = dia32.n_rows, dia32.D
        offs_static = tuple(int(o) for o in dia32.offsets.cpu().tolist())
        x = torch.from_numpy(rng.standard_normal(n)).to("cuda", dtype)
        esize = dvals.element_size()
        nbytes = D * n * esize + 2 * n * esize + D * 4
        bms, bby = bound(nbytes, 2.0 * D * n, str(dtype).split(".")[1])
        for name, kern, plain in (
            ("dia_spmv",
             lambda: dia_mod.dia_spmv(dvals, dia32.offsets, x, n,
                                      dia32.margin),
             lambda: dia_mod.dia_spmv_plain(dvals, dia32.offsets, x,
                                            dia32.margin)),
            ("dia_spmv_static",
             lambda: dia_mod.dia_spmv_static(dvals, offs_static, x, n),
             lambda: dia_mod.dia_spmv_static_plain(dvals, offs_static, x)),
        ):
            rel, ab = rel_err(kern(), plain(), torch)
            rel_lib, _ = rel_err(kern(), (csr @ x[:, None])[:, 0], torch)
            rec = {"check": name, "dtype": str(dtype), "shape": [D, n],
                   "max_rel_err": rel, "max_abs_err": ab, "tol": tol,
                   "rel_err_vs_csr": rel_lib,
                   "ms": time_ms(kern, torch),
                   "plain_ms": time_ms(plain, torch, warmup=2, reps=10),
                   "bound_ms": bms, "bound_by": bby,
                   "library_ms": time_ms(lambda: csr @ x[:, None], torch)}
            log(json.dumps(rec))
            require(rel <= tol, f"{name} {dtype}: rel err {rel} > {tol}")
            if dtype == torch.float32:
                results[name] = rec

    # kernels 3 and 4 on every banded P and on the largest coarse A
    coarse = [li for li in range(1, len(fast.levels))
              if isinstance(fast.levels[li].A, fastmv.BandedEll)]
    require(isinstance(fast.levels[0].P, fastmv.BandedEll),
            "level-0 P is not banded")
    require(bool(coarse), "no banded coarse A")
    big = max(coarse, key=lambda li: fast.levels[li].A.n_rows)
    ops = [(f"P{li}", hier.levels[li].P, lv.P)
           for li, lv in enumerate(fast.levels)
           if isinstance(lv.P, fastmv.BandedEll)]
    # listed last: the kernels line reports the largest coarse A
    ops.append((f"A{big}", hier.levels[big].A, fast.levels[big].A))
    for label, ell, band in ops:
        k, n_pad = band.vals_t.shape
        payload = k * n_pad * 8 + band.starts.numel() * 4
        flops = 2.0 * k * band.n_rows
        csr = csr_of(ell, torch)
        csr_t = csr_of(ell_transpose(ell), torch)
        x = torch.from_numpy(rng.standard_normal(band.n_cols)) \
            .to("cuda", torch.float32)
        r = torch.from_numpy(rng.standard_normal(band.n_rows)) \
            .to("cuda", torch.float32)
        io = (band.n_cols + band.n_rows) * 4

        def kern():
            return fastmv.banded_spmv(band, x)

        def plain():
            return fastmv.banded_spmv_plain(band.vals_t, band.lcols_t,
                                            band.starts, x, band.n_rows,
                                            band.B)

        rel, ab = rel_err(kern(), plain(), torch)
        rel_lib, _ = rel_err(kern(), (csr @ x[:, None])[:, 0], torch)
        bms, bby = bound(payload + io, flops, "float32")
        rec = {"check": "banded_spmv", "operator": label, "shape": [k, n_pad],
               "n_rows": band.n_rows, "n_cols": band.n_cols,
               "max_rel_err": rel, "max_abs_err": ab, "tol": 1e-6,
               "rel_err_vs_csr": rel_lib,
               "ms": time_ms(kern, torch),
               "plain_ms": time_ms(plain, torch, warmup=2, reps=10),
               "bound_ms": bms, "bound_by": bby,
               "library_ms": time_ms(lambda: csr @ x[:, None], torch)}
        log(json.dumps(rec))
        require(rel <= 1e-6, f"banded_spmv {label}: rel err {rel}")

        # kernel 4 reads the transpose schedule; the coarse A gets one here
        # for this timing row (the solve restricts through P only)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        band_t = fastmv.with_transpose_schedule(band)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if band.t_vals is not None:
            require(all(torch.equal(getattr(band, f), getattr(band_t, f))
                        for f in ("t_vals", "t_rows", "t_colptr",
                                  "t_chunks")),
                    f"{label}: the schedule differs when built again")
        nnz = int(band_t.t_colptr[-1])
        sched_bytes = sum(getattr(band_t, f).numel() * 4 for f in
                          ("t_vals", "t_rows", "t_colptr", "t_chunks"))
        seg = band_t.t_colptr[1:] - band_t.t_colptr[:-1]

        def kern_t():
            return fastmv.banded_spmv_t(band_t, r)

        def plain_t():
            return fastmv.banded_spmv_t_plain(band_t.t_vals, band_t.t_rows,
                                              band_t.t_colptr, r)

        y1, y2 = kern_t(), kern_t()
        rel_t, ab_t = rel_err(y1, plain_t(), torch)
        rel_lib_t, _ = rel_err(y1, (csr_t @ r[:, None])[:, 0], torch)
        rerun, _ = rel_err(y2, y1, torch)
        # the bytes the function must move whatever implements it: a value
        # and a row (or column) index per nonzero, r read and y written
        # once, and the pointers that delimit the columns and the chunks
        bms_t, bby_t = bound(
            nnz * 8 + io
            + (band_t.t_colptr.numel() + band_t.t_chunks.numel()) * 4,
            2.0 * nnz, "float32")
        rec_t = {"check": "banded_spmv_t", "operator": label,
                 "n_rows": band.n_rows, "n_cols": band.n_cols, "nnz": nnz,
                 "schedule_bytes": sched_bytes,
                 "schedule_build_s": build_s,
                 "chunks": band_t.t_chunks.numel() - 1,
                 "longest_segment": int(seg.max()),
                 "mean_segment": nnz / max(band.n_cols, 1),
                 "max_rel_err": rel_t, "max_abs_err": ab_t, "tol": 1e-6,
                 "rel_err_vs_csr": rel_lib_t, "run_to_run_rel": rerun,
                 "ms": time_ms(kern_t, torch),
                 "plain_ms": time_ms(plain_t, torch, warmup=2, reps=10),
                 "bound_ms": bms_t, "bound_by": bby_t,
                 "library_ms": time_ms(lambda: csr_t @ r[:, None], torch)}
        log(json.dumps(rec_t))
        require(rel_t <= 1e-6, f"banded_spmv_t {label}: rel err {rel_t}")
        require(rerun == 0.0 and bool(torch.equal(y1, y2)),
                f"banded_spmv_t {label}: two runs differ ({rerun})")
        for name, rc in (("banded_spmv", rec), ("banded_spmv_t", rec_t)):
            # the largest error over all operators beside the last one's times
            prev = results.get(name)
            results[name] = rc if prev is None else dict(
                rc, max_abs_err=max(rc["max_abs_err"], prev["max_abs_err"]))
    return results


def card_vs_cpu(H, kernels, torch):
    """The same path on the card and on the CPU (plain versions): same
    levels, same operator formats, same iteration count. 24^3 float64
    holds the setup and the DIA path (no operator is banded there, and
    float64 never is); 48^3 float32 also runs the banded kernels, which
    the CPU run replaces by their plain versions
    (``prefer_pallas=True``)."""
    from hypre_tpu_torch.seq import fastmv

    for n, dtype, rtol in ((N_PARITY, torch.float64, 1e-8),
                           (N_PARITY_BANDED, torch.float32, 1e-6)):
        out = {}
        for device in ("cuda", "cpu"):
            kernels.reset_launches()
            A = H.laplacian_3d_7pt(n, n, n, dtype=dtype, device=device)
            hier = H.setup_hierarchy(A, device=device, **SETUP_KW)
            fast = H.optimize_hierarchy(hier, gather_precision=0,
                                        prefer_pallas=True, device=device)
            b = torch.ones(A.n_rows, dtype=dtype, device=device)
            x, info = solve(H, fast, fast.levels[0].A, b, device, rtol)
            out[device] = {"levels": level_sizes(hier),
                           "formats": [[type(lv.A).__name__,
                                        type(lv.P).__name__]
                                       for lv in fast.levels],
                           "iterations": int(info.iterations),
                           "converged": bool(info.converged),
                           "relative_residual":
                               float(info.relative_residual),
                           "launches": dict(kernels.LAUNCHES)}
        tag = f"{n}^3 {str(dtype).split('.')[1]}"
        log(json.dumps({"card_vs_cpu": tag, **out}))
        require(out["cuda"]["converged"] and out["cpu"]["converged"],
                f"{tag} solve did not converge")
        require(out["cuda"]["levels"] == out["cpu"]["levels"],
                f"{tag}: level sizes differ between card and CPU")
        require(out["cuda"]["formats"] == out["cpu"]["formats"],
                f"{tag}: operator formats differ between card and CPU")
        require(out["cuda"]["iterations"] == out["cpu"]["iterations"],
                f"{tag}: iteration counts differ between card and CPU")
        require(not any(out["cpu"]["launches"].values()),
                f"{tag}: the CPU run launched a kernel")
        if dtype == torch.float32:
            require(isinstance(fast.levels[0].P, fastmv.BandedEll),
                    f"{tag}: level-0 P is not banded")
            for name in ("banded_spmv", "banded_spmv_t"):
                require(out["cuda"]["launches"][name] > 0,
                        f"{tag}: the card run never launched {name}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import hypre_tpu_torch as H
    from hypre_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False  # coarse solve in full f32
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for stem, out in kernels.BUILD_LOG.items():
        log(f"--- nvcc {stem}.cu ---\n{out.strip()}")

    hier, fast, l_dyn, it_dyn = run_main_path(H, kernels, torch, False)
    _, _, l_st, it_st = run_main_path(H, kernels, torch, True, hier=hier)
    require(it_dyn == it_st, f"dynamic ({it_dyn}) and specialized ({it_st}) "
            "solves took different iteration counts")
    for name in ("dia_spmv", "banded_spmv", "banded_spmv_t"):
        require(l_dyn[name] > 0, f"dynamic path never launched {name}")
    for name in ("dia_spmv_static", "banded_spmv", "banded_spmv_t"):
        require(l_st[name] > 0, f"specialized path never launched {name}")
    per_iteration_launches(H, kernels, torch, fast)

    results = check_kernels(H, torch, hier, fast)
    card_vs_cpu(H, kernels, torch)

    line = []
    for name, (src, replaces) in SOURCES.items():
        rc = results[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": l_dyn[name] + l_st[name],
                     "max_abs_err": rc["max_abs_err"], "ms": rc["ms"],
                     "plain_ms": rc["plain_ms"], "bound_ms": rc["bound_ms"],
                     "bound_by": rc["bound_by"],
                     "library_ms": rc["library_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
