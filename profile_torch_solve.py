#!/usr/bin/env python3
"""Where the time goes in hypre_tpu_torch's main path, on one CUDA card.

    python3 profile_torch_solve.py

Runs chip_smoke.py's two paths with its configurations (N_MAIN, SETUP_KW,
BENCH_KW) on the 128^3 7-pt Laplacian in float32: the pure setup, and the
device setup of the reference bench (aggressive first level, multipass
interpolation, slab RAP, transfer_dia True and False); each followed by
optimize_hierarchy and AMG-PCG at rtol 1e-6. It prints one JSON object
with, for the pure path at the top level and for the other two under
"device_setup":

- setup: host seconds per setup stage (each stage bracketed by
  torch.cuda.synchronize()), summed over levels; for the device setup
  instead its stage spans from one profiled setup (device ms launched
  inside each ``setup.L<l>.<stage>`` span and its host ms), the seconds
  of warm setups without a profiler, and the seconds of its slab sorts
  (every ``sort_slab`` call bracketed by a synchronize, in a run of its
  own);
- solve: warm solve seconds (host clock after synchronize) for the dynamic
  and the specialized DIA kernel, in turns, REPEATS times each, and the
  seconds of ``optimize_hierarchy`` (formats, transpose schedules, row-list
  layouts) for each, cold and warm;
- tile_occupancy (TransferDia only): per row-tile height, the share of
  (plane, tile) pairs of the level-0 transfer planes that hold a nonzero;
- profile: one warm specialized solve under torch.profiler — device time
  per kernel name (top 15), total device time, and the device busy share
  (device time over the host wall time of an unprofiled warm solve, and
  over that of the profiled one, which the profiler slows);
- facade: chip_smoke.py's facade solves — the BoomerAMG facade's cold and
  warm setup seconds, then for each Krylov driver with the facade as M
  and for ``amg.solve`` its iterations, warm wall times and one profiled
  call, as above.

Every device setup it runs takes the slow path, whatever earlier runs
recorded: it sets HYPRE_TPU_NO_FAST_SETUP=1 and a shape registry of its own
in a temporary directory, and each timed setup's record says which path
built it ("replayed"). The replay of a recorded setup is timed by
time_device_setup.py.

The object is also written to chiprun_out/profile_torch_solve.json. It
imports nothing of JAX or of hypre_tpu.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

from chip_smoke import BENCH_KW, N_MAIN, SETUP_KW, facade_solves

HERE = os.path.dirname(os.path.abspath(__file__))
REPEATS = 3


def sort_seconds(H, torch, A, kw) -> dict:
    """Host seconds spent in slabops.sort_slab during one device setup,
    every call bracketed by a device synchronize, and the call count."""
    from hypre_tpu_torch.seq import slabops

    spent = {"seconds": 0.0, "calls": 0}
    plain = slabops.sort_slab

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain(*a, **k)
        torch.cuda.synchronize()
        spent["seconds"] += time.perf_counter() - t0
        spent["calls"] += 1
        return out

    slabops.sort_slab = timed
    try:
        H.setup_hierarchy_device(A, **kw)
    finally:
        slabops.sort_slab = plain
    return spent


def stage_spans(torch, fn) -> tuple[dict, float]:
    """One call of ``fn`` (a device setup) under torch.profiler: for each
    of its stage spans (``setup.L<l>.<stage>``, ``setup.coarse_inv``) the
    device ms of the work launched inside it and the host ms it lasted;
    and the call's host seconds, which the profiler slows."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(e):
        us = getattr(e, "device_time_total", None)
        return getattr(e, "cuda_time_total", 0.0) if us is None else us

    stages = {}
    for e in prof.events():
        if not e.name.startswith(("setup.L", "setup.coarse_inv")):
            continue
        got = stages.setdefault(e.name, {"device_ms": 0.0, "host_ms": 0.0})
        # the ops inside the span: the span's own device entry is the
        # range of those same kernels, and would count them twice
        got["device_ms"] += sum(map(device_us, e.cpu_children)) / 1e3
        got["host_ms"] += e.cpu_time_total / 1e3
    return stages, wall


def tile_occupancy(torch, M, tiles=(8, 32, 128, 256)) -> dict:
    """Share of (plane, row tile) pairs of a DIA operator's planes that
    hold any nonzero, per tile height: the part of the planes a kernel
    that skips all-zero tiles would still read."""
    nz = M.dvals != 0
    D, n = nz.shape
    out = {}
    for t in tiles:
        m = -(-n // t) * t
        tiles_nz = torch.nn.functional.pad(nz, (0, m - n)).view(D, m // t, t)
        out[t] = float(tiles_nz.any(dim=2).float().mean())
    return out


def solve_and_profile(H, torch, hier, sm, b):
    """Warm solves of ``hier`` with the dynamic and the specialized DIA
    kernel, then one specialized solve under torch.profiler."""
    fast, optimize_s = {}, {}
    for spec in (False, True, False, True):  # the second of each is warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fast[spec] = H.optimize_hierarchy(hier, gather_precision=0,
                                          specialize=spec, device="cuda")
        torch.cuda.synchronize()
        optimize_s.setdefault(spec, []).append(time.perf_counter() - t0)

    def solve(spec):
        f = fast[spec]
        return H.pcg(f.levels[0].A.mv, b,
                     M=lambda r: H.amg_cycle(f, r, smoother=sm),
                     rtol=1e-6, maxiter=100, device="cuda")

    for spec in (False, True):  # warm-up
        solve(spec)
    times = {False: [], True: []}
    iters = {}
    for _ in range(REPEATS):
        for spec in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, info = solve(spec)
            torch.cuda.synchronize()
            times[spec].append(time.perf_counter() - t0)
            iters[spec] = int(info.iterations)

    return (
        {"iterations": iters[True], "dynamic_s": times[False],
         "specialized_s": times[True],
         "optimize_s": {"dynamic": optimize_s[False],
                        "specialized": optimize_s[True]}},
        device_profile(torch, lambda: solve(True), min(times[True])))


def kernel_times(torch, averages) -> list:
    """(name, device ms, launches) of each kernel, copy and set in a
    profile's ``key_averages``, longest first. Device-side entries only:
    an aten op's self device time repeats the time of the kernels it
    launched. The program's spans (``core/timing.py::annotate``) are left
    out too: under CUDA activity each is also a device-side entry
    (``gpu_user_annotation``) whose time is that of the kernels inside
    it, so nested spans would count a kernel once per enclosing span."""
    per_kernel = []
    for e in averages:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            per_kernel.append((e.key, dev_us / 1e3, e.count))
    return sorted(per_kernel, key=lambda t: -t[1])


def device_profile(torch, fn, warm_s: float) -> dict:
    """One call of ``fn`` under torch.profiler: device time per kernel
    name (top 15), total device time, and the device busy share (device
    time over ``warm_s``, the host wall time of an unprofiled warm call,
    and over that of the profiled one, which the profiler slows)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = kernel_times(torch, prof.key_averages())
    device_ms = sum(t[1] for t in per_kernel)
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / (warm_s * 1e3),
            "busy_share_profiled": device_ms / (wall * 1e3),
            "top": [{"name": k[:120], "ms": ms, "count": c}
                    for k, ms, c in per_kernel[:15]]}


def facade_profile(H, torch, A) -> dict:
    """chip_smoke.py's facade solves (BoomerAMG(max_coarse_size=1500) on
    the card): cold and warm setup seconds, then per solver its
    iterations, REPEATS warm wall times and one profiled call."""
    # the device setups before this leave the allocator's cache fragmented
    torch.cuda.empty_cache()
    setup_s = []
    for _ in range(2):  # cold, warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        amg = H.BoomerAMG(max_coarse_size=1500).setup(A)
        torch.cuda.synchronize()
        setup_s.append(time.perf_counter() - t0)
    b = torch.ones(A.n_rows, dtype=torch.float32, device="cuda")
    out = {"setup_s": {"cold": setup_s[0], "warm": setup_s[1]}}
    for name, solve in facade_solves(H, amg, b).items():
        _, info = solve()  # warm-up
        times = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = {"iterations": int(info.iterations), "warm_s": times,
                     "profile": device_profile(torch, solve, min(times))}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_solve: no CUDA device", file=sys.stderr)
        return 2
    registry = tempfile.mkdtemp(prefix="profile_torch_registry_")
    atexit.register(shutil.rmtree, registry, True)
    os.environ["HYPRE_TPU_TORCH_SHAPE_REGISTRY"] = os.path.join(
        registry, "shapes.json")
    os.environ["HYPRE_TPU_NO_FAST_SETUP"] = "1"
    sys.path.insert(0, HERE)
    import hypre_tpu_torch as H
    from hypre_tpu_torch.amg import hierarchy as hmod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    stage_s = defaultdict(float)
    plain = {}
    for name in ("strength_mask", "pmis", "coarse_map", "ext_plus_i_interp",
                 "truncate_interp", "ell_transpose", "ell_spgemm",
                 "_level_vectors", "_coarse_pinv"):
        fn = plain[name] = getattr(hmod, name)

        def timed(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            stage_s[_name] += time.perf_counter() - t0
            return out

        setattr(hmod, name, timed)

    n = N_MAIN
    A = H.laplacian_3d_7pt(n, n, n, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hier = H.setup_hierarchy(A, device="cuda", **SETUP_KW)
    torch.cuda.synchronize()
    setup_total = time.perf_counter() - t0
    for name, fn in plain.items():  # later setups run unbracketed
        setattr(hmod, name, fn)
    sm = H.make_smoother("chebyshev", 1.0, 2, 0.3)
    b = torch.ones(A.n_rows, dtype=torch.float32, device="cuda")
    solve_rec, profile_rec = solve_and_profile(H, torch, hier, sm, b)

    device_setup = {}
    for tdia in (True, False):
        kw = dict(BENCH_KW, transfer_dia=tdia)
        H.setup_hierarchy_device(A, **kw)  # warm-up
        stages, profiled_total = stage_spans(
            torch, lambda: H.setup_hierarchy_device(A, **kw))
        plain_s, replayed = [], []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            dhier = H.setup_hierarchy_device(A, **kw)
            torch.cuda.synchronize()
            plain_s.append(time.perf_counter() - t0)
            replayed.append(dhier.replayed)
        peak = torch.cuda.max_memory_allocated()
        sort_s = sort_seconds(H, torch, A, kw)
        d_solve, d_profile = solve_and_profile(H, torch, dhier, sm, b)
        occupancy = None
        if tdia:
            T = dhier.levels[0].P
            occupancy = {"P_dia": tile_occupancy(torch, T.P_dia),
                         "Pt_dia": tile_occupancy(torch, T.Pt_dia),
                         "nonzero_share": float((T.P_dia.dvals != 0)
                                                .float().mean())}
        device_setup["transfer_dia" if tdia else "banded_p"] = {
            "true_levels": list(dhier.n_level_true),
            "levels": [lv.A.n_rows for lv in dhier.levels]
            + [dhier.coarse_inv.shape[0]],
            "setup": {"total_s": plain_s, "replayed": replayed,
                      "profiled_total_s": profiled_total,
                      "stages_ms": stages, "sort_slab_s": sort_s,
                      "peak_bytes": peak},
            "solve": d_solve, "profile": d_profile,
            "tile_occupancy": occupancy}

    facade = facade_profile(H, torch, A)
    out = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "n": A.n_rows,
        "levels": [lv.A.n_rows for lv in hier.levels]
        + [hier.coarse_inv.shape[0]],
        "setup": {"total_s": setup_total, "stages_s": dict(stage_s)},
        "solve": solve_rec, "profile": profile_rec,
        "device_setup": device_setup, "facade": facade,
    }
    text = json.dumps(out)
    print(text, flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_torch_solve.json"),
              "w") as fh:
        fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
