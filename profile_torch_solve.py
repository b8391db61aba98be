#!/usr/bin/env python3
"""Where the time goes in hypre_tpu_torch's main path, on one CUDA card.

    python3 profile_torch_solve.py

Runs chip_smoke.py's main path, with its configuration (N_MAIN, SETUP_KW):
the 128^3 7-pt Laplacian in float32, the pure setup, optimize_hierarchy,
AMG-PCG at rtol 1e-6. It prints one JSON object:

- setup: host seconds per setup stage (each stage bracketed by
  torch.cuda.synchronize()), summed over levels;
- solve: warm solve seconds (host clock after synchronize) for the dynamic
  and the specialized DIA kernel, in turns, REPEATS times each;
- profile: one warm specialized solve under torch.profiler — device time
  per kernel name (top 15), total device time, and the device busy share
  (device time over the host wall time of an unprofiled warm solve, and
  over that of the profiled one, which the profiler slows).

The object is also written to chiprun_out/profile_torch_solve.json. It
imports nothing of JAX or of hypre_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

from chip_smoke import N_MAIN, SETUP_KW

HERE = os.path.dirname(os.path.abspath(__file__))
REPEATS = 3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_solve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import hypre_tpu_torch as H
    from hypre_tpu_torch.amg import hierarchy as hmod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    stage_s = defaultdict(float)
    for name in ("strength_mask", "pmis", "coarse_map", "ext_plus_i_interp",
                 "truncate_interp", "ell_transpose", "ell_spgemm",
                 "_level_vectors", "_coarse_pinv"):
        fn = getattr(hmod, name)

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
    fast = {spec: H.optimize_hierarchy(hier, gather_precision=0,
                                       specialize=spec, device="cuda")
            for spec in (False, True)}
    sm = H.make_smoother("chebyshev", 1.0, 2, 0.3)
    b = torch.ones(A.n_rows, dtype=torch.float32, device="cuda")

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

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = []
    for e in prof.key_averages():
        # device-side events only: an aten op's self device time repeats
        # the time of the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            per_kernel.append((e.key, dev_us / 1e3, e.count))
    per_kernel.sort(key=lambda t: -t[1])
    device_ms = sum(t[1] for t in per_kernel)

    out = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "n": A.n_rows,
        "levels": [lv.A.n_rows for lv in hier.levels]
        + [hier.coarse_inv.shape[0]],
        "setup": {"total_s": setup_total, "stages_s": dict(stage_s)},
        "solve": {"iterations": iters[True],
                  "dynamic_s": times[False], "specialized_s": times[True]},
        "profile": {"wall_ms": wall * 1e3, "device_ms": device_ms,
                    "busy_share": device_ms / (min(times[True]) * 1e3),
                    "busy_share_profiled": device_ms / (wall * 1e3),
                    "top": [{"name": k[:120], "ms": ms, "count": c}
                            for k, ms, c in per_kernel[:15]]},
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
