#!/usr/bin/env python3
"""A real multi-process solve of hypre_tpu_torch over NCCL, one card a
process.

    python3 multicard_smoke.py

It needs four CUDA cards. It starts four processes; each takes one card,
joins the process group through ``parallel.multihost.init_multihost``
(NCCL) and holds one shard of the ``dist`` mesh. Then, in every process:

1. The 7-pt N3D^3 Laplacian (float32) is partitioned over the mesh
   (``partition_ell``) and ``setup_hierarchy_par`` runs across the four
   processes (its host CommPkg work gathered by ``all_gather_object``).
2. PCG with the l1-Jacobi V-cycle (``amg_cycle``) on that hierarchy, to
   RTOL: the inner products are global sums (``pcg(..., mesh=)``) and
   the coarse solve gathers its right-hand side
   (``amg.hierarchy.coarse_solve``).
3. PCG + ParILU (``precond/par_ilu.py``, the distributed Chow-Patel
   ILU(0)) on the ILU_N^3 Laplacian.
4. The device ms of one halo exchange of A (NVLink between the cards)
   and of one ``par_spmv``.

Process 0 then leaves the group and runs the same paths with the four
shards on its own card (the ``local`` backend), as ``chip_smoke.py``
phase 17 does: the levels and the iterations must be equal, x must agree
to XTOL, and the exchange on one card is timed beside the NVLink one.
Every process's output goes to ``chiprun_out/multicard_rank<r>.log``;
process 0's summary is printed, then the card's name and power limit,
then ``{"ok": true, ...}`` as the last line. It exits non-zero if any
process fails or any check does not hold.

``python3 multicard_smoke.py --rehearse-cpu`` runs the same four
processes on the CPU over gloo, in float64 at REHEARSAL sizes, with no
card and no timing (and prints no ``ok`` line). ``solve_checks`` and
``compare`` are also what the CPU tests run on two gloo processes
(``tests/test_torch_multihost.py``), at small sizes.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out")
WORLD = 4
N3D = 128
ILU_N = 128
RTOL = 1e-6
MAXITER = 1000
MAX_COARSE = 1500
XTOL = 1e-4  # float32: x from two summation orders of the same solve
TIMEOUT_S = 900
# --rehearse-cpu: gloo on the CPU, float64, x within REHEARSAL["xtol"]
REHEARSAL = dict(n3d=16, ilu_n=16, max_coarse=64, xtol=1e-10)


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(torch, device, fn):
    """(result, seconds) of fn() between two synchronizes."""
    _sync(torch, device)
    t0 = time.perf_counter()
    out = fn()
    _sync(torch, device)
    return out, time.perf_counter() - t0


def _device_ms(torch, fn, reps: int = 20) -> float:
    """Mean device ms of fn() by CUDA events, after two warm calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _laplacian(H, torch, shape, dtype, device):
    if len(shape) == 2:
        return H.laplacian_2d_5pt(*shape, dtype=dtype, device=device)
    return H.laplacian_3d_7pt(*shape, dtype=dtype, device=device)


def solve_checks(mesh, dtype, amg_shape, ilu_shape, struct_shape=None,
                 rtol=RTOL, max_coarse=MAX_COARSE, timing=False) -> dict:
    """Every distributed solve on ``mesh`` (either backend): PCG + the
    l1-Jacobi V-cycle on ``setup_hierarchy_par``'s hierarchy of the
    Laplacian of ``amg_shape``, PCG + ParILU on that of ``ilu_shape``, and
    (``struct_shape``) PFMG on slabs (``distribute_pfmg``). Returns per
    path its iterations, converged flag, x (global, numpy), the levels,
    and with ``timing`` its setup seconds and warm solve ms."""
    import torch

    import hypre_tpu_torch as H
    from hypre_tpu_torch.parallel import partition_ell
    from hypre_tpu_torch.parallel.par_ell import (
        collect_vector, distribute_vector, exchange, par_spmv,
    )
    from hypre_tpu_torch.parallel.par_setup import setup_hierarchy_par
    from hypre_tpu_torch.precond.par_ilu import ParILU

    dev = mesh.device
    out = {}

    def record(key, x, info, n, **extra):
        out[key] = dict(iterations=int(info.iterations),
                        converged=bool(info.converged),
                        x=collect_vector(x, n, mesh), **extra)

    A = _laplacian(H, torch, amg_shape, dtype, dev)
    Ap = partition_ell(A, mesh)
    hier, setup_s = _timed(torch, dev, lambda: setup_hierarchy_par(
        Ap, max_coarse_size=max_coarse))
    sm = H.make_smoother("l1-jacobi", 1.0, 2, 0.3)
    bd = distribute_vector(torch.ones(A.n_rows, dtype=dtype), mesh)

    def amg_solve():
        return H.pcg(Ap.mv, bd, M=lambda r: H.amg_cycle(hier, r, smoother=sm),
                     rtol=rtol, maxiter=MAXITER, device=dev, mesh=mesh)

    (x, info), s = _timed(torch, dev, amg_solve)
    extra = {"levels": [lv.A.n_rows for lv in hier.levels]
             + [hier.levels[-1].P.n_cols] if hier.levels else []}
    if timing:
        _, warm = _timed(torch, dev, amg_solve)
        send = distribute_vector(torch.ones(A.n_rows, dtype=dtype),
                                 mesh)[Ap.send_index]
        xd = distribute_vector(torch.ones(A.n_rows, dtype=dtype), mesh)
        extra.update(setup_s=setup_s, first_solve_ms=s * 1e3,
                     warm_solve_ms=warm * 1e3,
                     exchange_bytes=Ap.exchange_bytes(),
                     exchange_ms=_device_ms(torch, lambda: exchange(
                         mesh, send, Ap.offsets, Ap.sizes)),
                     par_spmv_ms=_device_ms(torch, lambda: par_spmv(Ap, xd)))
    record("pcg_l1_jacobi", x, info, A.n_rows, **extra)
    del hier, Ap, A

    A = _laplacian(H, torch, ilu_shape, dtype, dev)
    Ap = partition_ell(A, mesh)
    ilu, setup_s = _timed(torch, dev, lambda: ParILU().setup(Ap))
    bd = distribute_vector(torch.ones(A.n_rows, dtype=dtype), mesh)

    def ilu_solve():
        return H.pcg(Ap.mv, bd, M=ilu.precond(), rtol=rtol,
                     maxiter=MAXITER, device=dev, mesh=mesh)

    (x, info), s = _timed(torch, dev, ilu_solve)
    extra = {}
    if timing:
        _, warm = _timed(torch, dev, ilu_solve)
        extra = dict(setup_s=setup_s, first_solve_ms=s * 1e3,
                     warm_solve_ms=warm * 1e3)
    record("pcg_par_ilu", x, info, A.n_rows, **extra)
    del ilu, Ap, A

    if struct_shape is not None:
        from hypre_tpu_torch.problems.struct_problems import struct_laplacian
        from hypre_tpu_torch.struct import PFMG
        from hypre_tpu_torch.struct.par_struct import (
            distribute_pfmg, distribute_struct_vector,
        )

        A = struct_laplacian(struct_shape, dtype=dtype, device=dev)
        sd = distribute_pfmg(PFMG().setup(A), mesh)
        b = torch.from_numpy(np.random.default_rng(1).standard_normal(
            struct_shape)).to(dev, dtype)
        x, info = sd.solve(distribute_struct_vector(b, mesh), rtol=rtol)
        out["pfmg"] = dict(iterations=int(info.iterations),
                           converged=bool(info.converged),
                           x=sd.fine_layout.gather(x).cpu().numpy())
    return out


def compare(dist: dict, local: dict, xtol: float) -> list:
    """The checks the dist runs must pass against the local ones: the
    same levels and iterations, converged, x within ``xtol`` (relative
    to max |x|). Returns the failures (empty when all hold)."""
    bad = []
    for key, d in dist.items():
        ref = local[key]
        if d["iterations"] != ref["iterations"]:
            bad.append(f"{key}: {d['iterations']} iterations, local "
                       f"{ref['iterations']}")
        if not (d["converged"] and ref["converged"]):
            bad.append(f"{key}: did not converge")
        if d.get("levels") != ref.get("levels"):
            bad.append(f"{key}: levels {d.get('levels')} != "
                       f"{ref.get('levels')}")
        err = float(np.abs(d["x"] - ref["x"]).max()
                    / max(np.abs(ref["x"]).max(), 1e-300))
        if not err <= xtol:
            bad.append(f"{key}: x off the local run's by {err}")
    return bad


def _summary(res: dict) -> dict:
    return {k: {kk: vv for kk, vv in v.items() if kk != "x"}
            for k, v in res.items()}


def worker(rank: int, port: int, cpu: bool) -> int:
    import torch
    import torch.distributed as dist

    from hypre_tpu_torch.parallel import (
        init_multihost, make_mesh, shutdown_multihost,
    )

    if cpu:
        torch.set_num_threads(1)
        device, dtype, xtol = "cpu", torch.float64, REHEARSAL["xtol"]
        kw = dict(amg_shape=(REHEARSAL["n3d"],) * 3,
                  ilu_shape=(REHEARSAL["ilu_n"],) * 3,
                  max_coarse=REHEARSAL["max_coarse"])
    else:
        torch.cuda.set_device(rank)
        device, dtype, xtol = f"cuda:{rank}", torch.float32, XTOL
        kw = dict(amg_shape=(N3D,) * 3, ilu_shape=(ILU_N,) * 3, timing=True)
    init_multihost(f"127.0.0.1:{port}", num_processes=WORLD,
                   process_id=rank, backend="gloo" if cpu else "nccl",
                   timeout_s=TIMEOUT_S)
    mesh = make_mesh(WORLD, device=device, backend="dist")
    dist_res = solve_checks(mesh, dtype, **kw)
    print(json.dumps({"rank": rank, "backend": "dist",
                      "group": dist.get_backend(),
                      "results": _summary(dist_res)}), flush=True)
    dist.barrier()
    shutdown_multihost()
    if rank != 0:
        return 0
    local = make_mesh(WORLD, device="cpu" if cpu else "cuda:0",
                      backend="local")
    local_res = solve_checks(local, dtype, **kw)
    print(json.dumps({"rank": 0, "backend": "local", "shards": WORLD,
                      "results": _summary(local_res)}), flush=True)
    bad = compare(dist_res, local_res, xtol)
    d, l_ = dist_res["pcg_l1_jacobi"], local_res["pcg_l1_jacobi"]
    if cpu:
        print(json.dumps({"multicard": "summary", "rehearsal": True,
                          "levels": d["levels"],
                          "pcg_iterations": [d["iterations"],
                                             l_["iterations"]],
                          "par_ilu_iterations": [
                              dist_res["pcg_par_ilu"]["iterations"],
                              local_res["pcg_par_ilu"]["iterations"]],
                          "failures": bad}), flush=True)
        return 1 if bad else 0
    print(json.dumps({
        "multicard": "summary", "processes": WORLD, "n": N3D ** 3,
        "levels": d["levels"], "levels_one_card": l_["levels"],
        "pcg_iterations": d["iterations"],
        "pcg_iterations_one_card": l_["iterations"],
        "setup_s": d["setup_s"], "setup_s_one_card": l_["setup_s"],
        "solve_ms": d["warm_solve_ms"],
        "solve_ms_one_card": l_["warm_solve_ms"],
        "halo_exchange_ms_nvlink": d["exchange_ms"],
        "halo_exchange_ms_one_card": l_["exchange_ms"],
        "exchange_bytes": d["exchange_bytes"],
        "par_spmv_ms": d["par_spmv_ms"],
        "par_spmv_ms_one_card": l_["par_spmv_ms"],
        "par_ilu_iterations": dist_res["pcg_par_ilu"]["iterations"],
        "par_ilu_iterations_one_card":
            local_res["pcg_par_ilu"]["iterations"],
        "par_ilu_solve_ms": dist_res["pcg_par_ilu"]["warm_solve_ms"],
        "par_ilu_solve_ms_one_card":
            local_res["pcg_par_ilu"]["warm_solve_ms"],
        "failures": bad}), flush=True)
    return 1 if bad else 0


def main() -> int:
    args = dict(a.lstrip("-").split("=", 1) if "=" in a else
                (a.lstrip("-"), "1") for a in sys.argv[1:])
    cpu = "rehearse-cpu" in args
    if "rank" in args:
        return worker(int(args["rank"]), int(args["port"]), cpu)
    try:
        import torch
    except ImportError:
        print("multicard_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not cpu and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < WORLD):
        print(f"multicard_smoke: needs {WORLD} CUDA cards", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "hypre_tpu_torch")):
        print("multicard_smoke: hypre_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = [open(os.path.join(OUT, f"multicard_rank{r}.log"), "w")
            for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), f"--rank={r}",
         f"--port={port}"] + (["--rehearse-cpu"] if cpu else []),
        stdout=logs[r], stderr=subprocess.STDOUT, cwd=HERE)
        for r in range(WORLD)]
    codes = []
    try:
        for p in procs:
            try:
                codes.append(p.wait(timeout=TIMEOUT_S))
            except subprocess.TimeoutExpired:
                codes.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    with open(os.path.join(OUT, "multicard_rank0.log")) as f:
        lines = f.read().splitlines()
    for line in lines[-40:]:
        print(line)
    summary = [json.loads(l) for l in lines
               if l.startswith('{"multicard": "summary"')]
    failed = (any(c != 0 for c in codes) or not summary
              or summary[0]["failures"])
    if cpu:
        print(f"multicard_smoke: rehearsal on the CPU "
              f"{'FAILED' if failed else 'passed'} (exit codes {codes})")
        return 1 if failed else 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else
          "nvidia-smi: no output")
    if failed:
        print(f"multicard_smoke: FAILED (exit codes {codes})",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
