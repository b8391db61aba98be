#!/usr/bin/env python3
"""The device setup's slow path and its replay, each in fresh processes, on
one CUDA card.

    python3 time_device_setup.py [EARLIER_TREE]

The problem is chip_smoke.py's bench configuration: the 7-pt N_MAIN^3
Laplacian in float32, ``setup_hierarchy_device`` with BENCH_KW and
transfer_dia=True. Every measurement runs in a process of its own, with a
shape registry in a temporary directory:

- ``record``: one setup on an empty registry (the slow path, which records
  the ladder);
- then ROUNDS times, in turns, ``slow`` (HYPRE_TPU_NO_FAST_SETUP=1) and
  ``replay`` (the recorded ladder): each times its first setup (cold: the
  first launch of each CUDA kernel and the allocator's first segments in
  that process) and WARM more. ``slow`` then turns the replay on and times
  WARM replays after its slow setups, as chip_smoke.py's replay phase
  does;
- ``profile``: the first and the second replay of a fresh process under
  torch.profiler, their top host-side calls by self time;
- with EARLIER_TREE (a directory holding an earlier ``hypre_tpu_torch``):
  that tree's slow path and this tree's, in turns (earlier, this, this,
  earlier), one warm-up setup and WARM timed setups each.

Every setup is timed on the host clock from a synchronized card to the end
of a synchronize after it. Beside each stand which path built it, the
new segments the caching allocator took with ``cudaMalloc`` during it
(their count and bytes) and, for a replay, the host seconds until its one read and the
seconds that read waited for the card. The summary is printed as one JSON
object and written to chiprun_out/time_device_setup.json. It imports
nothing of JAX or of hypre_tpu.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 2
WARM = 4


def bench_config():
    """(N_MAIN, BENCH_KW) of this tree's chip_smoke.py, loaded by path so
    that an earlier tree's package is the one imported."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_config", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.N_MAIN, dict(mod.BENCH_KW, transfer_dia=True)


def worker(tree: str, mode: str) -> dict:
    import torch

    sys.path.insert(0, tree)
    import hypre_tpu_torch as H
    from hypre_tpu_torch.amg import device_setup as ds

    pkg = os.path.dirname(os.path.abspath(H.__file__))
    assert pkg == os.path.join(os.path.abspath(tree), "hypre_tpu_torch"), pkg
    n, kw = bench_config()
    A = H.laplacian_3d_7pt(n, n, n, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()

    read = {}
    if hasattr(ds, "_read_back"):
        plain_read = ds._read_back

        def timed_read(t):
            read["at"] = time.perf_counter()
            out = plain_read(t)
            read["wait_s"] = time.perf_counter() - read["at"]
            return out

        ds._read_back = timed_read

    def one(tag: str) -> dict:
        read.clear()
        torch.cuda.synchronize()
        s0 = torch.cuda.memory_stats()
        t0 = time.perf_counter()
        h = H.setup_hierarchy_device(A, device="cuda", **kw)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        s1 = torch.cuda.memory_stats()
        rec = {"run": tag, "seconds": s,
               "replayed": bool(getattr(h, "replayed", False)),
               "new_segments": s1.get("segment.all.allocated", 0)
               - s0.get("segment.all.allocated", 0),
               "new_segment_bytes":
                   s1.get("reserved_bytes.all.allocated", 0)
                   - s0.get("reserved_bytes.all.allocated", 0)}
        if read:
            rec["host_s_to_read"] = read["at"] - t0
            rec["read_wait_s"] = read["wait_s"]
        return rec

    out = {"tree": tree, "mode": mode, "package": pkg, "setups": []}
    if mode == "profile":
        from torch.profiler import ProfilerActivity, profile

        for tag in ("first", "second"):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                rec = one(tag)
            top = sorted(prof.key_averages(),
                         key=lambda e: -e.self_cpu_time_total)[:12]
            rec["top_self_cpu_ms"] = [
                [e.key, e.count, e.self_cpu_time_total / 1e3] for e in top]
            out["setups"].append(rec)
        return out
    if mode == "earlier":
        out["setups"].append(one("warm-up"))
        out["setups"] += [one("warm") for _ in range(WARM)]
        return out
    out["setups"].append(one("first"))
    if mode == "record":
        return out
    out["setups"] += [one("warm") for _ in range(WARM)]
    if mode == "slow":
        del os.environ["HYPRE_TPU_NO_FAST_SETUP"]
        out["setups"].append(one("first replay after slow"))
        out["setups"] += [one("replay after slow") for _ in range(WARM)]
    return out


def run_worker(tree: str, mode: str, env: dict) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker", tree, mode],
        env=env, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"worker {tree} {mode} failed "
                         f"(exit {proc.returncode})")
    return json.loads(lines[-1])


def summary(runs: list, first_tag: str, warm_tag: str) -> dict:
    """The seconds of the workers' setups tagged ``first_tag`` and
    ``warm_tag``, and the median of each."""
    first = [s["seconds"] for r in runs for s in r["setups"]
             if s["run"] == first_tag]
    warm = [s["seconds"] for r in runs for s in r["setups"]
            if s["run"] == warm_tag]
    return {"first_s": first, "median_first_s": statistics.median(first),
            "warm_s": warm,
            "median_warm_s": statistics.median(warm) if warm else None}


def main(argv: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_device_setup: no CUDA device", file=sys.stderr)
        return 2
    earlier = os.path.abspath(argv[0]) if argv else None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    reg_dir = tempfile.mkdtemp(prefix="time_device_setup_")
    try:
        env = dict(os.environ, HYPRE_TPU_TORCH_SHAPE_REGISTRY=os.path.join(
            reg_dir, "shapes.json"))
        env.pop("HYPRE_TPU_NO_FAST_SETUP", None)
        slow_env = dict(env, HYPRE_TPU_NO_FAST_SETUP="1")
        runs = {"record": [run_worker(HERE, "record", env)]}
        for _ in range(ROUNDS):
            runs.setdefault("slow", []).append(
                run_worker(HERE, "slow", slow_env))
            runs.setdefault("replay", []).append(
                run_worker(HERE, "replay", env))
        runs["profile"] = [run_worker(HERE, "profile", env)]
        if earlier:
            for tree in (earlier, HERE, HERE, earlier):
                runs.setdefault(tree, []).append(
                    run_worker(tree, "earlier", slow_env))
    finally:
        shutil.rmtree(reg_dir, ignore_errors=True)
    n, kw = bench_config()
    out = {"nvidia_smi": smi, "problem": f"7-pt {n}^3 float32",
           "knobs": kw, "runs": runs,
           "fresh_process": {
               "record": runs["record"][0]["setups"][0],
               "slow": summary(runs["slow"], "first", "warm"),
               "replay": summary(runs["replay"], "first", "warm"),
               "replay_after_slow": summary(
                   runs["slow"], "first replay after slow",
                   "replay after slow")}}
    if earlier:
        out["slow_path"] = {
            "earlier": summary(runs[earlier], "warm-up", "warm"),
            "this": summary(runs[HERE], "warm-up", "warm")}
    replayed = [s["replayed"] for r in runs["replay"] for s in r["setups"]]
    slow = [s["replayed"] for r in runs["slow"] for s in r["setups"]
            if "replay" not in s["run"]]
    replayed += [s["replayed"] for r in runs["slow"] for s in r["setups"]
                 if "replay" in s["run"]]
    out["paths_as_asked"] = all(replayed) and not any(slow)
    text = json.dumps(out)
    print(text, flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "time_device_setup.json"),
              "w") as fh:
        fh.write(text + "\n")
    return 0 if out["paths_as_asked"] else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        print(json.dumps(worker(sys.argv[2], sys.argv[3])), flush=True)
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
