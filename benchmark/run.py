"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. Set-up (process start to the window's start: imports, the first
build of the kernel libraries, the operator, the setups, the warm-up calls
of the cell's traffic) is ``setup_s``; the window then runs the cell's
traffic for ``--seconds``. With ``--trace 0`` the last line of standard
output is the result with the cell's end-to-end metrics; with
``--trace 1`` a traced segment follows the window and the result carries
the per-layer metrics. The output check runs after the window, and every
number it compares is printed beside its limit, last on standard error
and last in the result."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
# the harness's packages, then the checkout's root (the program under test)
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

import torch  # noqa: E402

from harness import check, spec, trace, traffic, window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hypre_tpu")
STATE_DIR = BENCH_DIR / "_state"


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``hypre_tpu_torch`` is not ``hypre_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def prepare_env() -> None:
    """The program's shape registry starts empty in every run, at a fixed
    path inside the checkout, and its replay is on."""
    STATE_DIR.mkdir(exist_ok=True)
    reg = STATE_DIR / "shape_registry.json"
    reg.unlink(missing_ok=True)
    os.environ["HYPRE_TPU_TORCH_SHAPE_REGISTRY"] = str(reg)
    os.environ.pop("HYPRE_TPU_NO_FAST_SETUP", None)
    os.environ.pop("HYPRE_TPU_LOG_SETUP", None)


class Run:
    """What the metric readers read: the set-up and the window's times,
    the window's calls, the traced segment, and the operators' function
    bytes by span name."""

    def __init__(self, kind: str, dtype: str, device_kind: str):
        self.kind = kind
        self.dtype = dtype
        self.device_kind = device_kind
        self.setup_s = None
        self.per_call_ms = None
        self.calls: list[dict] = []
        self.trace = None
        self.trace_iterations = 0
        self.operators: dict = {}


# -- one run ----------------------------------------------------------------------

def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_of(chips: int, device=None):
    """The card the run uses; exits without a result where there is none
    or too few."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false")
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        log(f"the cell asks for {chips} cards; "
            f"{torch.cuda.device_count()} present")
        raise SystemExit(2)
    return torch.device("cuda", 0)


@dataclasses.dataclass
class Bench:
    """A cell's program, set up: what every seed's run shares."""

    cell: spec.Cell
    config: dict
    sysm: object
    job: object
    problem: object  # the reference's operator of the configuration
    judged: object = None  # the last run's check.Judged


def build(workload: str, device=None, config_patch=None,
          dtype: str | None = None, bench_dir: Path = BENCH_DIR,
          root: Path | None = None) -> Bench:
    """Find the cell, take its card, build the program and set it up.
    ``device``, ``config_patch``, ``dtype``, ``bench_dir`` and ``root``
    serve tests on the CPU and the output check's controls."""
    from harness.system import System

    cell = spec.load_cell(workload, bench_dir, root)
    dev = device_of(cell.chips, device)
    config = dict(cell.config, **(config_patch or {}))
    kind = spec.kind(cell.traffic["kind"], bench_dir)
    traffic.validate(cell.traffic, kind.KEYS)
    problem = spec.problem(config, bench_dir)
    prepare_env()
    if dev.type == "cuda":
        from hypre_tpu_torch import kernels

        kernels.build_all()
    sysm = System(config, dev, dtype)
    if sysm.n != problem.n:
        raise SystemExit(f"the ij flags give {sysm.n} rows; the "
                         f"configuration's problem has {problem.n}")
    return Bench(cell, config, sysm, kind.Job(sysm, cell.traffic, log),
                 problem)


def _peak_bytes(dev, chips: int) -> int:
    if dev.type != "cuda":
        return 0
    return max(int(torch.cuda.max_memory_allocated(d))
               for d in range(chips))


def measure(bench: Bench, seed: int, seconds: float, per_layer: bool,
            t_start: float = T_START, free: bool = True,
            warm: int | None = None) -> dict:
    """The seed's inputs, the warm-up calls (the mix's count unless
    ``warm`` is given), the window, the traced segment (``per_layer``)
    and the output check; the result object."""
    cell, sysm, job = bench.cell, bench.sysm, bench.job
    mix, dev = cell.traffic, sysm.device
    bench.judged = None  # the last run's outputs go before this run's
    job.start(seed)
    warm = int(mix["warmup_calls"]) if warm is None else warm
    for k in range(warm):
        t = time.perf_counter()
        job.call(k, k, keep=False)
        sysm.sync()
        log(f"set-up: warm-up call {k} {time.perf_counter() - t:.3f} s")

    def call(i):
        return job.call(warm + i, i, time_setup=per_layer)

    t0, out = window.run_window(call, seconds, sysm.sync)
    device_kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    run = Run(mix["kind"], sysm.dtype_name, device_kind)
    run.setup_s = t0 - t_start
    run.per_call_ms = window.per_call_ms(t0, out)
    for ms, (_, rec) in zip(window.call_ms(t0, out), out):
        info = rec["info"]
        run.calls.append({
            "ms": ms, "iterations": int(info.iterations),
            "converged": bool(info.converged),
            "setup_ms": rec.get("setup_ms"), "replayed": rec.get("replayed")})
    peak = _peak_bytes(dev, cell.chips)
    n_window = len(out)
    out.clear()
    samples, hierarchies, probe = job.outputs()
    if per_layer:
        spans = job.spans()
        traced = []

        def segment():
            for i in range(n_window, n_window + int(mix["trace_calls"])):
                traced.append(job.call(warm + i, i, keep=False, spans=True))

        path = os.path.join(tempfile.gettempdir(),
                            f"bench_trace_{os.getpid()}.json")
        try:
            run.trace = trace.profile(segment, path, sysm.sync)
        finally:
            if spans is not None:
                spans.close()
        run.operators = spans.ops if spans is not None else {}
        run.trace_iterations = sum(int(r["info"].iterations) for r in traced)
    if free:
        job.free()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    bench.judged = check.Judged(
        samples=samples, hierarchies=hierarchies, probe=probe,
        calls=[{k: c[k] for k in ("iterations", "converged")}
               for c in run.calls],
        rhs=job.rhs, problem=bench.problem, config=bench.config, seed=seed)
    correct, checks = check.judge(bench.judged, cell.limits, cell.bench_dir)
    metrics = {}
    for m in (cell.per_layer if per_layer else cell.end_to_end):
        value = spec.metric_reader(m["name"], cell.bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif not per_layer:
            raise SystemExit(f"end-to-end metric {m['name']} read nothing")
    unconverged = sum(not c["converged"] for c in run.calls)
    result = {"correct": bool(correct), "attempted": len(run.calls),
              "failed": unconverged, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": device_kind, "count": cell.chips,
                         "memory_peak_bytes": peak}}
    if per_layer:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    result = measure(build(args.workload), args.seed, args.seconds,
                     bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"the run loaded modules it must not load: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
