"""The output check's readings, on the chip at a cell's own size:

    python3 benchmark/control.py --workload <cell> --seconds <s> \\
        --seeds <n> ... --control-seeds <n> ... \\
        [--faults <fault> ... --fault-seeds <n> ...]

- the program's readings: one set-up, then for each of ``--seeds`` a run
  of the cell's traffic (its warm-up calls, a window of ``--seconds``)
  and the numbers the check compares;
- the fault readings: the same runs with each fault of ``faults.py``
  planted in the timed path, on each of ``--fault-seeds``;
- the control's readings, for each of ``--control-seeds``: the
  configuration computed in the precision below its own. A float64
  configuration runs the program's own float32 path through the same
  run; a float32 one puts the plain reference in the program's place in
  bfloat16: a Jacobi-preconditioned CG on the right-hand sides (and
  shifts) of the seed's window, its V-cycle (``reference/cycle.py``) on
  the probe, and the hierarchies the program built held in bfloat16; the
  same check judges it.

Prints one JSON line per reading. The benchmark's runs do not run this."""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import faults
import run
import torch
from harness import check
from reference.cycle import VCycle, sweeps_of
from reference.solve import pcg_jacobi

CONTROL_MAXITER = 400


def program_readings(bench, seeds, seconds, what="program"):
    for i, seed in enumerate(seeds):
        # the first seed's warm-up calls warm every shape for the rest
        res = run.measure(bench, seed, seconds, per_layer=False, free=False,
                          warm=None if i == 0 else 0)
        h = bench.judged.probe.hierarchy
        yield {"what": what, "seed": seed, "correct": res["correct"],
               "checks": res["checks"], "metrics": res["metrics"],
               "rows": [A[2] for A, _ in h.levels] + [h.coarse_inv.shape[0]]}


def fault_readings(bench, names, seeds, seconds):
    for name in names:
        with faults.planted(bench, name):
            for line in program_readings(bench, seeds, seconds,
                                         what=f"fault:{name}"):
                yield line


def _bf16_levels(levels):
    def r(part):
        vals, cols, n = part
        return vals.to(torch.bfloat16).to(vals.dtype), cols, n

    return [(r(A), r(P)) for A, P in levels]


def reference_control(bench, seed) -> dict:
    """The plain reference in bfloat16 in the program's place, on the
    inputs of a short run of the seed's traffic."""
    run.measure(bench, seed, 0.1, per_layer=False, free=False, warm=0)
    j = bench.judged
    samples, calls = [], []
    for s in j.samples:
        x, it, ok = pcg_jacobi(j.rhs[s.rhs_row], j.problem, s.sigma,
                               dtype=torch.bfloat16,
                               rtol=bench.sysm.pcg_kw["rtol"],
                               maxiter=CONTROL_MAXITER)
        samples.append(dataclasses.replace(s, x=x))
        calls.append({"iterations": it, "converged": ok})
    hiers = [dataclasses.replace(h, levels=_bf16_levels(h.levels))
             for h in j.hierarchies]
    p = j.probe
    ph = dataclasses.replace(p.hierarchy,
                             levels=_bf16_levels(p.hierarchy.levels))
    z = VCycle(ph.levels, sweeps_of(bench.config["ij_flags"]),
               torch.bfloat16)(p.f)
    control = dataclasses.replace(
        j, samples=samples, calls=calls, hierarchies=hiers,
        probe=check.Probe(ph, p.f, z.to(p.f.dtype)))
    ok, checks = check.judge(control, bench.cell.limits,
                             bench.cell.bench_dir)
    return {"what": "control", "precision": "bfloat16", "seed": seed,
            "correct": ok, "checks": checks}


def control_readings(workload, seeds, seconds, device=None,
                     config_patch=None):
    cell_dtype = run.spec.load_cell(workload).config["dtype"]
    if cell_dtype == "float64":
        bench = run.build(workload, device, config_patch, dtype="float32")
        for line in program_readings(bench, seeds, seconds, "control"):
            line["precision"] = "float32"
            yield line
    else:
        bench = run.build(workload, device, config_patch)
        for seed in seeds:
            yield reference_control(bench, seed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[],
                   choices=sorted(faults.FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    if args.seeds or args.faults:
        bench = run.build(args.workload)
        for line in program_readings(bench, args.seeds, args.seconds):
            print(json.dumps(line), flush=True)
        for line in fault_readings(bench, args.faults, args.fault_seeds,
                                   args.seconds):
            print(json.dumps(line), flush=True)
        bench.job.free()
        del bench
        torch.cuda.empty_cache()
    for line in control_readings(args.workload, args.control_seeds,
                                 args.seconds):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
