"""The rest of a run, on the CPU at a small grid, with the look for a
card skipped: a sound run is correct, and a run with the timed path
broken underneath is not, for each fault these cells can have (a solve or
a setup that returns its state unchanged, an answer altered where it is
produced, and the cycle's faults of ``faults.py``: a smoothing sweep
skipped, the coarsest correction left out, the cycle in bfloat16). The
other faults of the contract do not apply: a solve has no batch to halve
and these cells use one card."""

import dataclasses

import faults
import pytest
import run
import small
import torch
from harness import spec

SEED = 2 ** 40 + 11


def build(workload):
    cell = spec.load_cell(workload)
    return run.build(workload, device="cpu",
                     config_patch=small.patch(cell.config))


def measure(workload, seconds=0.3, per_layer=False):
    return run.measure(build(workload), SEED, seconds, per_layer,
                       t_start=0.0)


@pytest.mark.parametrize("workload", ["ij7_solve", "ij27_solve",
                                      "ij7_resetup"])
def test_a_sound_run_is_correct(workload):
    res = measure(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", ["ij7_solve", "ij7_resetup"])
def test_a_solve_that_returns_its_state_unchanged_is_caught(workload,
                                                            monkeypatch):
    from harness import system

    def stale(self, op, amg, b):
        return torch.zeros_like(b), orig(self, op, amg, b)[1]

    orig = system.System.solve
    monkeypatch.setattr(system.System, "solve", stale)
    res = measure(workload)
    assert not res["correct"]
    assert res["checks"]["residual"]["value"] > \
        res["checks"]["residual"]["limit"]


def test_an_answer_altered_where_it_is_produced_is_caught(monkeypatch):
    from harness import system

    def altered(self, op, amg, b):
        x, info = orig(self, op, amg, b)
        x = x.clone()
        x[x.shape[0] // 2] += 1.0
        return x, info

    orig = system.System.solve
    monkeypatch.setattr(system.System, "solve", altered)
    res = measure("ij7_solve")
    assert not res["correct"]


def test_a_setup_that_returns_its_state_unchanged_is_caught(monkeypatch):
    from harness import system

    first = {}

    def stale_setup(self, A):
        if "amg" not in first:
            first["amg"] = orig(self, A)
        return first["amg"]

    orig = system.System.setup
    monkeypatch.setattr(system.System, "setup", stale_setup)
    # the warm-up took the window's first shift: later calls show the fault
    res = measure("ij7_resetup", seconds=4.0)
    assert not res["correct"]
    assert res["checks"]["op0_gap"]["value"] > \
        res["checks"]["op0_gap"]["limit"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", ["ij7_solve", "ij27_solve",
                                      "ij7_resetup"])
def test_a_cycle_fault_is_caught(workload, fault):
    bench = build(workload)
    sound = run.measure(bench, SEED, 0.3, False, t_start=0.0, free=False)
    with faults.planted(bench, fault):
        res = run.measure(bench, SEED, 0.3, False, t_start=0.0, warm=0)
    assert sound["correct"] and not res["correct"]
    gap = res["checks"]["cycle_gap"]
    assert gap["value"] > gap["limit"]
    if fault != "cycle_bf16":
        # the cycle does less, and the solves take more iterations
        assert res["checks"]["iterations"]["value"] > \
            sound["checks"]["iterations"]["value"]


def test_the_traced_run_reports_per_layer_metrics_on_the_cpu():
    res = measure("ij7_solve", per_layer=True)
    assert res["correct"]
    names = set(res["metrics"])
    # counters and host clocks read on any device; the kernels' rooflines
    # find no CUDA kernel to read on the CPU and are left out
    assert {"iterations.solve", "solve_p95_ms.solve"} <= names
    assert "dia_roofline.solve" not in names
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_every_reader_of_the_benchmark_loads():
    import json

    doc = json.loads((spec.BENCH_DIR.parent / "BENCHMARK.json").read_text())
    for m in doc["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    assert dataclasses.is_dataclass(run.Bench)
