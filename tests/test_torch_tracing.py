"""The port's spans (``core/timing.py::annotate``) under ``torch.profiler``
on the CPU: none without a profiler, the facade's setup, the device setup's
slow path and replay, PCG's iterations around the cycle's levels, and the
profiling tools' device sums, which leave the spans out."""

import contextlib
import types

import pytest
import torch

import hypre_tpu_torch as H
from hypre_tpu_torch import warmup
from hypre_tpu_torch.amg.boomeramg import BoomerAMG
from hypre_tpu_torch.core.timing import annotate
from hypre_tpu_torch.krylov import pcg
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_spans import span_paths

STAGES = ("split", "vectors", "interp", "ap", "transpose", "rap")


@pytest.fixture(autouse=True)
def registry(tmp_path, monkeypatch):
    """An empty shape registry of each test's own; the replay on."""
    monkeypatch.setenv(warmup.REGISTRY_ENV, str(tmp_path / "shapes.json"))
    monkeypatch.delenv("HYPRE_TPU_NO_FAST_SETUP", raising=False)
    monkeypatch.setattr(warmup, "_LOCAL", {})


def operator():
    return H.laplacian_2d_5pt(10, 9, dtype=torch.float64, device="cpu")


def amg():
    return BoomerAMG(setup_backend="device", max_coarse_size=20,
                     relax="l1-jacobi")


def setup_paths(A):
    return span_paths(lambda: amg().setup(A, device="cpu"))


def test_annotate_is_one_shared_no_op_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    off = annotate("amg.cycle")
    assert off is annotate("pcg.iter")
    assert isinstance(off, contextlib.nullcontext)
    with torch.profiler.profile() as prof:
        on = annotate("amg.cycle")
        assert on is not off
        with on:
            torch.ones(3).sum()
    assert any(e.key == "amg.cycle" for e in prof.key_averages())


def test_the_slow_setup_shows_its_stages_per_level():
    solver, paths = span_paths(lambda: amg().setup(
        operator(), device="cpu", optimize=True))
    assert not solver.hierarchy.replayed
    assert [p for p in paths if len(p) <= 2] == [
        ("amg.setup",), ("amg.setup", "setup.slow"),
        ("amg.setup", "amg.formats")]
    n_levels = len(solver.hierarchy.levels)
    assert n_levels >= 2
    for lev in range(n_levels):
        for stage in STAGES:
            assert ("amg.setup", "setup.slow",
                    f"setup.L{lev}.{stage}") in paths
    assert ("amg.setup", "setup.slow", "setup.coarse_inv") in paths


@pytest.mark.parametrize("rejected", [False, True])
def test_a_replay_is_one_span_and_a_rejected_one_is_followed_by_the_slow(
        rejected):
    A = operator()
    setup_paths(A)  # records the ladder
    if rejected:
        # a coarse size the recorded ladder does not hold: the attempt runs
        # to its deferred check at the coarse stage, then the slow path
        key, = [k for k in warmup.read_registry() if k.startswith("ladder|")]
        rec = warmup.read_registry()[key]
        lv0 = dict(rec["levels"][0], nc=rec["levels"][0]["nc"] + 1)
        warmup.update_registry({key: dict(rec, levels=[lv0]
                                          + rec["levels"][1:])})
    solver, paths = setup_paths(A)
    assert solver.hierarchy.replayed is not rejected
    top = [p[1] for p in paths if len(p) == 2]
    assert top == (["setup.replay", "setup.slow"] if rejected
                   else ["setup.replay"])
    assert ("amg.setup", "setup.replay", "setup.L0.rap") in paths
    assert ("amg.setup", "setup.replay", "setup.coarse_inv") in paths


def test_two_pcg_iterations_nest_the_cycle_levels():
    A = operator()
    solver = amg().setup(A, device="cpu")
    assert len(solver.hierarchy.levels) >= 2
    b = torch.ones(A.n_rows, dtype=A.dtype)
    (_, info), paths = span_paths(lambda: pcg(
        A.mv, b, M=solver.precond(), rtol=1e-14, maxiter=2, device="cpu"))
    assert int(info.iterations) == 2
    assert [p for p in paths if p[-1] == "pcg.iter"] == \
        [("pcg.solve", "pcg.iter")] * 2
    inner = ("pcg.solve", "pcg.iter", "amg.cycle", "amg.L0", "amg.L1")
    assert paths.count(inner) == 2
    last = tuple(f"amg.L{l}" for l in range(len(solver.hierarchy.levels)))
    assert paths.count(("pcg.solve", "pcg.iter", "amg.cycle") + last
                       + ("amg.coarse",)) == 2
    # the first cycle, on the initial residual, lies outside the loop
    assert ("pcg.solve", "amg.cycle") in paths


def test_the_profiling_tools_leave_the_spans_out_of_device_time():
    """Under CUDA activity every span is also a device-side entry
    (``gpu_user_annotation``) as long as the kernels inside it. The
    tools' device sums (``chip_smoke.cuda_events``,
    ``profile_torch_solve.kernel_times``) must leave them out: here a CPU
    profile's events stand in for the card's, each read as a device one."""
    import chip_smoke
    import profile_torch_solve

    A = operator()
    solver = amg().setup(A, device="cpu")
    b = torch.ones(A.n_rows, dtype=A.dtype)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pcg(A.mv, b, M=solver.precond(), rtol=1e-14, maxiter=2,
            device="cpu")
    cuda = torch.autograd.DeviceType.CUDA

    class OnCard:
        def __init__(self, e):
            self.e = e

        def __getattr__(self, name):
            return getattr(self.e, name)

    class RawOnCard(OnCard):
        def device_type(self):
            return cuda

    class AverageOnCard(OnCard):
        device_type = cuda

        @property
        def self_device_time_total(self):
            return self.e.self_cpu_time_total

    spans = {"pcg.solve", "pcg.iter", "amg.cycle", "amg.L0", "amg.L1",
             "amg.coarse"}
    raw = list(prof.profiler.kineto_results.events())
    assert spans <= {e.name() for e in raw}
    fake = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(
            events=lambda: [RawOnCard(e) for e in raw])))
    kept = {e.name() for e in chip_smoke.cuda_events(torch, fake)}
    assert not kept & spans and "aten::add" in kept

    averages = [AverageOnCard(e) for e in prof.key_averages()]
    times = profile_torch_solve.kernel_times(torch, averages)
    names = {name for name, _, _ in times}
    assert not names & spans and "aten::add" in names
    assert sum(ms for _, ms, _ in times) == pytest.approx(sum(
        e.self_cpu_time_total for e in prof.key_averages()
        if e.key not in spans) / 1e3)
