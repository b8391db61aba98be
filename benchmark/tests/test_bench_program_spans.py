"""The program's spans in a traced segment (``harness/program_spans.py``),
on synthetic Chrome-trace events: device operations tied to their
innermost and enclosing spans, a rejected replay told apart from an
accepted one, idle time under ``amg.cycle``; ``trace.py``'s reduction and
the accepted readers unchanged by the spans; and one traced run of
small cells on the CPU (``trace_spans.py``)."""

import pytest
import run
import small
import trace_spans
from harness import program_spans as P
from harness import readers, spec, trace

HOST, STREAM, OTHER = 1, 7, 2


def ua(name, ts, dur, tid=HOST):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def launched(events, name, corr, at, ts, dur, tid=HOST):
    """A kernel ``name`` launched at ``at`` on thread ``tid``, run on the
    device from ``ts`` for ``dur`` us."""
    events.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": at, "dur": 1,
                   "tid": tid, "args": {"correlation": corr}})
    events.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": dur, "tid": STREAM, "args": {"correlation": corr}})


def cycle_trace(with_spans=True):
    """A window of 1000 us: one PCG iteration whose cycle visits L0, L1
    and the coarse solve; the device busy 0-100, 300-400 and 600-700."""
    ev = [ua("bench.window", 0, 1000), ua("bench.solve", 0, 990),
          ua("op:L0.A", 5, 10)]
    if with_spans:
        ev += [ua("pcg.solve", 0, 990), ua("pcg.iter", 2, 900),
               ua("amg.cycle", 50, 400), ua("amg.L0", 55, 390),
               ua("amg.L1", 120, 200), ua("amg.coarse", 150, 20)]
    launched(ev, "dia_dyn_kernel", 1, 6, 0, 100)        # L0's product
    launched(ev, "banded_spmv_kernel", 2, 130, 300, 60)  # L1
    launched(ev, "gemv", 3, 155, 360, 40)                # coarse
    launched(ev, "add", 4, 520, 600, 100)                # after the cycle
    launched(ev, "copy", 5, 600, 700, 0, tid=OTHER)      # another thread
    return ev


def names(chain):
    return [s.name for s in chain]


def test_each_operation_has_its_chain_innermost_first():
    s = P.reduce(cycle_trace())
    chains = {op.name: names(op.chain) for op in s.ops}
    assert chains["dia_dyn_kernel"] == ["pcg.iter", "pcg.solve"]
    assert chains["banded_spmv_kernel"] == ["amg.L1", "amg.L0", "amg.cycle",
                                            "pcg.iter", "pcg.solve"]
    assert chains["gemv"][:3] == ["amg.coarse", "amg.L1", "amg.L0"]
    assert chains["add"] == ["pcg.iter", "pcg.solve"]
    assert chains["copy"] == []
    assert [sp.name for sp in s.spans] == [
        "pcg.solve", "pcg.iter", "amg.cycle", "amg.L0", "amg.L1",
        "amg.coarse"]
    assert s.idle == [[100, 300], [400, 600], [700, 1000]]
    assert s.window_s == pytest.approx(1e-3)


def test_coarse_levels_idle_under_the_cycle_and_the_top_spans():
    s = P.reduce(cycle_trace())
    # L1's 60 us and the coarse solve's 40 us, over one iteration
    assert P.coarse_levels_ms(s) == pytest.approx(0.1)
    # idle 100-300 lies in the cycle (50-450), 400-600 up to 450
    assert P.cycle_idle_share(s) == pytest.approx(100 * 250 / 1000)
    assert P.top_spans(s) == [["pcg.iter", pytest.approx(2e-4)],
                              ["amg.L1", pytest.approx(6e-5)],
                              ["amg.coarse", pytest.approx(4e-5)]]
    assert P.rejected_replay_ms(s) is None and P.galerkin_ms(s) is None


def test_a_rejected_replay_is_told_from_an_accepted_one():
    ev = [ua("bench.window", 0, 2000),
          # step 1: the attempt is rejected, the slow path runs after it
          ua("amg.setup", 0, 900), ua("setup.replay", 10, 400),
          ua("setup.L0.ap", 20, 100), ua("setup.L0.split", 150, 100),
          ua("setup.slow", 420, 470), ua("setup.L0.rap", 430, 100),
          # step 2: the attempt is accepted
          ua("amg.setup", 1000, 900), ua("setup.replay", 1010, 800),
          ua("setup.L0.transpose", 1020, 100)]
    launched(ev, "ap", 1, 30, 30, 50)
    launched(ev, "split", 2, 160, 160, 30)
    launched(ev, "rap", 3, 440, 440, 70)
    launched(ev, "t", 4, 1030, 1030, 20)
    launched(ev, "other", 5, 1500, 1500, 10)
    s = P.reduce(ev)
    # the rejected attempt's 50 + 30 us, over two steps
    assert P.rejected_replay_ms(s) == pytest.approx(0.08 / 2)
    # ap, rap and transpose on either path: 50 + 70 + 20 us
    assert P.galerkin_ms(s) == pytest.approx(0.14 / 2)
    assert P.coarse_levels_ms(s) is None
    assert P.cycle_idle_share(s) is None
    ok = [e for e in ev if e.get("name") != "setup.slow"]
    assert P.rejected_replay_ms(P.reduce(ok)) == 0.0


def test_a_program_without_spans_reads_nothing():
    s = P.reduce(cycle_trace(with_spans=False))
    assert s.spans == [] and all(op.chain == () for op in s.ops)
    assert all(fn(s) is None for fn in P.READINGS.values())
    assert P.top_spans(s) == []


class FakeRun:
    def __init__(self, t):
        self.trace, self.trace_iterations = t, 1
        self.dtype, self.device_kind = "float32", "NVIDIA H100 80GB HBM3"
        self.operators = {"L0.A": {"kind": "dia", "bytes": 3.35e12 * 5e-5,
                                   "flops": 1.0}}


def test_the_spans_change_no_value_trace_reduce_gives():
    plain = trace.reduce(cycle_trace(with_spans=False))
    spanned = trace.reduce(cycle_trace())
    for field in ("window_s", "busy_s", "kernels", "device_ops"):
        assert getattr(spanned, field) == getattr(plain, field), field
    assert [g[1] for g in spanned.idle_gaps] == \
        [g[1] for g in plain.idle_gaps]
    for fn in (readers.idle_share, readers.launches_per_iter,
               lambda r: readers.roofline_share(r, "dia", "dia_")):
        assert fn(FakeRun(spanned)) == fn(FakeRun(plain))
    assert readers.roofline_share(FakeRun(plain), "dia", "dia_") == \
        pytest.approx(50.0)
    # the idle gaps are named by the span the host was in
    assert [g[0] for g in plain.idle_gaps] == ["solve/idle"] * 3
    assert [g[0] for g in spanned.idle_gaps] == [
        "solve/pcg.iter", "solve/pcg.iter", "solve/amg.L1"]


@pytest.mark.parametrize("workload", ["ij7_solve", "ij7_resetup"])
def test_a_traced_run_of_a_small_cell_reads_its_spans(workload):
    cell = spec.load_cell(workload)
    bench = run.build(workload, device="cpu",
                      config_patch=small.patch(cell.config))
    res = trace_spans.measure(bench, 2 ** 40 + 7, 0.2, t_start=0.0)
    assert res["correct"], res["checks"]
    got = res["program_spans"]
    # the cell's own readings alone; the CPU runs no device operation:
    # nothing launched, all idle
    if cell.traffic["kind"] == "resetup":
        assert got == {"rejected_replay_ms.resetup": 0.0,
                       "galerkin_ms.resetup": 0.0}
    else:
        assert got["coarse_levels_ms.solve"] == 0.0
        assert 0.0 < got["cycle_idle_share.solve"] <= 100.0
        assert set(got) == {"coarse_levels_ms.solve",
                            "cycle_idle_share.solve"}
    assert res["breakdown"]["spans"] == []
