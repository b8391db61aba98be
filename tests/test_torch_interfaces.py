"""hypre_tpu_torch's interface modules against hypre_tpu's: the row
partition (``core/partition.py``), the timers (``core/timing.py``), the
row-access facade (``matrix_facade.py``) and the SpGEMM driver
(``drivers/ij_mm.py``, checked against the host C++ Gustavson product)."""

import contextlib
import io

import numpy as np
import pytest
import torch

from hypre_tpu.core.partition import RowPartition as JRowPartition
from hypre_tpu.matrix_facade import convert_to_distributed as j_convert
from hypre_tpu.problems.laplacian import laplacian_2d_5pt as j_lap5
from hypre_tpu.seq.csr import HostCSR as JHostCSR

import hypre_tpu_torch as H
from hypre_tpu_torch.core.partition import RowPartition
from hypre_tpu_torch.core.timing import (
    GLOBAL_TIMERS, TimerRegistry, annotate, device_memory_report,
)
from hypre_tpu_torch.drivers import ij_mm
from hypre_tpu_torch.matrix_facade import (
    DistributedMatrix, convert_to_distributed,
)
from hypre_tpu_torch.seq.csr import HostCSR
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n,shards", [(100, 8), (97, 8), (64, 8), (5, 4)])
def test_row_partition_pads_and_owns_like_the_reference(n, shards):
    mine, theirs = RowPartition(n, shards), JRowPartition(n, shards)
    assert (mine.n_padded, mine.n_local) == (theirs.n_padded, theirs.n_local)
    rows = np.arange(mine.n_padded)
    np.testing.assert_array_equal(mine.owner_of(rows), theirs.owner_of(rows))
    np.testing.assert_array_equal(mine.local_index(rows),
                                  theirs.local_index(rows))
    assert mine.owner_of(torch.from_numpy(rows)).tolist() == \
        theirs.owner_of(rows).tolist()
    assert [mine.row_range(p) for p in range(shards)] == \
        [theirs.row_range(p) for p in range(shards)]


def test_timer_registry_on_the_cpu():
    timers = TimerRegistry()
    x = torch.ones(1000, dtype=torch.float64)
    for _ in range(3):
        with timers.time("setup", sync=x):
            x = x * 2.0
    with timers.time("solve", sync=True), annotate("solve"):
        y = x.sum()
    assert float(y) == 8000.0
    assert timers.elapsed("setup") > 0.0
    report = timers.report()
    assert "(3 calls)" in report and "(1 calls)" in report
    timers.clear()
    assert timers.elapsed("setup") == 0.0
    assert isinstance(GLOBAL_TIMERS, TimerRegistry)
    with torch.profiler.profile() as prof, annotate("level-0"):
        torch.ones(4).sum()
    assert any(e.key == "level-0" for e in prof.key_averages())
    if not torch.cuda.is_available():
        assert "no CUDA device" in device_memory_report()


def test_distributed_matrix_rows_equal_the_references():
    jA = j_lap5(7, 5)
    A = H.laplacian_2d_5pt(7, 5, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(2)
    r, c = rng.integers(0, 20, 60), rng.integers(0, 15, 60)
    v = rng.standard_normal(60)
    for mine, theirs in ((convert_to_distributed(A), j_convert(jA)),
                         (convert_to_distributed(HostCSR.from_coo(
                             r, c, v, (20, 15))),
                          j_convert(JHostCSR.from_coo(r, c, v, (20, 15))))):
        assert isinstance(mine, DistributedMatrix)
        assert mine.shape == theirs.shape
        for (i, cols, vals), (j, jcols, jvals) in zip(mine.rows(),
                                                      theirs.rows()):
            assert i == j
            np.testing.assert_array_equal(cols, jcols)
            np.testing.assert_array_equal(vals, jvals)
    assert convert_to_distributed(mine) is mine
    with pytest.raises(TypeError):
        convert_to_distributed(object())


def run_quiet(argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dt = ij_mm.run(argv.split(), device="cpu", **kw)
    return dt, out.getvalue()


def test_ij_mm_verifies_against_the_native_oracle():
    dt, out = run_quiet("-n 12 12 12 -7pt -job 1 -rep 2 -verify 1",
                        dtype=torch.float64)
    assert "verify: passed" in out and dt > 0
    assert "Device Parcsr Matrix-by-Matrix wall clock time" in out


@pytest.mark.parametrize("job", [1, 2, 4, 5])
def test_ij_mm_jobs(job):
    dt, out = run_quiet(f"-n 24 24 1 -5pt -job {job} -rep 2 -verify 1",
                        dtype=torch.float64)
    assert "verify: passed" in out and dt > 0
    with pytest.raises(ValueError, match="-job"):
        ij_mm.parse(["-job", "3"])
