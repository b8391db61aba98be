"""hypre_tpu_torch's ij driver against hypre_tpu's, in float64 on the CPU.

- Every case of ``tests/test_drivers.py``'s IJ_GOLDEN (imported, so that
  the list stays single) gives the golden's iterations exactly and a
  final residual within 1.2x of it, as ``test/runtest.sh`` compares. The
  goldens of the AMG ids came from the reference's C++ setup, which the
  port's AMG ids take too (BoomerAMG's default), ``-agg_nl`` included.
- Ids and flags the goldens do not cover (the FSAI and Schwarz level
  smoothers, ParaSails, MGR, CGNR, LGMRES, FlexGMRES, -rhsrand,
  -fromfile) take the reference driver's iterations, and the -poutdat
  setup report is the reference's, line for line.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from hypre_tpu.drivers import ij as j_ij
from test_drivers import IJ_GOLDEN

from hypre_tpu_torch.drivers import ij as t_ij
from hypre_tpu_torch.io import write_matrix_market
from hypre_tpu_torch.problems.laplacian import laplacian_2d_5pt
from torch_one_thread import one_torch_thread  # noqa: F401


def run_port(flags):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        iters, rel = t_ij.run(flags.split() if isinstance(flags, str)
                              else flags, device="cpu",
                              dtype=torch.float64)
    out = buf.getvalue()
    assert f"Iterations = {iters}\n" in out
    assert f"Final Relative Residual Norm = {rel:e}\n" in out
    return iters, rel, out


def run_reference(flags):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        iters, rel = j_ij.run(flags.split())
    return iters, rel, buf.getvalue()


@pytest.mark.parametrize("flags,iters,rel", IJ_GOLDEN,
                         ids=[c[0] for c in IJ_GOLDEN])
def test_ij_driver_golden(flags, iters, rel):
    got_it, got_rel, _ = run_port(flags)
    assert got_it == iters, f"iterations {got_it} != golden {iters}"
    assert got_rel <= rel * 1.2 + 1e-16


REFERENCE_CASES = [
    "-solver 1 -n 48 48 1 -rlx 18 -smtype 4 -smlv 2",
    "-solver 1 -n 48 48 1 -rlx 18 -smtype 6 -smlv 1 -sw 0.7",
    "-solver 12 -n 24 24 1",
    "-solver 18 -n 24 24 1",
    "-solver 70 -n 24 24 1",
    "-solver 5 -n 48 48 1",
    "-solver 6 -n 16 16 1",
    "-solver 50 -n 48 48 1",
    "-solver 60 -n 48 48 1",
    "-solver 4 -n 24 24 1",
    "-solver 10 -n 24 24 1",
    "-solver 2 -n 16 16 1 -rhsrand",
]


@pytest.mark.parametrize("flags", REFERENCE_CASES)
def test_ij_driver_takes_the_reference_iterations(flags):
    j_it, j_rel, _ = run_reference(flags)
    t_it, t_rel, _ = run_port(flags)
    assert t_it == j_it
    assert t_rel <= j_rel * 1.2 + 1e-16


def test_poutdat_prints_the_reference_report():
    """-poutdat 2: the setup report line for line, the residual table to
    the printed digits' rounding."""
    flags = "-solver 1 -n 48 48 1 -poutdat 2"
    _, _, want = run_reference(flags)
    _, _, got = run_port(flags)
    want, got = want.splitlines(), got.splitlines()
    assert len(got) == len(want)
    head = want.index("Iters       ||r||_2     conv.rate  ||r||_2/||b||_2")
    assert got[:head + 2] == want[:head + 2]
    for g, w in zip(got[head + 2:], want[head + 2:]):
        gv, wv = g.split(), w.split()
        assert len(gv) == len(wv)
        for a, b in zip(gv, wv):
            if a != b:
                assert np.isclose(float(a), float(b), rtol=1e-5), (g, w)


def test_fromfile_takes_the_reference_iterations(tmp_path):
    """The generator's matrix through a MatrixMarket file: the
    generator's iterations (the file's slot order sums in another order)
    and the reference driver's on the same file."""
    path = str(tmp_path / "lap.mtx")
    write_matrix_market(path, laplacian_2d_5pt(20, 20, dtype=torch.float64,
                                               device="cpu"))
    flags = f"-solver 2 -fromfile {path}"
    t_it, t_rel, _ = run_port(flags)
    j_it, j_rel, _ = run_reference(flags)
    assert t_it == j_it == run_port("-solver 2 -n 20 20 1")[0]
    assert t_rel <= j_rel * 1.2 + 1e-16


def test_help_and_unsupported_ids():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        t_ij.run(["-help"], device="cpu")
    assert e.value.code == 0 and "80 = ILU-GMRES" in buf.getvalue()
    with pytest.raises(SystemExit, match="unsupported solver id 99"):
        run_port("-solver 99 -n 8 8 1")
    with pytest.raises(SystemExit, match="unknown flag -bogus"):
        run_port("-bogus")
