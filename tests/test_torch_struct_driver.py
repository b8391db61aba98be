"""hypre_tpu_torch's struct driver on the CPU in float64, against recorded
goldens (no reference solver runs here).

- Every case of ``tests/test_drivers.py``'s STRUCT_GOLDEN (imported, so
  that the list stays single) gives the golden's iterations exactly and a
  final residual within 1.2x of it, as ``test/runtest.sh`` compares.
- ``tests/test_hypre_parity.py``'s struct checks: CG at 10^3 prints hypre's
  20 iterations and 5.962015e-07 to the printed digits; SMG-PCG <= 5 and
  PFMG-PCG <= 9 at 10^3; smgbase3d ``-c 2.0 3.0 40`` <= 5; and the 3-D SMG
  golden ``-solver 10 -n 12 12 12 -tol 1e-8`` of ``tests/test_drivers.py``:
  5 iterations.
- The solver ids the goldens do not cover (8, 20, 22, 30, 31) converge;
  at their 2-D flags (all but 20, the 3-D SMG) the reference driver runs
  too, and the port gives its iterations exactly and its final residual
  within 1.2x either way. StructHybrid's split into DS-PCG and MG-PCG
  iterations (ids 21 and 22) equals the reference's.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from test_drivers import STRUCT_GOLDEN

from hypre_tpu.drivers import struct as j_struct
from hypre_tpu.problems.struct_problems import struct_laplacian as j_laplacian
from hypre_tpu.struct import StructHybrid as JStructHybrid

from hypre_tpu_torch.drivers import struct as t_struct
from torch_one_thread import one_torch_thread  # noqa: F401


def run_port(flags):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        iters, rel = t_struct.run(flags.split(), device="cpu",
                                  dtype=torch.float64)
    out = buf.getvalue()
    assert f"Iterations = {iters}\n" in out
    assert f"Final Relative Residual Norm = {rel:e}\n" in out
    return iters, rel


@pytest.mark.parametrize("flags,iters,rel", STRUCT_GOLDEN,
                         ids=[c[0] for c in STRUCT_GOLDEN])
def test_struct_driver_golden(flags, iters, rel):
    got_it, got_rel = run_port(flags)
    assert got_it == iters, f"iterations {got_it} != golden {iters}"
    assert got_rel <= rel * 1.2 + 1e-16


def test_struct_cg_matches_hypre_golden_to_printed_digits():
    """TEST_struct solvers.saved:23: 20 iterations, 5.962015e-07."""
    it, rel = run_port("-solver 18 -n 10 10 10 -tol 1e-6")
    assert it == 20
    assert f"{rel:.6e}" == "5.962015e-07"


def test_struct_mg_pcg_in_hypre_iteration_class():
    """solvers.saved:2,6: hypre's SMG-PCG 4 and PFMG-PCG 8."""
    it_smg, _ = run_port("-solver 10 -n 10 10 10 -tol 1e-6")
    it_pfmg, _ = run_port("-solver 11 -n 10 10 10 -tol 1e-6")
    assert it_smg <= 5
    assert it_pfmg <= 9


def test_smg_anisotropic_golden_smgbase3d():
    """TEST_struct/smgbase3d: hypre 4 iterations, rres 8.97e-07."""
    it, rres = run_port("-solver 0 -n 12 12 12 -c 2.0 3.0 40 -tol 1e-6")
    assert it <= 5
    assert rres < 1e-6


def test_struct_driver_smg_3d_plane_solve_golden():
    """3-D SMG-PCG with the recursive plane solves: the golden of
    tests/test_drivers.py's slow test, 5 iterations, 2.396e-09."""
    it, rel = run_port("-solver 10 -n 12 12 12 -tol 1e-8")
    assert it == 5
    assert rel <= 2.396e-09 * 1.2 + 1e-16


@pytest.mark.parametrize("flags", [
    "-solver 8 -n 8 8 1 -tol 1e-5", "-solver 20 -n 12 12 12 -tol 1e-8",
    "-solver 22 -n 16 16 1 -tol 1e-8", "-solver 30 -n 16 16 1 -tol 1e-8",
    "-solver 31 -n 16 16 1 -tol 1e-8 -relax 2 -v 2 2",
    "-solver 1 -n 16 16 1 -rhsrand"])
def test_other_solver_ids_converge(flags):
    it, rel = run_port(flags)
    tol = float(flags.split("-tol ")[1].split()[0]) if "-tol" in flags \
        else 1e-6
    assert 0 < it < 200
    assert rel <= tol


OTHER_2D = ["-solver 8 -n 8 8 1 -tol 1e-5",
            "-solver 22 -n 16 16 1 -tol 1e-8",
            "-solver 30 -n 16 16 1 -tol 1e-8",
            "-solver 31 -n 16 16 1 -tol 1e-8 -relax 2 -v 2 2",
            "-solver 1 -n 16 16 1 -rhsrand"]


@pytest.mark.parametrize("flags", OTHER_2D)
def test_other_solver_ids_match_reference_driver(flags):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        want_it, want_rel = j_struct.run(flags.split())
    it, rel = run_port(flags)
    assert it == want_it, f"iterations {it} != reference {want_it}"
    assert rel <= want_rel * 1.2 + 1e-16
    assert want_rel <= rel * 1.2 + 1e-16


@pytest.mark.parametrize("solver", [21, 22])
def test_struct_hybrid_split_matches_reference(solver):
    """DS-PCG's iterations, then MG-PCG's after the switch, as the
    reference's StructHybrid counts them (both ids take its PFMG branch)."""
    flags = f"-solver {solver} -n 16 16 1 -tol 1e-8"
    case = t_struct.prepare(flags.split(), device="cpu",
                            dtype=torch.float64)
    case.solve()
    JA = j_laplacian((16, 16))
    hy = JStructHybrid(precond_type="pfmg", precond_knobs=dict(
        num_pre_relax=1, num_post_relax=1)).setup(JA)
    hy.solve(np.ones((16, 16)), rtol=1e-8)
    assert (case.mg.dscg_iterations, case.mg.mg_iterations) == (
        hy.dscg_iterations, hy.mg_iterations)


def test_unknown_flag_and_id_exit():
    with pytest.raises(SystemExit):
        t_struct.parse_args(["-bogus"])
    with pytest.raises(SystemExit):
        run_port("-solver 99 -n 8 8 1")
