"""hypre_tpu_torch's AMG-DD (``parallel/amgdd.py``) and the ij driver's
ids 90/91 against hypre_tpu's, in float64 on the CPU.

Both packages set up the inner BoomerAMG through its default path (the
host C++ setup, bit for bit the same), so the composite grids must have
the same sizes on every level; one cycle, the standalone solve and AMG-DD
under GMRES must then match the reference's (tests/test_parallel.py:
121-160).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypre_tpu.drivers import ij as j_ij
from hypre_tpu.krylov import gmres as j_gmres
from hypre_tpu.parallel.amgdd import AMGDD as JAMGDD
from hypre_tpu.problems.laplacian import (
    laplacian_2d_5pt as j_lap5, laplacian_3d_7pt as j_lap7,
)
from hypre_tpu.seq.ell import ell_spmv as j_spmv

import hypre_tpu_torch as H
from hypre_tpu_torch.convert import ell_from_numpy
from hypre_tpu_torch.drivers import ij as t_ij
from hypre_tpu_torch.parallel.amgdd import AMGDD
from torch_one_thread import one_torch_thread  # noqa: F401


def port_of(jA):
    return ell_from_numpy(np.asarray(jA.vals), np.asarray(jA.cols), jA.n_cols,
                          device="cpu")


@pytest.fixture(scope="module")
def pair():
    """The reference's and the port's AMG-DD on the 24^2 Laplacian, four
    devices, padding 2 (the driver's setup)."""
    jA = j_lap5(24, 24)
    jd = JAMGDD(padding=2).setup(jA, num_devices=4)
    td = AMGDD(padding=2).setup(port_of(jA), num_devices=4, device="cpu")
    return jA, jd, td


SIZE_CASES = {"24^2, 4 devices": (lambda: j_lap5(24, 24), 4, 2),
              "12^3, 4 devices": (lambda: j_lap7(12, 12, 12), 4, 2),
              "30^2, 3 devices, padding 1": (lambda: j_lap5(30, 30), 3, 1)}


@pytest.mark.parametrize("key", sorted(SIZE_CASES))
def test_composite_sizes_equal_the_reference(key):
    make, devices, padding = SIZE_CASES[key]
    jA = make()
    jd = JAMGDD(padding=padding).setup(jA, num_devices=devices)
    td = AMGDD(padding=padding).setup(port_of(jA), num_devices=devices,
                                      device="cpu")
    assert td.composite_sizes == [int(lv["av"].shape[1])
                                  for lv in jd._levels]


def test_one_cycle_equals_the_reference(pair):
    jA, jd, td = pair
    rng = np.random.default_rng(0)
    b, u = rng.standard_normal(jA.n_rows), rng.standard_normal(jA.n_rows)
    want = np.asarray(jd.cycle(jnp.asarray(b), jnp.asarray(u)))
    got = td.cycle(torch.from_numpy(b), torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def test_solve_and_gmres_take_the_reference_iterations(pair):
    jA, jd, td = pair
    xj, ij = jd.solve(jnp.ones(jA.n_rows), rtol=1e-8, maxiter=150)
    b = torch.ones(jA.n_rows, dtype=torch.float64)
    xt, it = td.solve(b, rtol=1e-8, maxiter=150)
    assert bool(it.converged) and int(it.iterations) == int(ij.iterations)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10,
                               atol=1e-10)
    _, gj = j_gmres(lambda v: j_spmv(jA, v), jnp.ones(jA.n_rows),
                    M=jd.precond(), rtol=1e-8)
    tA = port_of(jA)
    _, gt = H.gmres(tA.mv, b, M=td.precond(), rtol=1e-8, device="cpu")
    assert bool(gt.converged) and int(gt.iterations) == int(gj.iterations)


@pytest.mark.parametrize("flags", ["-solver 90 -n 12 12 12",
                                   "-solver 91 -n 24 24 1"])
def test_ij_driver_amgdd_ids_take_the_reference_counts(flags):
    outs = []
    for run, kw in ((j_ij.run, {}), (t_ij.run, dict(
            device="cpu", dtype=torch.float64))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            outs.append(run(flags.split(), **kw))
    (j_it, j_rel), (t_it, t_rel) = outs
    assert t_it == j_it
    assert abs(t_rel - j_rel) <= 1e-6 * j_rel
