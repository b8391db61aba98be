"""hypre_tpu_torch's sstruct driver on the CPU in float64: every
``SSTRUCT_GOLDEN`` case of tests/test_drivers.py (the reference's recorded
iterations, exact, and its residual bound), the sparse curl-curl
assembly against the reference's dense one, and the driver's objects.

The goldens are recorded numbers, so no reference solve runs here.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from hypre_tpu.drivers import sstruct as j_drv
from hypre_tpu.seq.ell import ell_to_csr as j_ell_to_csr

from hypre_tpu_torch.drivers import sstruct as drv
from hypre_tpu_torch.seq.ell import ell_to_csr
from test_drivers import SSTRUCT_GOLDEN
from torch_one_thread import one_torch_thread  # noqa: F401

F64 = torch.float64


@pytest.mark.parametrize("flags,iters,rel", SSTRUCT_GOLDEN,
                         ids=[c[0] for c in SSTRUCT_GOLDEN])
def test_sstruct_driver_golden(flags, iters, rel):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got_it, got_rel = drv.run(flags.split(), device="cpu", dtype=F64)
    out = buf.getvalue()
    assert "Iterations =" in out and "Final Relative Residual Norm" in out
    assert got_it == iters, f"iterations {got_it} != golden {iters}"
    assert got_rel <= rel * 1.2 + 1e-16


@pytest.mark.parametrize("n,beta", [(10, 0.05), (7, 0.3)])
def test_curl_curl_sparse_is_the_references_dense(n, beta):
    want = j_ell_to_csr(j_drv._curl_curl(n, beta))
    got = ell_to_csr(drv.curl_curl(n, beta, dtype=F64, device="cpu"))
    assert got.shape == want.shape
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    assert np.array_equal(got.data, want.data)


def test_driver_cases_hold_their_solvers():
    """``prepare`` sets up each id's solver object; ``solve`` takes
    another right-hand side."""
    from hypre_tpu_torch.sstruct import FAC, Maxwell, SplitSolver, SysPFMG

    kinds = {10: SplitSolver, 11: SplitSolver, 20: SplitSolver,
             3: SysPFMG, 28: FAC, 120: Maxwell}
    for sid, kind in kinds.items():
        case = drv.prepare(["-solver", str(sid), "-n", "8"], device="cpu",
                           dtype=F64)
        assert isinstance(case.solver, kind)
        x, info = case.solve(case.b * 2.0)
        assert bool(info.converged), sid
    with pytest.raises(SystemExit):
        drv.prepare(["-solver", "99"], device="cpu")
    with pytest.raises(SystemExit):
        drv.parse_args(["-bogus"])
