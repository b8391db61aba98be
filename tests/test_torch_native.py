"""hypre_tpu_torch's host C++ setup against hypre_tpu's.

The port builds its own copy of the reference's C++ source with g++, so on
the same CSR arrays every wrapper must give the reference's bits, and the
native setup the reference's native hierarchy exactly (CF splittings,
interpolation, coarse operators, level sizes): by default, with aggressive
coarsening on the first level and with non-Galerkin sparsification. The
default facade takes the native setup in both packages (the reference's
``"auto"`` rule). Reference setups here are native only: its pure setup
compiles per level shape.
"""

import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

from hypre_tpu import native as j_native
from hypre_tpu.amg import hierarchy as j_hier
from hypre_tpu.amg.boomeramg import BoomerAMG as JBoomerAMG
from hypre_tpu.problems.laplacian import laplacian_3d_7pt as j_lap7
from hypre_tpu.seq.csr import HostCSR

import hypre_tpu_torch as H
from hypre_tpu_torch import native
from hypre_tpu_torch.amg import hierarchy as t_hier
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def lap7_csr(n: int):
    """The 7-pt n^3 Laplacian's host CSR arrays (the port's generator)."""
    A = H.laplacian_3d_7pt(n, n, n, dtype=torch.float64, device="cpu")
    return t_hier._ell_to_csr_arrays(A)


def signed_csr():
    """A non-M-matrix: rows with positive strong off-diagonals, which make
    ext+i's symbolic bound exceed what its numeric pass emits (the case of
    tests/test_amg2.py::test_extpi_native_positive_offdiag_rows)."""
    rng = np.random.default_rng(7)
    n = 60
    dense = np.zeros((n, n))
    for i in range(n):
        dense[i, i] = 4.0
        for j in (i - 2, i - 1, i + 1, i + 2):
            if 0 <= j < n:
                dense[i, j] = 1.0 if rng.random() < 0.4 else -1.0
    r, c = np.nonzero(dense)
    A = HostCSR.from_coo(r, c, dense[r, c], (n, n))
    return (n, A.indptr.astype(np.int32), A.indices.astype(np.int32),
            np.ascontiguousarray(A.data, np.float64))


def test_source_is_the_reference_source():
    assert filecmp.cmp(ROOT / "csrc" / "hypre_tpu_native.cpp", native.SOURCE,
                       shallow=False)
    assert native.available() and j_native.available()


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("case", ["7pt-12", "signed"])
def test_wrappers_are_bit_equal(case):
    n, Ap, Aj, Ax = lap7_csr(12) if case == "7pt-12" else signed_csr()
    S = native.strength(n, Ap, Aj, Ax, 0.25, 0.9)
    np.testing.assert_array_equal(S, j_native.strength(n, Ap, Aj, Ax, 0.25,
                                                       0.9))
    cf = native.pmis(n, Ap, Aj, S)
    np.testing.assert_array_equal(cf, j_native.pmis(n, Ap, Aj, S))
    np.testing.assert_array_equal(native.rs(n, Ap, Aj, S),
                                  j_native.rs(n, Ap, Aj, S))
    is_c = cf == 1
    assert is_c.any() and (~is_c).any()
    cmap = np.where(is_c, np.cumsum(is_c) - 1, -1).astype(np.int32)
    nc = int(is_c.sum())
    P = native.extpi_interp(n, Ap, Aj, Ax, S, cf, cmap)
    assert_same(P, j_native.extpi_interp(n, Ap, Aj, Ax, S, cf, cmap))
    assert (P[1] >= 0).all()
    assert_same(native.direct_interp(n, Ap, Aj, Ax, S, cf, cmap),
                j_native.direct_interp(n, Ap, Aj, Ax, S, cf, cmap))
    # truncate works in place: each package on its own copy
    mine = native.truncate(n, *(a.copy() for a in P), 2, 0.1)
    theirs = j_native.truncate(n, *(a.copy() for a in P), 2, 0.1)
    assert_same(mine, theirs)
    assert_same(native.transpose(n, nc, *P), j_native.transpose(n, nc, *P))
    assert_same(native.spgemm(n, nc, Ap, Aj, Ax, *P),
                j_native.spgemm(n, nc, Ap, Aj, Ax, *P))
    x = np.random.default_rng(3).standard_normal(n)
    np.testing.assert_array_equal(native.matvec(n, Ap, Aj, Ax, x),
                                  j_native.matvec(n, Ap, Aj, Ax, x))


def assert_same_hierarchy(th, jh):
    """Level sizes, CF splittings, P, P^T and every level operator (as
    sorted COO triples), the smoother vectors and the coarse inverse."""
    assert len(th.levels) == len(jh.levels)

    def coo(M):
        vals, cols = np.asarray(M.vals), np.asarray(M.cols)
        rows = np.repeat(np.arange(cols.shape[0]), cols.shape[1])
        keep = cols.reshape(-1) >= 0
        out = np.stack([rows[keep], cols.reshape(-1)[keep]], 1)
        return out, vals.reshape(-1)[keep]

    for tl, jl in zip(th.levels, jh.levels):
        for name in ("A", "P", "Pt"):
            tM, jM = getattr(tl, name), getattr(jl, name)
            assert tM.shape == (jM.n_rows, jM.n_cols), name
            (tij, tv), (jij, jv) = coo(tM), coo(jM)
            np.testing.assert_array_equal(tij, jij)
            np.testing.assert_array_equal(tv, jv)
        for name in ("dinv", "l1inv", "lmax", "cf"):
            np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                          np.asarray(getattr(jl, name)))
    np.testing.assert_array_equal(th.coarse_inv.numpy(),
                                  np.asarray(jh.coarse_inv))


@pytest.fixture(scope="module")
def problem():
    return (j_lap7(20, 20, 20),
            H.laplacian_3d_7pt(20, 20, 20, dtype=torch.float64, device="cpu"))


@pytest.mark.parametrize("knobs", [
    {}, {"agg_num_levels": 1}, {"nongalerkin_tol": 0.02},
], ids=["default", "agg_num_levels=1", "nongalerkin_tol=0.02"])
def test_native_hierarchy_equals_the_reference(problem, knobs):
    jA, tA = problem
    th = H.setup_hierarchy(tA, setup_backend="native", device="cpu", **knobs)
    jh = j_hier.setup_hierarchy(jA, setup_backend="native", **knobs)
    assert len(th.levels) >= 2
    assert_same_hierarchy(th, jh)
    if knobs:
        # each knob changes the hierarchy it is given
        base = H.setup_hierarchy(tA, setup_backend="native", device="cpu")
        assert ([lv.A.k for lv in th.levels]
                != [lv.A.k for lv in base.levels]
                or [lv.A.n_rows for lv in th.levels]
                != [lv.A.n_rows for lv in base.levels])


def test_default_facade_takes_native_in_both(problem):
    jA, tA = problem
    tamg = H.BoomerAMG().setup(tA, device="cpu")
    jamg = JBoomerAMG()
    jamg.setup(jA)
    assert tamg.setup_path == "native"
    assert t_hier.resolve_setup_backend("auto") == "native"
    assert_same_hierarchy(tamg.hierarchy, jamg.hierarchy)
    b = torch.ones(tA.n_rows, dtype=torch.float64)
    _, info = H.pcg(tA.mv, b, M=tamg.precond(), rtol=1e-8, device="cpu")
    assert int(info.iterations) <= 10


def test_auto_rule_and_what_native_refuses(problem, monkeypatch, tmp_path):
    _, tA = problem
    # knobs outside the native setup: 'auto' takes the pure setup, and
    # aggressive or non-Galerkin coarsening there raise as the reference's
    assert t_hier.resolve_setup_backend("auto", coarsen="cljp") == "jax"
    assert t_hier.resolve_setup_backend("auto", interp="classical") == "jax"
    with pytest.raises(ValueError, match="aggressive"):
        H.setup_hierarchy(tA, coarsen="cljp", agg_num_levels=1, device="cpu")
    with pytest.raises(ValueError, match="nongalerkin"):
        H.setup_hierarchy(tA, restrict_type="air", nongalerkin_tol=0.1,
                          device="cpu")
    # an explicit 'native' whose knobs it does not cover runs as the
    # reference's does (RS for cljp, ext+i for multipass): both packages
    # give the same hierarchy at 24^3
    knobs = dict(setup_backend="native", coarsen="cljp", interp="multipass")
    th = H.setup_hierarchy(
        H.laplacian_3d_7pt(24, 24, 24, dtype=torch.float64, device="cpu"),
        device="cpu", **knobs)
    assert len(th.levels) >= 2
    assert_same_hierarchy(th, j_hier.setup_hierarchy(j_lap7(24, 24, 24),
                                                     **knobs))
    # a library that does not build: 'native' raises with g++'s output,
    # 'auto' takes the pure setup
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        H.setup_hierarchy(tA, setup_backend="native", device="cpu")
    assert not native.available()
    assert t_hier.resolve_setup_backend("auto") == "jax"
    with pytest.raises(ValueError, match="aggressive"):
        H.BoomerAMG(agg_num_levels=1).setup(tA, device="cpu")
