"""hypre_tpu_torch's AMG and PCG against hypre_tpu's pure setup path.

Both packages build the hierarchy with the pure setup
(``setup_backend="jax"``, PMIS, ext+i, p_max_elmts=4, Chebyshev) in
float64 on the CPU. The port must give the same level sizes, CF splits and
sparsity, values within 1e-12; its cycle, run on a numpy copy of the JAX
hierarchy, must match the JAX cycle within 1e-10, with plain ELL levels
and with every coarse A and every P in the banded format (plain versions);
PCG must take the same number of iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.amg import hierarchy as j_hier
from hypre_tpu.krylov import pcg as j_pcg
from hypre_tpu.problems.laplacian import laplacian_2d_5pt as j_lap5, \
    laplacian_3d_7pt as j_lap7

import hypre_tpu_torch as H
from hypre_tpu_torch import kernels
from hypre_tpu_torch.seq import fastmv
from torch_one_thread import one_torch_thread  # noqa: F401


SETUP = dict(setup_backend="jax", coarsen="pmis", interp="ext+i",
             p_max_elmts=4, relax="chebyshev", max_coarse_size=64)


def flatten(jh) -> dict:
    """A JAX AMGHierarchy as the dict of numpy arrays hierarchy_from_numpy
    takes."""
    def mat(M):
        if M is None:
            return None
        return {"vals": np.asarray(M.vals), "cols": np.asarray(M.cols),
                "n_cols": M.n_cols, "shifts": M.shifts}

    return {
        "levels": [{"A": mat(lv.A), "P": mat(lv.P), "Pt": mat(lv.Pt),
                    "dinv": np.asarray(lv.dinv),
                    "l1inv": np.asarray(lv.l1inv),
                    "lmax": np.asarray(lv.lmax), "cf": np.asarray(lv.cf)}
                   for lv in jh.levels],
        "coarse_inv": np.asarray(jh.coarse_inv),
        "galerkin": jh.galerkin,
    }


@pytest.fixture(scope="module")
def problems():
    """(jax A, port A, jax hierarchy, port hierarchy) per problem, built
    once for the module."""
    out = {}
    for name, jA, tA in (
        ("7pt-16", j_lap7(16, 16, 16),
         H.laplacian_3d_7pt(16, 16, 16, dtype=torch.float64, device="cpu")),
        ("5pt-32", j_lap5(32, 32),
         H.laplacian_2d_5pt(32, 32, dtype=torch.float64, device="cpu")),
    ):
        out[name] = (jA, tA, j_hier.setup_hierarchy(jA, **SETUP),
                     H.setup_hierarchy(tA, device="cpu", **SETUP))
    return out


def rel_close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max(initial=0.0) <= rtol * max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("name", ["7pt-16", "5pt-32"])
def test_setup_matches_reference(problems, name):
    _, _, jh, th = problems[name]
    assert [lv.A.n_rows for lv in th.levels] == \
        [lv.A.n_rows for lv in jh.levels]
    assert th.coarse_inv.shape == jh.coarse_inv.shape
    assert len(th.levels) >= 2
    for jl, tl in zip(jh.levels, th.levels):
        assert np.array_equal(tl.cf.numpy(), np.asarray(jl.cf))
        for tM, jM in ((tl.A, jl.A), (tl.P, jl.P), (tl.Pt, jl.Pt)):
            assert (tM.k, tM.n_cols) == (jM.k, jM.n_cols)
            assert np.array_equal(tM.cols.numpy(), np.asarray(jM.cols))
            assert rel_close(tM.vals, jM.vals, 1e-12)
        assert rel_close(tl.dinv, jl.dinv, 1e-12)
        assert abs(float(tl.lmax) - float(jl.lmax)) <= 1e-12 * float(jl.lmax)
    assert rel_close(th.coarse_inv, jh.coarse_inv, 1e-10)


def force_banded(hier):
    """Every coarse A and every P in the banded format (float64 included,
    which try_banded itself declines), restriction through P's
    transpose schedule."""
    def banded(M):
        n_pad = -(-M.n_rows // 1024) * 1024
        vt, lt, lo, sc = fastmv._banded_sched_payload(M.vals, M.cols, 1024,
                                                       n_pad)
        wmax, lomax = (int(v) for v in sc.tolist())
        band = fastmv.banded_from_sched(M, vt, lt, lo, wmax, lomax)
        return fastmv.with_transpose_schedule(band).drop_ell()

    levels = []
    for i, lv in enumerate(hier.levels):
        A = lv.A if i == 0 else banded(lv.A)
        levels.append(H.Level(A=A, P=banded(lv.P), Pt=None, dinv=lv.dinv,
                              l1inv=lv.l1inv, lmax=lv.lmax, cf=lv.cf))
    return H.AMGHierarchy(levels=levels, coarse_inv=hier.coarse_inv)


@pytest.mark.parametrize("fmt", ["ell", "banded", "optimized"])
def test_cycle_on_reference_hierarchy_matches(problems, fmt):
    jA, _, jh, _ = problems["7pt-16"]
    th = H.hierarchy_from_numpy(flatten(jh), device="cpu")
    if fmt == "banded":
        th = force_banded(th)
    elif fmt == "optimized":
        th = H.optimize_hierarchy(th, specialize=True, device="cpu")
    rng = np.random.default_rng(11)
    f = rng.standard_normal(jA.n_rows)
    u0 = rng.standard_normal(jA.n_rows)
    j_sm = j_hier.make_smoother("chebyshev", 1.0, 2, 0.3)
    t_sm = H.make_smoother("chebyshev", 1.0, 2, 0.3)
    for ctype in (1, 2):
        ref = np.asarray(j_hier.amg_cycle(jh, jnp.asarray(f), jnp.asarray(u0),
                                          smoother=j_sm, cycle_type=ctype))
        launches = dict(kernels.LAUNCHES)
        got = H.amg_cycle(th, torch.from_numpy(f), torch.from_numpy(u0),
                          smoother=t_sm, cycle_type=ctype).numpy()
        assert kernels.LAUNCHES == launches
        assert rel_close(got, ref, 1e-10)


def test_amg_pcg_matches_reference(problems):
    jA, tA, jh, th = problems["7pt-16"]
    b = np.random.default_rng(12).standard_normal(jA.n_rows)
    j_sm = j_hier.make_smoother("chebyshev", 1.0, 2, 0.3)
    t_sm = H.make_smoother("chebyshev", 1.0, 2, 0.3)
    jx, jinfo = j_pcg(jA.mv, jnp.asarray(b),
                      M=lambda r: j_hier.amg_cycle(jh, r, smoother=j_sm),
                      rtol=1e-10)
    fast = H.optimize_hierarchy(th, device="cpu")
    tx, tinfo = H.pcg(fast.levels[0].A.mv, torch.from_numpy(b),
                      M=lambda r: H.amg_cycle(fast, r, smoother=t_sm),
                      rtol=1e-10, device="cpu")
    assert bool(tinfo.converged) and bool(jinfo.converged)
    assert int(tinfo.iterations) == int(jinfo.iterations)
    assert rel_close(tx, jx, 1e-8)
    assert float(tinfo.relative_residual) <= 1e-10


def test_optimized_hierarchy_restricts_through_transpose_schedule(
        monkeypatch):
    """With every operator large enough to go banded, optimize_hierarchy
    drops Pt and gives each such P its transpose schedule; the V-cycle and
    PCG then agree with the same hierarchy left in ELL."""
    monkeypatch.setattr(fastmv, "MIN_BANDED_ELEMENTS", 0)
    tA = H.laplacian_3d_7pt(16, 16, 16, dtype=torch.float32, device="cpu")
    th = H.setup_hierarchy(tA, device="cpu", **SETUP)
    fast = H.optimize_hierarchy(th, prefer_pallas=True, device="cpu")
    through_p = [lv for lv in fast.levels if lv.Pt is None]
    assert len(through_p) == len(fast.levels) >= 2
    for lv in through_p:
        assert isinstance(lv.P, fastmv.BandedEll) and lv.P.ell is None
        assert lv.P.t_vals is not None and lv.P.t_cap == fastmv.T_CHUNK
    sm = H.make_smoother("chebyshev", 1.0, 2, 0.3)
    b = torch.from_numpy(np.random.default_rng(13).standard_normal(
        tA.n_rows).astype(np.float32))
    launches = dict(kernels.LAUNCHES)
    cyc_fast = H.amg_cycle(fast, b, smoother=sm)
    cyc_ell = H.amg_cycle(th, b, smoother=sm)
    # float32, sums in another order
    assert rel_close(cyc_fast, cyc_ell, 1e-5)
    its = []
    for hier in (fast, th):
        _, info = H.pcg(hier.levels[0].A.mv, b,
                        M=lambda r, h=hier: H.amg_cycle(h, r, smoother=sm),
                        rtol=1e-5, device="cpu")
        assert bool(info.converged)
        its.append(int(info.iterations))
    assert its[0] == its[1]
    assert kernels.LAUNCHES == launches


@pytest.mark.parametrize("kw", [dict(), dict(two_norm=False),
                                dict(recompute_residual=True, logging=1),
                                dict(recompute_residual_p=5, cf_tol=0.99)])
def test_jacobi_pcg_matches_reference_ds_pcg_41(kw):
    """hypre's DS-PCG golden on its default ij problem (10^3 7-pt, random
    rhs, tol 1e-8) is 41 iterations, as test_hypre_parity.py pins for the
    reference."""
    jA = j_lap7(10, 10, 10)
    tA = H.laplacian_3d_7pt(10, 10, 10, dtype=torch.float64, device="cpu")
    b = np.random.default_rng(1).standard_normal(1000)
    jd = 1.0 / jA.diagonal()
    td = 1.0 / tA.diagonal()
    jx, jinfo = j_pcg(jA.mv, jnp.asarray(b), M=lambda r: jd * r, rtol=1e-8,
                      maxiter=1000, **kw)
    tx, tinfo = H.pcg(tA.mv, torch.from_numpy(b), M=lambda r: td * r,
                      rtol=1e-8, maxiter=1000, device="cpu", **kw)
    assert int(tinfo.iterations) == int(jinfo.iterations)
    if not kw:
        assert int(tinfo.iterations) == 41
    assert bool(tinfo.converged) == bool(jinfo.converged)
    assert rel_close(tx, jx, 1e-8)
    if kw.get("logging"):
        assert rel_close(tinfo.res_history, jinfo.res_history, 1e-8)


def test_zero_rhs_and_unported_options():
    tA = H.laplacian_3d_7pt(4, 4, 4, dtype=torch.float64, device="cpu")
    x, info = H.pcg(tA.mv, torch.zeros(64, dtype=torch.float64), device="cpu")
    assert bool(info.converged) and int(info.iterations) == 0
    assert float(x.abs().max()) == 0.0
    # the host C++ setup is ported now
    native = H.setup_hierarchy(tA, setup_backend="native", max_coarse_size=10,
                               device="cpu")
    assert len(native.levels) >= 1
    with pytest.raises(NotImplementedError, match="device"):
        H.setup_hierarchy(tA, setup_backend="jax", agg_num_levels=1,
                          device="cpu")
    # Ruge-Stüben is ported now
    ruge = H.setup_hierarchy(tA, coarsen="ruge", setup_backend="jax",
                             max_coarse_size=10, device="cpu")
    assert len(ruge.levels) >= 1
