"""hypre_tpu_torch's Hybrid, MGR and BlockTridiag solvers against
hypre_tpu's, in float64 on the CPU, on the reference's own test problems
(tests/test_krylov2.py, tests/test_mgr_ams.py,
tests/test_misc_components.py).

The reference's solvers are given BoomerAMG(setup_backend="jax") (their
default 'auto' picks the C++ setup), and so are the port's, wherever a
test holds the two against each other; the reference's MGR forms A_H = R A P with
the C++ SpGEMM, which the test replaces with a numpy CSR product
(monkeypatch): nothing here calls the reference's native library.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu import native as j_native
from hypre_tpu.amg import BoomerAMG as JBoomerAMG
from hypre_tpu.amg.block_tridiag import BlockTridiag as JBlockTridiag
from hypre_tpu.amg.hybrid import HybridSolver as JHybridSolver
from hypre_tpu.amg.mgr import MGR as JMGR
from hypre_tpu.krylov import gmres as j_gmres
from hypre_tpu.problems.laplacian import laplacian_2d_5pt as j_lap5
from hypre_tpu.seq.csr import HostCSR as JHostCSR
from hypre_tpu.seq.ell import ell_from_dense as j_ell_from_dense, \
    ell_to_csr as j_ell_to_csr

import hypre_tpu_torch as H
from hypre_tpu_torch.seq.ell import ell_from_dense, ell_to_csr
from torch_one_thread import one_torch_thread  # noqa: F401


def numpy_spgemm(n, m, Ap, Aj, Ax, Bp, Bj, Bx):
    """C = A B over CSR arrays, in numpy (the C++ routine's contract:
    int32 pointers and columns, f64 values)."""
    A = JHostCSR(Ap, Aj, Ax, (n, int(Bp.shape[0]) - 1))
    B = JHostCSR(Bp, Bj, Bx, (int(Bp.shape[0]) - 1, m))
    C = A.matmat(B)
    return (C.indptr.astype(np.int32), C.indices.astype(np.int32),
            C.data.astype(np.float64))


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(j_native, "spgemm", numpy_spgemm)


def rel_close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max(initial=0.0) <= rtol * max(np.abs(b).max(), 1e-300)


def same_csr(t, j):
    assert t.shape == j.shape
    assert np.array_equal(t.indptr, j.indptr)
    assert np.array_equal(t.indices, j.indices)
    assert np.array_equal(t.data, j.data)


# ---------------------------------------------------------------------------
# Hybrid
# ---------------------------------------------------------------------------


def test_hybrid_escalates_to_amg_as_the_reference_does():
    """48^2 5-pt Laplacian, cf_tol 0.5: DS-PCG stalls and the solver
    escalates; both phases take the reference's iterations."""
    jA = j_lap5(48, 48)
    tA = H.laplacian_2d_5pt(48, 48, dtype=torch.float64, device="cpu")
    b = np.ones(48 * 48)
    jh = JHybridSolver(cf_tol=0.5, dscg_max_iter=500,
                       amg=JBoomerAMG(setup_backend="jax")).setup(jA)
    jx, ji = jh.solve(jnp.asarray(b), rtol=1e-8)
    th = H.HybridSolver(cf_tol=0.5, dscg_max_iter=500,
                        amg=H.BoomerAMG(setup_backend="jax")).setup(
        tA, device="cpu")
    tx, ti = th.solve(torch.from_numpy(b), rtol=1e-8)
    assert bool(ti.converged) and bool(ji.converged)
    assert th.amg_iterations > 0 and th.dscg_iterations > 0
    assert (th.dscg_iterations, th.amg_iterations) == \
        (jh.dscg_iterations, jh.amg_iterations)
    assert int(ti.iterations) == int(ji.iterations)
    assert rel_close(tx, jx, 1e-8)
    r = b - ell_to_csr(tA).matvec(tx.numpy())
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-7


def test_hybrid_stays_diagonal_when_easy():
    n = 64
    rng = np.random.default_rng(7)
    M = np.diag(rng.random(n) + 1.0)
    b = rng.standard_normal(n)
    jh = JHybridSolver(cf_tol=0.9).setup(j_ell_from_dense(M))
    jx, ji = jh.solve(jnp.asarray(b), rtol=1e-10)
    th = H.HybridSolver(cf_tol=0.9).setup(ell_from_dense(M, device="cpu"),
                                          device="cpu")
    tx, ti = th.solve(torch.from_numpy(b), rtol=1e-10)
    assert bool(ti.converged) and th.amg_iterations == 0
    assert (th.dscg_iterations, th.amg_iterations) == \
        (jh.dscg_iterations, jh.amg_iterations)
    assert rel_close(tx, jx, 1e-12)


@pytest.mark.parametrize("solver_type,ds_max", [("gmres", 30),
                                                ("bicgstab", 10)])
def test_hybrid_other_krylov_phases(solver_type, ds_max):
    """GMRES and BiCGSTAB run both phases without the cf cutoff (the
    reference applies it to PCG only): a tight DS budget forces the
    escalation. GMRES's budget is one whole restart cycle: with a shorter
    one the reference overshoots it (dscg_max_iter=10 reports 30), the
    port stops at it."""
    jA = j_lap5(48, 48)
    tA = H.laplacian_2d_5pt(48, 48, dtype=torch.float64, device="cpu")
    b = np.ones(48 * 48)
    jh = JHybridSolver(solver_type=solver_type, dscg_max_iter=ds_max,
                       amg=JBoomerAMG(setup_backend="jax")).setup(jA)
    jx, ji = jh.solve(jnp.asarray(b), rtol=1e-8)
    th = H.HybridSolver(solver_type=solver_type, dscg_max_iter=ds_max,
                        amg=H.BoomerAMG(setup_backend="jax")) \
        .setup(tA, device="cpu")
    tx, ti = th.solve(torch.from_numpy(b), rtol=1e-8)
    assert bool(ti.converged) and th.amg_iterations > 0
    assert (th.dscg_iterations, th.amg_iterations) == \
        (jh.dscg_iterations, jh.amg_iterations)
    assert rel_close(tx, jx, 1e-8)


# ---------------------------------------------------------------------------
# MGR
# ---------------------------------------------------------------------------


def mgr_laplacian():
    n = 16
    cpts = np.nonzero((np.arange(n * n) // n + np.arange(n * n) % n) % 2
                      == 0)[0]
    return (j_lap5(n, n),
            H.laplacian_2d_5pt(n, n, dtype=torch.float64, device="cpu"),
            [cpts])


def block_system(n=10):
    """The reference test's 2x2 block system [[A, B], [B^T, 4 I]]: A the
    5-pt Laplacian, B 0.1 on the diagonal and 0.05 above it."""
    Ad = j_ell_to_csr(j_lap5(n, n)).to_dense()
    m = n * n
    Bd = np.zeros((m, m))
    idx = np.arange(m)
    Bd[idx, idx] = 0.1
    Bd[idx[:-1], idx[1:]] = 0.05
    S = np.block([[Ad, Bd], [Bd.T, np.eye(m) * 4.0]])
    return (j_ell_from_dense(S), ell_from_dense(S, device="cpu"),
            [np.arange(m, 2 * m)])


@pytest.fixture(scope="module", params=["laplacian", "block"])
def mgr_pair(request):
    """(reference MGR, port MGR, reference A, port A) for one problem,
    set up once; the C++ SpGEMM replaced by numpy for the setup."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_native, "spgemm", numpy_spgemm)
    try:
        if request.param == "laplacian":
            jA, tA, cpts = mgr_laplacian()
            kw = {}
        else:
            jA, tA, cpts = block_system()
            kw = dict(num_relax_sweeps=2)
        jm = JMGR(coarse_amg=JBoomerAMG(setup_backend="jax"), **kw).setup(
            jA, cpts)
        tm = H.MGR(coarse_amg=H.BoomerAMG(setup_backend="jax"), **kw).setup(
            tA, cpts, device="cpu")
    finally:
        mp.undo()
    return request.param, jm, tm, jA, tA


def test_mgr_levels_are_the_reference(mgr_pair):
    """P and R exactly; A_H = R A P to 1e-12 (the port's ell_spgemm and
    the reference's SpGEMM sum in different orders)."""
    _, jm, tm, _, _ = mgr_pair
    assert len(tm.levels) == len(jm.levels) == 1
    for tl, jl in zip(tm.levels, jm.levels):
        same_csr(ell_to_csr(tl.P), j_ell_to_csr(jl.P))
        same_csr(ell_to_csr(tl.R), j_ell_to_csr(jl.R))
        assert np.array_equal(tl.f_mask.numpy(), np.asarray(jl.f_mask))
        assert np.array_equal(tl.dinv.numpy(), np.asarray(jl.dinv))
    t_AH = tm.coarse_amg.hierarchy.levels[0].A if \
        tm.coarse_amg.hierarchy.levels else None
    j_AH = jm.coarse_amg.hierarchy.levels[0].A if \
        jm.coarse_amg.hierarchy.levels else None
    assert (t_AH is None) == (j_AH is None)
    if t_AH is not None:
        td, jd = ell_to_csr(t_AH).to_dense(), j_ell_to_csr(j_AH).to_dense()
        assert rel_close(td, jd, 1e-12)
        assert [lv.A.n_rows for lv in tm.coarse_amg.hierarchy.levels] == \
            [lv.A.n_rows for lv in jm.coarse_amg.hierarchy.levels]


def test_mgr_solves_take_the_reference_iterations(mgr_pair):
    """The Laplacian with MGR as the solver (rtol 1e-8); the block system
    with MGR as GMRES's preconditioner, which must beat plain GMRES."""
    name, jm, tm, jA, tA = mgr_pair
    b = np.ones(tA.n_rows)
    if name == "laplacian":
        jx, ji = jm.solve(jnp.asarray(b), rtol=1e-8, maxiter=100)
        tx, ti = tm.solve(torch.from_numpy(b), rtol=1e-8, maxiter=100)
    else:
        jx, ji = j_gmres(jA.mv, jnp.asarray(b), M=jm.precond(), rtol=1e-8,
                         maxiter=200)
        tx, ti = H.gmres(tA.mv, torch.from_numpy(b), M=tm.precond(),
                         rtol=1e-8, maxiter=200, device="cpu")
        _, t0 = H.gmres(tA.mv, torch.from_numpy(b), rtol=1e-8, maxiter=500,
                        device="cpu")
        assert int(ti.iterations) < int(t0.iterations)
    assert bool(ti.converged) and bool(ji.converged)
    assert int(ti.iterations) == int(ji.iterations)
    assert rel_close(tx, jx, 1e-8)


def test_mgr_global_jacobi_smoother_matches(no_native):
    jA, tA, cpts = mgr_laplacian()
    jm = JMGR(coarse_amg=JBoomerAMG(setup_backend="jax"),
              global_smooth_type="jacobi", global_smooth_iters=2).setup(
        jA, cpts)
    tm = H.MGR(coarse_amg=H.BoomerAMG(setup_backend="jax"),
               global_smooth_type="jacobi", global_smooth_iters=2).setup(
        tA, cpts, device="cpu")
    f = np.random.default_rng(3).standard_normal(tA.n_rows)
    assert rel_close(tm.cycle(torch.from_numpy(f)), jm.cycle(jnp.asarray(f)),
                     1e-10)


def test_mgr_ilu_global_smoother_matches(no_native):
    """The global ILU(0) pass ahead of the reduction cycle (CPR): the
    reference's cycle to 1e-10 on the Laplacian. On the block system the
    port's MGR-GMRES with the ILU pass takes fewer iterations than with
    the Jacobi pass (9 against 16; the reference's ILU-preconditioned
    solves are slow on the CPU, so only the cycle is held against it)."""
    jA, tA, cpts = mgr_laplacian()
    jm = JMGR(coarse_amg=JBoomerAMG(setup_backend="jax"),
              global_smooth_type="ilu").setup(jA, cpts)
    tm = H.MGR(coarse_amg=H.BoomerAMG(setup_backend="jax"),
               global_smooth_type="ilu").setup(tA, cpts, device="cpu")
    f = np.random.default_rng(5).standard_normal(tA.n_rows)
    assert rel_close(tm.cycle(torch.from_numpy(f)), jm.cycle(jnp.asarray(f)),
                     1e-10)
    _, tB, bcpts = block_system()
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tB.n_rows))
    its = {}
    for kind in ("ilu", "jacobi"):
        m = H.MGR(global_smooth_type=kind, num_relax_sweeps=2).setup(
            tB, bcpts, device="cpu")
        x, info = H.gmres(tB.mv, b, M=m.precond(), rtol=1e-8, maxiter=200,
                          device="cpu")
        assert bool(info.converged)
        its[kind] = int(info.iterations)
    assert its["ilu"] < its["jacobi"]


def test_mgr_injection_interpolation(no_native):
    jA, tA, cpts = mgr_laplacian()
    jm = JMGR(interp_type="injection",
              coarse_amg=JBoomerAMG(setup_backend="jax")).setup(jA, cpts)
    tm = H.MGR(interp_type="injection",
               coarse_amg=H.BoomerAMG(setup_backend="jax")).setup(
        tA, cpts, device="cpu")
    same_csr(ell_to_csr(tm.levels[0].P), j_ell_to_csr(jm.levels[0].P))
    f = np.random.default_rng(4).standard_normal(tA.n_rows)
    assert rel_close(tm.cycle(torch.from_numpy(f)), jm.cycle(jnp.asarray(f)),
                     1e-10)


# ---------------------------------------------------------------------------
# BlockTridiag
# ---------------------------------------------------------------------------


def test_block_tridiag_is_the_reference():
    """tests/test_misc_components.py's problem: the 20^2 5-pt Laplacian
    split at n^2/2. The blocks exactly, then GMRES with the preconditioner
    in the reference's iterations (<= 20)."""
    n = 20
    jA = j_lap5(n, n)
    tA = H.laplacian_2d_5pt(n, n, dtype=torch.float64, device="cpu")
    i1 = np.arange(n * n // 2)
    jb = JBlockTridiag(amg_knobs=dict(max_coarse_size=64,
                                      setup_backend="jax")).setup(jA, i1)
    tb = H.BlockTridiag(amg_knobs=dict(max_coarse_size=64,
                                       setup_backend="jax")).setup(
        tA, i1, device="cpu")
    for name in ("A11", "A21", "A22"):
        same_csr(ell_to_csr(getattr(tb, name)),
                 j_ell_to_csr(getattr(jb, name)))
    b = np.ones(n * n)
    jx, ji = j_gmres(jA.mv, jnp.asarray(b), M=jb.precond(), rtol=1e-8)
    tx, ti = H.gmres(tA.mv, torch.from_numpy(b), M=tb.precond(), rtol=1e-8,
                     device="cpu")
    assert bool(ti.converged)
    assert int(ti.iterations) == int(ji.iterations) <= 20
    assert rel_close(tx, jx, 1e-8)


def test_block_tridiag_blocks_of_elasticity_are_the_reference():
    """elasticity_2d(8, 8) with index set 1 = the u dofs: the three
    blocks the port cuts out are the reference's, exactly; the u-u block
    is the anisotropic scalar operator (lam + 2 mu, mu)."""
    from hypre_tpu.amg.block_tridiag import _extract as j_extract
    from hypre_tpu.problems.laplacian import elasticity_2d as j_elast

    from hypre_tpu_torch.amg.block_tridiag import _extract

    jA = j_elast(8, 8)
    tA = H.elasticity_2d(8, 8, dtype=torch.float64, device="cpu")
    i1, i2 = np.arange(0, 128, 2), np.arange(1, 128, 2)
    for rows, cols in ((i1, i1), (i2, i1), (i2, i2)):
        same_csr(ell_to_csr(_extract(tA, rows, cols)),
                 j_ell_to_csr(j_extract(jA, rows, cols)))
    A11 = ell_to_csr(_extract(tA, i1, i1)).to_dense()
    assert A11[27, 27] == 8.0 and A11[27, 19] == -3.0 and A11[27, 26] == -1.0
