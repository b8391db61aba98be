"""hypre_tpu_torch's Krylov drivers against hypre_tpu's, in float64 on the
CPU.

The problem is the one ``test_hypre_parity.py`` solves: hypre's default ij
problem, the 10^3 7-pt Laplacian, with a random right-hand side from
``default_rng(1)``, at tol 1e-8. Each driver of the port must take the
reference's iteration count on the same inputs (and the counts the
reference pins against hypre's goldens: DS-GMRES 93, DS-COGMRES 93,
DS-FlexGMRES 93, DS-LGMRES 65, CGNR 129, AMG-PCG <= 7) and give its
solution to 1e-10 (CGNR, BiCGSTAB and LOBPCG: 1e-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.amg import BoomerAMG as JBoomerAMG
from hypre_tpu.krylov import (
    bicgstab as j_bicgstab, block_op as j_block_op, cgnr as j_cgnr,
    cogmres as j_cogmres, flexgmres as j_flexgmres, gmres as j_gmres,
    lgmres as j_lgmres, lobpcg as j_lobpcg, pcg as j_pcg,
)
from hypre_tpu.problems.laplacian import laplacian_3d_7pt as j_lap7
from hypre_tpu.seq.spgemm import ell_transpose as j_transpose

import hypre_tpu_torch as H
from hypre_tpu_torch.seq.spgemm import ell_transpose
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def problem():
    jA = j_lap7(10, 10, 10)
    tA = H.laplacian_3d_7pt(10, 10, 10, dtype=torch.float64, device="cpu")
    b = np.random.default_rng(1).standard_normal(1000)
    return jA, tA, b


def rel_close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max(initial=0.0) <= rtol * max(np.abs(b).max(), 1e-300)


GMRES_FAMILY = [
    ("gmres", j_gmres, H.gmres, dict(k_dim=5), 93),
    ("gmres-cgs1-logging", j_gmres, H.gmres,
     dict(k_dim=5, gs_passes=1, logging=1), 93),
    ("cogmres-cgs1", j_cogmres, H.cogmres, dict(k_dim=5, gs_passes=1), 93),
    ("cogmres-cgs2", j_cogmres, H.cogmres, dict(k_dim=5, gs_passes=2), 93),
    ("flexgmres", j_flexgmres, H.flexgmres, dict(k_dim=5), 93),
    ("lgmres", j_lgmres, H.lgmres, dict(k_dim=5, aug_dim=2), 65),
]


@pytest.mark.parametrize("name,j_fn,t_fn,kw,golden", GMRES_FAMILY,
                         ids=[c[0] for c in GMRES_FAMILY])
def test_ds_gmres_family_takes_the_reference_iterations(problem, name, j_fn,
                                                        t_fn, kw, golden):
    jA, tA, b = problem
    jd, td = 1.0 / jA.diagonal(), 1.0 / tA.diagonal()
    jx, ji = j_fn(jA.mv, jnp.asarray(b), M=lambda r: jd * r, rtol=1e-8,
                  maxiter=1000, **kw)
    tx, ti = t_fn(tA.mv, torch.from_numpy(b), M=lambda r: td * r, rtol=1e-8,
                  maxiter=1000, device="cpu", **kw)
    assert int(ti.iterations) == int(ji.iterations) == golden
    assert bool(ti.converged) and bool(ji.converged)
    assert rel_close(tx, jx, 1e-10)
    assert abs(float(ti.relative_residual) - float(ji.relative_residual)) \
        <= 1e-6 * float(ji.relative_residual)
    if kw.get("logging"):
        assert rel_close(ti.res_history, ji.res_history, 1e-8)


def test_cgnr_takes_the_reference_iterations(problem):
    jA, tA, b = problem
    jAt, tAt = j_transpose(jA), ell_transpose(tA)
    jx, ji = j_cgnr(jA.mv, jAt.mv, jnp.asarray(b), rtol=1e-8, maxiter=1000)
    tx, ti = H.cgnr(tA.mv, tAt.mv, torch.from_numpy(b), rtol=1e-8,
                    maxiter=1000, device="cpu")
    assert int(ti.iterations) == int(ji.iterations) == 129
    assert bool(ti.converged)
    # CG on the normal equations squares the condition number: over 129
    # iterations the two packages' differently ordered sums part at
    # ~2e-9, as PCG's do (test_torch_amg.py holds DS-PCG to 1e-8)
    assert rel_close(tx, jx, 1e-8)


@pytest.mark.parametrize("kw", [dict(), dict(recompute_residual=True,
                                             logging=1, atol=1e-9)])
def test_bicgstab_takes_the_reference_iterations(problem, kw):
    jA, tA, b = problem
    jd, td = 1.0 / jA.diagonal(), 1.0 / tA.diagonal()
    jx, ji = j_bicgstab(jA.mv, jnp.asarray(b), M=lambda r: jd * r,
                        rtol=1e-8, maxiter=1000, **kw)
    tx, ti = H.bicgstab(tA.mv, torch.from_numpy(b), M=lambda r: td * r,
                        rtol=1e-8, maxiter=1000, device="cpu", **kw)
    assert int(ti.iterations) == int(ji.iterations)
    assert bool(ti.converged) == bool(ji.converged)
    assert rel_close(tx, jx, 1e-8)
    if kw:
        assert bool(ti.stagnated) == bool(ji.stagnated)
        assert rel_close(ti.res_history, ji.res_history, 1e-8)


def test_lobpcg_gives_the_reference_eigenpairs():
    """The 4 smallest eigenpairs of a 6x7x8 Laplacian (distinct
    eigenvalues), Jacobi-preconditioned, from one random block, to a
    residual of 1e-4 (the eigenvalues then hold to ~1e-10; the
    reference's iteration levels off just below that residual)."""
    jA = j_lap7(6, 7, 8)
    tA = H.laplacian_3d_7pt(6, 7, 8, dtype=torch.float64, device="cpu")
    X0 = np.random.default_rng(5).standard_normal((jA.n_rows, 4))
    jd, td = 1.0 / jA.diagonal(), 1.0 / tA.diagonal()
    jlam, jX, jrn = j_lobpcg(j_block_op(jA.mv), jnp.asarray(X0),
                             T=lambda R: jd[:, None] * R, tol=1e-4,
                             maxiter=100)
    tlam, tX, trn = H.lobpcg(H.block_op(tA.mv), torch.from_numpy(X0),
                             T=lambda R: td[:, None] * R, tol=1e-4,
                             maxiter=100)
    assert rel_close(tlam, jlam, 1e-8)
    assert float(trn.max()) <= 1e-4 and float(np.max(np.asarray(jrn))) <= 1e-4
    # eigenvectors up to sign
    dots = (tX * torch.from_numpy(np.asarray(jX))).sum(dim=0).abs()
    norms = torch.linalg.vector_norm(tX, dim=0) * \
        torch.from_numpy(np.linalg.norm(np.asarray(jX), axis=0))
    assert torch.allclose(dots, norms, rtol=1e-6)
    # Dirichlet Laplacian: sum over axes of 2 - 2 cos(pi k / (m + 1))
    axes = [2 - 2 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1))
            for m in (6, 7, 8)]
    exact = np.sort((axes[0][:, None, None] + axes[1][None, :, None]
                     + axes[2][None, None, :]).ravel())[:4]
    assert rel_close(tlam, exact, 1e-8)


def test_amg_pcg_takes_the_reference_iterations(problem):
    """The facade as a PCG preconditioner (hypre's AMG-PCG golden is 7);
    the reference runs its pure setup (setup_backend='jax'), since its
    'auto' picks the C++ setup where that builds."""
    jA, tA, b = problem
    ja = JBoomerAMG(max_coarse_size=100, setup_backend="jax").setup(jA)
    jx, ji = j_pcg(jA.mv, jnp.asarray(b), M=ja.precond(), rtol=1e-8)
    ta = H.BoomerAMG(max_coarse_size=100, setup_backend="jax").setup(
        tA, device="cpu")
    tx, ti = H.pcg(tA.mv, torch.from_numpy(b), M=ta.precond(), rtol=1e-8,
                   device="cpu")
    assert [lv.A.n_rows for lv in ta.hierarchy.levels] == \
        [lv.A.n_rows for lv in ja.hierarchy.levels]
    assert int(ti.iterations) == int(ji.iterations) <= 7
    assert rel_close(tx, jx, 1e-10)


# COGMRES with the delayed second Gram-Schmidt pass on the unpreconditioned
# 7-pt Laplacian, random b from default_rng(0), rtol 1e-8:
# (grid, x0, gs_passes, reference count, port count).
COGMRES_PINNED = [
    (8, None, 2, 41, 38),
    (12, None, 2, 67, 74),
    (8, "ones", 2, 38, 43),
    (8, None, 1, 32, 32),
    (12, None, 1, 59, 59),
    (8, "ones", 1, 33, 33),
]


@pytest.mark.parametrize("m,x0,gs_passes,ref_count,port_count",
                         COGMRES_PINNED,
                         ids=[f"{c[0]}^3-x0={c[1]}-gs{c[2]}"
                              for c in COGMRES_PINNED])
def test_cogmres_count_gap_is_pinned(m, x0, gs_passes, ref_count,
                                     port_count):
    """COGMRES takes the norm of the orthogonalized vector from the
    Pythagorean identity ||w||^2 - ||h||^2. A long-double replay of the
    same recurrence (8^3, first restart) shows where the packages part:
    at the first Arnoldi step the second pass's coefficients h2 are
    rounding noise (exact norm 7.4e-18) and differ between the packages
    by 75x and 290x, and from there the error of ||w_perp||^2 grows about
    5x per step in both (reference 1.1e-15 at step 0, 2.1e-1 at step 20;
    port 1.6e-16 and 2.8e-3), so neither follows the exact recurrence
    past step ~20 and the restart count is set by the first rounding of
    the dot products. The port's operations are the reference's: its
    products over the first j+1 rows of V give the same bits as the
    reference's products over the whole masked V, and its rotation loop
    over i < j is the reference's masked loop without the no-op steps.
    What differs is the summation order of XLA's and PyTorch's dot
    products, so the gs_passes=2 counts are pinned with their gap, and
    the single-pass counts, which do not amplify it, are equal."""
    jA = j_lap7(m, m, m)
    tA = H.laplacian_3d_7pt(m, m, m, dtype=torch.float64, device="cpu")
    b = np.random.default_rng(0).standard_normal(m ** 3)
    jx0 = None if x0 is None else jnp.ones(m ** 3)
    tx0 = None if x0 is None else torch.ones(m ** 3, dtype=torch.float64)
    _, ji = j_cogmres(jA.mv, jnp.asarray(b), x0=jx0, rtol=1e-8,
                      maxiter=1000, gs_passes=gs_passes)
    _, ti = H.cogmres(tA.mv, torch.from_numpy(b), x0=tx0, rtol=1e-8,
                      maxiter=1000, gs_passes=gs_passes, device="cpu")
    assert bool(ji.converged) and bool(ti.converged)
    assert int(ji.iterations) == ref_count
    assert int(ti.iterations) == port_count


# (name, reference driver, port driver, arguments, the reference's count)
MAXITER_CASES = [
    ("gmres30", j_gmres, H.gmres, dict(k_dim=30), 60),
    ("flexgmres30", j_flexgmres, H.flexgmres, dict(k_dim=30), 60),
    ("cogmres30", j_cogmres, H.cogmres, dict(k_dim=30), 60),
    ("lgmres20", j_lgmres, H.lgmres, dict(k_dim=20), 41),
]


@pytest.mark.parametrize("name,j_fn,t_fn,kw,ref_count", MAXITER_CASES,
                         ids=[c[0] for c in MAXITER_CASES])
def test_gmres_family_stops_at_maxiter(name, j_fn, t_fn, kw, ref_count):
    """hypre's Arnoldi loop stops at max_iter (krylov/gmres.c). The
    reference finishes the restart cycle first and overshoots: at 16^3,
    random b from default_rng(0), rtol 1e-8, maxiter=35 it reports 60
    iterations for GMRES(30), FlexGMRES(30) and COGMRES(30) and 41 for
    LGMRES(20); the port departs from it on purpose."""
    jA = j_lap7(16, 16, 16)
    tA = H.laplacian_3d_7pt(16, 16, 16, dtype=torch.float64, device="cpu")
    b = np.random.default_rng(0).standard_normal(16 ** 3)
    _, ji = j_fn(jA.mv, jnp.asarray(b), rtol=1e-8, maxiter=35, **kw)
    tx, ti = t_fn(tA.mv, torch.from_numpy(b), rtol=1e-8, maxiter=35,
                  device="cpu", **kw)
    assert int(ji.iterations) == ref_count  # the reference's fault
    assert int(ti.iterations) == 35
    assert not bool(ti.converged)
    assert bool(torch.isfinite(tx).all())


ZERO_RHS_DRIVERS = ["pcg", "bicgstab", "cgnr", "gmres", "flexgmres",
                    "cogmres", "lgmres"]


@pytest.mark.parametrize("name", ZERO_RHS_DRIVERS)
def test_zero_rhs_with_nonzero_x0_returns_zeros(name):
    """hypre's PCG sets x = b = 0 and returns at once when b = 0. The
    reference iterates from a nonzero x0 to maxiter and reports
    converged (PCG at 16^3, maxiter=50: 50 iterations, x ~ 1e-12); every
    driver of the port returns zeros in 0 iterations, converged."""
    tA = H.laplacian_3d_7pt(16, 16, 16, dtype=torch.float64, device="cpu")
    b = torch.zeros(16 ** 3, dtype=torch.float64)
    x0 = torch.ones(16 ** 3, dtype=torch.float64)
    args = (tA.mv, tA.mv, b) if name == "cgnr" else (tA.mv, b)
    x, info = getattr(H, name)(*args, x0=x0, maxiter=50, device="cpu")
    assert int(info.iterations) == 0
    assert bool(info.converged)
    assert float(info.relative_residual) == 0.0
    assert bool((x == 0).all())


def test_zero_rhs_keeps_the_logging_arrays():
    tA = H.laplacian_3d_7pt(8, 8, 8, dtype=torch.float64, device="cpu")
    b = torch.zeros(512, dtype=torch.float64)
    _, info = H.pcg(tA.mv, b, x0=torch.ones(512, dtype=torch.float64),
                    maxiter=20, logging=1, recompute_residual=True,
                    device="cpu")
    assert info.res_history.shape == (21,)
    assert float(info.res_history[0]) == 0.0
    assert not bool(info.stagnated)
