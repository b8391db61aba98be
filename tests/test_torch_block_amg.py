"""hypre_tpu_torch's BSR storage and nodal block AMG against hypre_tpu's,
in float64 on the CPU.

- ``ell_to_bsr`` gives the reference's block values and block columns
  exactly (elasticity_2d, fem_block_2d, a random matrix with 3x3 blocks),
  and the scalar view back; ``mv``, ``block_diagonal`` and
  ``block_jacobi_precond`` match to 1e-13.
- ``nodal_norm_matrix`` (both modes) and ``block_direct_interp`` match to
  1e-10, with the reference's pattern.
- BlockAMG builds the reference's levels and takes its iterations under
  PCG on elasticity_2d(16, 16) (tests/test_amg2.py:282-310) and under GMRES
  on fem_block_2d(16) (tests/test_unstructured.py:82): the nodal path of
  ``fem_block_2d``.
- A singular diagonal block: the reference's inverse carries inf or nan,
  the port's block-Jacobi step leaves those unknowns as they are.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.amg import block_amg as j_bamg
from hypre_tpu.amg.coarsen import coarse_map as j_coarse_map, pmis as j_pmis
from hypre_tpu.amg.strength import strength_mask as j_strength
from hypre_tpu.krylov import gmres as j_gmres, pcg as j_pcg
from hypre_tpu.problems.laplacian import elasticity_2d as j_elasticity
from hypre_tpu.problems.unstructured import fem_block_2d as j_fem_block
from hypre_tpu.seq import bsr as j_bsr
from hypre_tpu.seq.ell import ell_from_dense as j_from_dense, \
    ell_spmv as j_spmv

import hypre_tpu_torch as H
from hypre_tpu_torch.amg import block_amg as t_bamg
from hypre_tpu_torch.amg.coarsen import coarse_map as t_coarse_map, \
    pmis as t_pmis
from hypre_tpu_torch.amg.strength import strength_mask as t_strength
from hypre_tpu_torch.seq import bsr as t_bsr
from hypre_tpu_torch.seq.ell import ell_from_dense
from torch_one_thread import one_torch_thread  # noqa: F401

F64 = dict(dtype=torch.float64, device="cpu")


def rel_close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max(initial=0.0) <= rtol * max(np.abs(b).max(),
                                                        1e-300)


def random_blocks(seed=4, nodes=30, bs=3):
    rng = np.random.default_rng(seed)
    n = nodes * bs
    M = np.where(rng.random((n, n)) < 0.08, rng.standard_normal((n, n)), 0.0)
    M += np.diag(np.abs(M).sum(axis=1) + 1.0)
    return M, bs


@pytest.fixture(scope="module")
def systems():
    """name -> (reference A, port A, block size)."""
    ij, _ = j_fem_block(m=16, seed=0, coupling=0.1)
    tij, _ = H.fem_block_2d(m=16, seed=0, coupling=0.1)
    M, bs = random_blocks()
    return {
        "elasticity-16": (j_elasticity(16, 16), H.elasticity_2d(16, 16, **F64),
                          2),
        "fem_block-16": (ij.get_object(), tij.get_object(**F64), 2),
        "random-bs3": (j_from_dense(M), ell_from_dense(M, device="cpu"), bs),
    }


@pytest.mark.parametrize("name", ["elasticity-16", "fem_block-16",
                                  "random-bs3"])
def test_ell_to_bsr_is_the_reference_layout(systems, name):
    jA, tA, bs = systems[name]
    J, T = j_bsr.ell_to_bsr(jA, bs), t_bsr.ell_to_bsr(tA, bs)
    assert T.n_bcols == J.n_bcols and T.block_size == bs
    assert np.array_equal(T.bcols.numpy(), np.asarray(J.bcols))
    assert np.array_equal(T.bvals.numpy(), np.asarray(J.bvals))
    Je, Te = J.to_ell(), T.to_ell()
    assert np.array_equal(Te.cols.numpy(), np.asarray(Je.cols))
    assert np.array_equal(Te.vals.numpy(), np.asarray(Je.vals))


@pytest.mark.parametrize("name", ["elasticity-16", "random-bs3"])
def test_bsr_products_match(systems, name):
    jA, tA, bs = systems[name]
    J, T = j_bsr.ell_to_bsr(jA, bs), t_bsr.ell_to_bsr(tA, bs)
    x = np.random.default_rng(1).standard_normal(jA.n_rows)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert rel_close(T.mv(tx), J.mv(jx), 1e-13)
    assert rel_close(T.mv(tx), tA.mv(tx), 1e-13)
    assert rel_close(T.block_diagonal(), J.block_diagonal(), 1e-13)
    assert rel_close(T.block_jacobi_precond()(tx),
                     J.block_jacobi_precond()(jx), 1e-13)


def test_bsr_from_numpy_carries_a_reference_matrix(systems):
    jA, tA, _ = systems["elasticity-16"]
    J = j_bsr.ell_to_bsr(jA, 2)
    T = H.bsr_from_numpy(np.asarray(J.bvals), np.asarray(J.bcols), J.n_bcols,
                         device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        jA.n_rows))
    assert T.bcols.dtype == torch.int32
    assert torch.equal(T.mv(x), t_bsr.ell_to_bsr(tA, 2).mv(x))


@pytest.mark.parametrize("mode", ["frobenius", "rowsum"])
def test_nodal_matrix_and_block_direct_interp_match(systems, mode):
    jA, tA, _ = systems["elasticity-16"]
    J, T = j_bsr.ell_to_bsr(jA, 2), t_bsr.ell_to_bsr(tA, 2)
    jN, tN = j_bamg.nodal_norm_matrix(J, mode), t_bamg.nodal_norm_matrix(
        T, mode)
    assert np.array_equal(tN.cols.numpy(), np.asarray(jN.cols))
    assert rel_close(tN.vals, jN.vals, 1e-13)
    jS, tS = j_strength(jN, 0.25), t_strength(tN, 0.25)
    jcf, tcf = j_pmis(jN, jS), t_pmis(tN, tS)
    assert np.array_equal(tcf.numpy(), np.asarray(jcf))
    (jm, jn), (tm, tn) = j_coarse_map(jcf), t_coarse_map(tcf)
    jP = j_bamg.block_direct_interp(J, jS, jcf, jm, int(jn))
    tP = t_bamg.block_direct_interp(T, tS, tcf, tm, int(tn))
    assert tP.n_bcols == jP.n_bcols
    assert np.array_equal(tP.bcols.numpy(), np.asarray(jP.bcols))
    assert rel_close(tP.bvals, jP.bvals, 1e-10)
    with pytest.raises(ValueError, match="nodal mode"):
        t_bamg.nodal_norm_matrix(T, "max")


@pytest.mark.parametrize("name,solver", [("elasticity-16", "pcg"),
                                         ("fem_block-16", "gmres")])
def test_block_amg_takes_the_reference_iterations(systems, name, solver):
    jA, tA, _ = systems[name]
    ja = j_bamg.BlockAMG().setup(j_bsr.ell_to_bsr(jA, 2))
    ta = t_bamg.BlockAMG().setup(t_bsr.ell_to_bsr(tA, 2), device="cpu")
    assert [lv.A.n_rows for lv in ta.levels] == \
        [lv.A.n_rows for lv in ja.levels]
    assert len(ta.levels) >= 2
    for jl, tl in zip(ja.levels, ta.levels):
        assert np.array_equal(tl.P_ell.cols.numpy(), np.asarray(jl.P_ell.cols))
        assert rel_close(tl.P_ell.vals, jl.P_ell.vals, 1e-10)
    assert rel_close(ta.coarse_inv, ja.coarse_inv, 1e-10)
    seed, rtol, maxiter = (0, 1e-8, 120) if solver == "pcg" else (3, 1e-6, 80)
    b = np.random.default_rng(seed).standard_normal(jA.n_rows)
    j_solve, t_solve = (j_pcg, H.pcg) if solver == "pcg" else (j_gmres,
                                                               H.gmres)
    jx, ji = j_solve(lambda v: j_spmv(jA, v), jnp.asarray(b),
                     M=ja.precond(), rtol=rtol, maxiter=maxiter)
    tx, ti = t_solve(tA.mv, torch.from_numpy(b), M=ta.precond(), rtol=rtol,
                     maxiter=maxiter, device="cpu")
    assert bool(ti.converged) and bool(ji.converged)
    assert int(ti.iterations) == int(ji.iterations)
    assert rel_close(tx, jx, 1e-5)


def test_singular_diagonal_block_is_zeroed():
    """A zero diagonal block: the reference's ``jnp.linalg.inv`` carries
    inf or nan into the smoother; the port's inverse is 0 there, and the
    block-Jacobi step leaves that node's unknowns alone."""
    M, bs = random_blocks(nodes=6)
    M[:bs, :] = 0.0
    M[:, :bs] = 0.0
    M[0, bs] = 1.0  # keep the zero block in the pattern
    T = t_bsr.ell_to_bsr(ell_from_dense(M, device="cpu"), bs)
    J = j_bsr.ell_to_bsr(j_from_dense(M), bs)
    assert not np.isfinite(np.asarray(J.block_jacobi_precond()(
        jnp.ones(M.shape[0])))[:bs]).all()
    z = T.block_jacobi_precond()(torch.ones(M.shape[0], dtype=torch.float64))
    assert torch.isfinite(z).all() and torch.equal(z[:bs],
                                                   torch.zeros(bs).double())
    assert rel_close(z[bs:], np.asarray(J.block_jacobi_precond()(
        jnp.ones(M.shape[0])))[bs:], 1e-13)
