"""hypre_tpu_torch's smoothed aggregation and GSMG against hypre_tpu's, in
float64 on the CPU, and the facade's ``_do_setup`` hook they use.

- The greedy aggregates are the reference's exactly (2-D 5-pt 32², 3-D
  7-pt 12³): the port builds the same neighbour sets by the same
  insertions, so their iteration order, which decides where a straggler
  goes, is the same.
- P0 for nb = 1, 2 and 3 (with its coarse near-nullspace) and the smoothed
  P match to 1e-12; GSMG's smooth vectors to 1e-12 and its least-squares
  interpolation to 1e-8, with the reference's pattern.
- SmoothedAggAMG (constants; a two-column null space; a given fine
  aggregation, ``agg0``) and GSMG build the reference's level sizes and
  take its iterations on the reference tests' problems
  (tests/test_amg2.py:171-199, tests/test_misc_components.py:145).
- The default BoomerAMG builds through ``_do_setup`` exactly the
  hierarchy that ``setup_hierarchy`` + ``optimize_hierarchy`` build, and
  the subclasses get the facade's optimize, CG-weight, Chebyshev and cycle
  behaviour.

The reference's facade setups are made once per module and shared.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.amg import gsmg as j_gsmg, smoothed_agg as j_sa
from hypre_tpu.amg.coarsen import coarse_map as j_coarse_map, pmis as j_pmis
from hypre_tpu.amg.strength import strength_mask as j_strength
from hypre_tpu.krylov import pcg as j_pcg
from hypre_tpu.problems.laplacian import laplacian_2d_5pt as j_lap5, \
    laplacian_3d_7pt as j_lap7
from hypre_tpu.seq.ell import ell_spmv as j_spmv

import hypre_tpu_torch as H
from hypre_tpu_torch.amg import gsmg as t_gsmg, smoothed_agg as t_sa
from hypre_tpu_torch.amg.coarsen import coarse_map as t_coarse_map, \
    pmis as t_pmis
from hypre_tpu_torch.amg.strength import strength_mask as t_strength
from torch_one_thread import one_torch_thread  # noqa: F401

F64 = dict(dtype=torch.float64, device="cpu")
PROBLEMS = {
    "5pt-32": (lambda: j_lap5(32, 32), lambda: H.laplacian_2d_5pt(32, 32,
                                                                  **F64)),
    "7pt-12": (lambda: j_lap7(12, 12, 12),
               lambda: H.laplacian_3d_7pt(12, 12, 12, **F64)),
}


def rel_close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max(initial=0.0) <= rtol * max(np.abs(b).max(),
                                                        1e-300)


def sizes(hier):
    return [lv.A.n_rows for lv in hier.levels] + [hier.coarse_inv.shape[0]]


@pytest.fixture(scope="module")
def graphs():
    """(jax A, port A, aggregation of each) per problem."""
    out = {}
    for name, (jf, tf) in PROBLEMS.items():
        jA, tA = jf(), tf()
        jagg = j_sa.aggregate(jA, j_strength(jA, 0.25))
        tagg = t_sa.aggregate(tA, t_strength(tA, 0.25))
        out[name] = (jA, tA, jagg, tagg)
    return out


@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_aggregates_are_the_reference_aggregates(graphs, problem):
    _, tA, (jagg, jn), (tagg, tn) = graphs[problem]
    assert tn == jn and np.array_equal(tagg, jagg)
    # every node is covered, and aggregation coarsens
    assert tagg.min() == 0 and tagg.max() == tn - 1
    assert tn < tA.n_rows // 3


def test_aggregates_follow_set_iteration_order():
    """On a random graph whose neighbour sets do not iterate in ascending
    order (ints above a set's table size), the aggregates are still the
    reference's: the port must build, not sort, the sets."""
    from hypre_tpu.seq.ell import ell_from_dense as j_from_dense

    from hypre_tpu_torch.seq.ell import ell_from_dense

    rng = np.random.default_rng(3)
    n = 300
    M = np.zeros((n, n))
    for i in range(n):
        for j in rng.choice(n, size=3, replace=False):
            if j != i:
                M[i, j] = M[j, i] = -rng.uniform(0.5, 1.5)
    M[np.arange(n), np.arange(n)] = -M.sum(axis=1) + 0.1
    jA, tA = j_from_dense(M), ell_from_dense(M, device="cpu")
    nbr = t_sa.strength_graph(tA, t_strength(tA, 0.25))
    assert any(list(s) != sorted(s) for s in nbr)
    jagg, jn = j_sa.aggregate(jA, j_strength(jA, 0.25))
    tagg, tn = t_sa.aggregate(tA, t_strength(tA, 0.25))
    assert tn == jn and np.array_equal(tagg, jagg)


@pytest.mark.parametrize("nb", [1, 2, 3])
def test_tentative_prolongator_matches(graphs, nb):
    jA, _, (jagg, jn), _ = graphs["5pt-32"]
    B = np.random.default_rng(nb).standard_normal((jA.n_rows, nb))
    if nb == 1:
        B = np.abs(B) + 0.5
    jP, jBc = j_sa.tentative_prolongator(jagg, jn, jnp.asarray(B))
    tP, tBc = t_sa.tentative_prolongator(jagg, jn, torch.from_numpy(B))
    assert tP.n_cols == jP.n_cols
    assert np.array_equal(tP.cols.numpy(), np.asarray(jP.cols))
    assert rel_close(tP.vals, jP.vals, 1e-12)
    assert rel_close(tBc, jBc, 1e-12)


def test_smoothed_prolongator_matches(graphs):
    jA, tA, (jagg, jn), _ = graphs["7pt-12"]
    ones = np.ones((jA.n_rows, 1))
    jP = j_sa.smooth_prolongator(
        jA, j_sa.tentative_prolongator(jagg, jn, jnp.asarray(ones))[0])
    tP = t_sa.smooth_prolongator(
        tA, t_sa.tentative_prolongator(jagg, jn, torch.from_numpy(ones))[0])
    assert np.array_equal(tP.cols.numpy(), np.asarray(jP.cols))
    assert rel_close(tP.vals, jP.vals, 1e-12)


@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_gsmg_smooth_vectors_and_ls_interp_match(graphs, problem):
    jA, tA, _, _ = graphs[problem]
    jV, tV = j_gsmg.smooth_vectors(jA), t_gsmg.smooth_vectors(tA)
    assert rel_close(tV, jV, 1e-12)
    jS, tS = j_strength(jA, 0.25), t_strength(tA, 0.25)
    jcf, tcf = j_pmis(jA, jS), t_pmis(tA, tS)
    assert np.array_equal(tcf.numpy(), np.asarray(jcf))
    (jm, jn), (tm, tn) = j_coarse_map(jcf), t_coarse_map(tcf)
    jP = j_gsmg.ls_interp(jA, jS, jcf, jm, int(jn), jV)
    tP = t_gsmg.ls_interp(tA, tS, tcf, tm, int(tn), tV)
    assert tP.n_cols == jP.n_cols
    assert np.array_equal(tP.cols.numpy(), np.asarray(jP.cols))
    assert rel_close(tP.vals, jP.vals, 1e-8)


@pytest.fixture(scope="module")
def sa_runs():
    """The reference tests' SA and GSMG problems, set up once by each
    package: name -> (reference object, port object, A, b, solve)."""
    jA = j_lap5(32, 32)
    tA = H.laplacian_2d_5pt(32, 32, **F64)
    b = np.ones(jA.n_rows)
    out = {"sa": (j_sa.SmoothedAggAMG(max_coarse_size=20).setup(jA),
                  H.SmoothedAggAMG(max_coarse_size=20).setup(tA,
                                                             device="cpu"),
                  jA, tA, b, "solve")}
    jagg = j_sa.aggregate(jA, j_strength(jA, 0.25))
    out["sa-agg0"] = (
        j_sa.SmoothedAggAMG(max_coarse_size=20, agg0=jagg).setup(jA),
        H.SmoothedAggAMG(max_coarse_size=20, agg0=jagg).setup(
            tA, device="cpu"), jA, tA, b, "solve")
    jg = j_gsmg.GSMG(max_coarse_size=64)
    jg.setup(jA, optimize=False)
    out["gsmg"] = (jg, t_gsmg.GSMG(max_coarse_size=64).setup(tA,
                                                             device="cpu"),
                   jA, tA, b, "pcg")
    jA, tA = j_lap5(24, 24), H.laplacian_2d_5pt(24, 24, **F64)
    B = np.stack([np.ones(jA.n_rows), np.arange(jA.n_rows) / jA.n_rows], 1)
    out["sa-null-space"] = (
        j_sa.SmoothedAggAMG(max_coarse_size=20,
                            null_space=jnp.asarray(B)).setup(jA),
        H.SmoothedAggAMG(max_coarse_size=20,
                         null_space=torch.from_numpy(B)).setup(
            tA, device="cpu"), jA, tA, np.ones(jA.n_rows), "solve")
    return out


@pytest.mark.parametrize("name", ["sa", "sa-agg0", "sa-null-space", "gsmg"])
def test_hierarchy_and_iterations_match(sa_runs, name):
    ja, ta, jA, tA, b, how = sa_runs[name]
    assert sizes(ta.hierarchy) == sizes(ja.hierarchy)
    for jl, tl in zip(ja.hierarchy.levels, ta.hierarchy.levels):
        assert np.array_equal(tl.P.cols.numpy(), np.asarray(jl.P.cols))
        assert rel_close(tl.P.vals, jl.P.vals, 1e-10)
    if how == "solve":
        jx, ji = ja.solve(jnp.asarray(b), rtol=1e-8, maxiter=60)
        tx, ti = ta.solve(torch.from_numpy(b), rtol=1e-8, maxiter=60)
    else:
        jx, ji = j_pcg(lambda v: j_spmv(jA, v), jnp.asarray(b),
                       M=ja.precond(), rtol=1e-8, maxiter=60)
        tx, ti = H.pcg(tA.mv, torch.from_numpy(b), M=ta.precond(),
                       rtol=1e-8, maxiter=60, device="cpu")
    assert bool(ti.converged) and bool(ji.converged)
    assert int(ti.iterations) == int(ji.iterations)
    assert rel_close(tx, jx, 1e-6)


def test_agg0_must_cover_the_fine_level():
    A = H.laplacian_2d_5pt(8, 8, **F64)
    with pytest.raises(ValueError, match="agg0"):
        H.SmoothedAggAMG(max_coarse_size=10,
                         agg0=(np.zeros(10, np.int64), 1)).setup(
            A, device="cpu")


def test_default_facade_builds_the_hierarchy_setup_hierarchy_builds():
    """The _do_setup split keeps the default BoomerAMG's hierarchy: the
    pure setup with the facade's knobs, then the kernel formats."""
    A = H.laplacian_3d_7pt(16, 16, 16, **F64)
    amg = H.BoomerAMG(max_coarse_size=50).setup(A, optimize=True,
                                                device="cpu")
    want = H.optimize_hierarchy(H.setup_hierarchy(
        A, max_row_sum=0.9, max_coarse_size=50, device="cpu"),
        prefer_pallas=True, device="cpu")
    assert len(amg.hierarchy.levels) == len(want.levels)
    for got, exp in zip(amg.hierarchy.levels, want.levels):
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(exp, f.name)
            assert type(a) is type(b)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
    assert torch.equal(amg.hierarchy.coarse_inv, want.coarse_inv)


@pytest.mark.parametrize("cls", [H.SmoothedAggAMG, t_gsmg.GSMG])
def test_subclasses_get_the_facade_steps(cls):
    """Through the hook, SA and GSMG hierarchies are optimized (banded
    levels on the CPU with optimize=True), get CG-estimated Jacobi weights
    and run the facade's W-cycle."""
    from hypre_tpu_torch.seq import fastmv

    A = H.laplacian_2d_5pt(48, 48, **F64)
    b = torch.ones(A.n_rows, dtype=torch.float64)
    amg = cls(max_coarse_size=30, relax="jacobi", relax_weight=-10.0,
              cycle_type=2).setup(A, device="cpu")
    assert all(lv.rw is not None for lv in amg.hierarchy.levels)
    x, info = H.pcg(A.mv, b, M=amg.precond(), rtol=1e-8, maxiter=100,
                    device="cpu")
    assert bool(info.converged)
    # the banded formats are float32
    A = H.laplacian_2d_5pt(48, 48, dtype=torch.float32, device="cpu")
    b = b.float()
    saved = fastmv.MIN_BANDED_ELEMENTS
    fastmv.MIN_BANDED_ELEMENTS = 0
    try:
        fast = cls(max_coarse_size=30).setup(A, optimize=True, device="cpu")
    finally:
        fastmv.MIN_BANDED_ELEMENTS = saved
    assert any(isinstance(lv.A, fastmv.BandedEll)
               for lv in fast.hierarchy.levels)
    plain = cls(max_coarse_size=30).setup(A, device="cpu")
    xf, i_f = H.pcg(A.mv, b, M=fast.precond(), rtol=1e-6, device="cpu")
    xp, i_p = H.pcg(A.mv, b, M=plain.precond(), rtol=1e-6, device="cpu")
    assert int(i_f.iterations) == int(i_p.iterations)
    assert rel_close(xf, xp, 1e-5)
