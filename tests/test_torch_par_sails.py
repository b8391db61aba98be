"""hypre_tpu_torch's distributed ParaSails (``precond/par_sails.py``)
against hypre_tpu's on its 8-device CPU mesh, in float64.

Levels 0 (with and without the prune threshold) and 1 (the pattern of
A^2 through the second halo layer) are set up on the same 24^2 and 16^2
Laplacians partitioned over 8 shards; the applies on one numpy-seeded
vector must equal the reference's to 1e-10. The reference's PCG runs
with these preconditioners (over ``par_spmv`` on its 8-device mesh, rtol
1e-8, b = ones) cost 5-13 s of XLA compile each, so their counts are
recorded below.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypre_tpu.parallel import make_mesh as j_make_mesh
from hypre_tpu.parallel import partition_ell as j_partition
from hypre_tpu.parallel.par_ell import collect_vector as j_collect
from hypre_tpu.parallel.par_ell import distribute_vector as j_distribute
from hypre_tpu.precond import par_sails as J
from hypre_tpu.problems.laplacian import laplacian_2d_5pt as j_lap5

import hypre_tpu_torch as H
from hypre_tpu_torch.convert import ell_from_numpy
from hypre_tpu_torch.parallel import make_mesh, partition_ell
from hypre_tpu_torch.parallel.par_ell import collect_vector, distribute_vector
from hypre_tpu_torch.precond import par_sails as T
from torch_one_thread import one_torch_thread  # noqa: F401

NSHARDS = 8
KNOBS = {"level 0": (24, {}), "level 0, thresh 0.1": (24, dict(thresh=0.1)),
         "level 1": (16, dict(nlevels=1, pattern_cap=32))}
# the reference's PCG iterations on the 24^2 Laplacian (module docstring)
REFERENCE_ITERATIONS = {"level 0": 37, "level 1": 30, "diagonal": 44}


def problem(n):
    jA = j_lap5(n, n)
    tA = ell_from_numpy(np.asarray(jA.vals), np.asarray(jA.cols), jA.n_cols,
                        device="cpu")
    return jA, tA


@pytest.fixture(scope="module")
def ref():
    """The reference's applies, one per case, and the vectors."""
    jm = j_make_mesh(NSHARDS)
    out = {}
    for key, (n, kw) in KNOBS.items():
        jA, _ = problem(n)
        r = np.random.default_rng(5).standard_normal(jA.n_rows)
        obj = J.ParSails(**kw).setup(j_partition(jA, jm))
        out[key] = j_collect(obj.precond()(j_distribute(jnp.asarray(r), jm)),
                             jA.n_rows)
    return out


def nnz(P) -> int:
    return int((P.diag_cols >= 0).sum() + (P.offd_cols >= 0).sum())


@pytest.mark.parametrize("key", sorted(KNOBS))
def test_par_sails_apply_equals_the_reference(ref, key):
    n, kw = KNOBS[key]
    _, tA = problem(n)
    mesh = make_mesh(NSHARDS, device="cpu")
    r = np.random.default_rng(5).standard_normal(tA.n_rows)
    ps = T.ParSails(**kw).setup(partition_ell(tA, mesh))
    z = collect_vector(ps.precond()(distribute_vector(r, mesh)), tA.n_rows)
    np.testing.assert_allclose(z, ref[key], rtol=1e-10,
                               atol=1e-10 * np.abs(ref[key]).max())
    if kw.get("nlevels"):
        # the level-1 pattern is wider than A's
        assert nnz(ps.M) > nnz(partition_ell(tA, mesh))


def pcg_iterations(M, Ap, mesh, n) -> int:
    b = distribute_vector(np.ones(n), mesh)
    _, info = H.pcg(Ap.mv, b, M=M, rtol=1e-8, maxiter=300, device="cpu")
    assert bool(info.converged)
    return int(info.iterations)


def test_pcg_takes_the_reference_iterations_and_level_1_beats_diagonal():
    # tests/test_multihost.py:200-231, 350-377
    _, tA = problem(24)
    mesh = make_mesh(NSHARDS, device="cpu")
    Ap = partition_ell(tA, mesh)
    got = {"level 0": T.ParSails().setup(Ap).precond(),
           "level 1": T.ParSails(nlevels=1, pattern_cap=32).setup(
               Ap).precond(),
           "diagonal": lambda r: 0.25 * r}
    got = {k: pcg_iterations(M, Ap, mesh, tA.n_rows) for k, M in got.items()}
    assert got == REFERENCE_ITERATIONS
    assert got["level 1"] < got["diagonal"]


def test_level_1_one_shard_equals_eight():
    # the 8-shard build, whose rows need A's rows at graph distance 2,
    # acts as the same algorithm on one shard
    _, tA = problem(16)
    r = np.random.default_rng(7).standard_normal(tA.n_rows)
    z = []
    for P in (1, NSHARDS):
        mesh = make_mesh(P, device="cpu")
        ps = T.ParSails(nlevels=1, pattern_cap=32).setup(
            partition_ell(tA, mesh))
        z.append(collect_vector(ps.precond()(distribute_vector(r, mesh)),
                                tA.n_rows))
    np.testing.assert_allclose(z[1], z[0], rtol=1e-10, atol=1e-12)


def test_filter_keeps_the_diagonal_and_drops_small_entries():
    # hypre's ParaSails filter: |m_ij| < filter * max_j |m_ij| dropped
    _, tA = problem(16)
    Ap = partition_ell(tA, make_mesh(NSHARDS, device="cpu"))
    M0 = T.ParSails(nlevels=1, pattern_cap=32).setup(Ap).M
    M1 = T.ParSails(nlevels=1, pattern_cap=32, filter=0.1).setup(Ap).M
    rows = torch.arange(M1.n_row_local)[None, :, None]
    diag = (M1.diag_cols == rows) & (M1.diag_cols >= 0)
    assert torch.equal(torch.where(diag, M1.diag_vals, 0.0),
                       torch.where(diag, M0.diag_vals, 0.0))
    kept = lambda M: int((M.diag_vals != 0).sum() + (M.offd_vals != 0).sum())
    assert kept(M1) < kept(M0)
