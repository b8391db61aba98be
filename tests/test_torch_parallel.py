"""hypre_tpu_torch's parallel layer (halo schedule, ParEllMatrix, the
distributed products) against hypre_tpu's on its 8-device CPU mesh.

The port holds its 8 shards in one process (``make_mesh(8,
device="cpu")``, the local backend); the reference runs them on 8
virtual devices. Each product is held against the reference's own
``par_spmv``/``par_spmv_t`` on the same input, once on the port's
partition and once on the reference's (``convert.par_ell_from_numpy``),
in float64 to 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
from hypre_tpu.core.partition import RowPartition as JRowPartition
from hypre_tpu.ij import IJMatrix as JIJMatrix
from hypre_tpu.parallel import make_mesh as j_make_mesh
from hypre_tpu.parallel import par_ell as j_par
from hypre_tpu.parallel.halo import build_halo_schedule as j_schedule
from hypre_tpu.problems.laplacian import (
    laplacian_2d_5pt as j_lap5, laplacian_3d_7pt as j_lap7,
)
from hypre_tpu.seq.csr import HostCSR as JHostCSR
from hypre_tpu.seq.ell import csr_to_ell as j_csr_to_ell

import hypre_tpu_torch as H
from hypre_tpu_torch.convert import ell_from_numpy, par_ell_from_numpy
from hypre_tpu_torch.core.partition import RowPartition
from hypre_tpu_torch.parallel import (
    ParEllMatrix, make_mesh, par_spmv, par_spmv_t, partition_ell,
)
from hypre_tpu_torch.parallel.halo import build_halo_schedule
from hypre_tpu_torch.parallel.par_ell import collect_vector, distribute_vector
from torch_one_thread import one_torch_thread  # noqa: F401

NSHARDS = 8


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= NSHARDS, "conftest gives 8 devices"
    return j_make_mesh(NSHARDS), make_mesh(NSHARDS, device="cpu")


def random_ell(n, m, density, seed):
    """tests/test_parallel.py's random operator (reference)."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(n * m * density))
    rows, cols = rng.integers(0, n, nnz), rng.integers(0, m, nnz)
    vals = rng.standard_normal(nnz)
    return j_csr_to_ell(JHostCSR.from_coo(rows, cols, vals, (n, m)))


def port_ell(jA):
    return ell_from_numpy(np.asarray(jA.vals), np.asarray(jA.cols), jA.n_cols,
                          device="cpu")


def par_dict(jP):
    """The reference's ParEllMatrix as the numpy dict the port takes."""
    d = {k: np.asarray(getattr(jP, k)) for k in (
        "diag_vals", "diag_cols", "offd_vals", "offd_cols", "send_idx")}
    d.update({k: getattr(jP, k) for k in ("offsets", "sizes", "n_rows",
                                          "n_cols")})
    return d


CASES = {
    "5pt-20x20": lambda: j_lap5(20, 20),
    "unstructured-97": lambda: random_ell(97, 97, 0.08, seed=5),
    "rectangular-60x35": lambda: random_ell(60, 35, 0.1, seed=6),
}


def test_halo_schedule_equals_the_reference():
    # tests/test_parallel.py:160-187: the 1-D partitioned 8 x 8 x 16 7-pt
    # Laplacian needs one plane from each neighbor, no more
    nx = ny = 8
    jA = j_lap7(16, ny, nx)
    part, jpart = RowPartition(jA.n_rows, NSHARDS), \
        JRowPartition(jA.n_rows, NSHARDS)
    cols = np.asarray(jA.cols)
    offd = []
    for p in range(NSHARDS):
        lo, hi = part.row_range(p)
        block = cols[lo:hi]
        offd.append(np.unique(block[(block >= 0)
                                    & ((block // part.n_local) != p)]))
    mine, theirs = build_halo_schedule(offd, part), j_schedule(offd, jpart)
    np.testing.assert_array_equal(mine.send_idx, theirs.send_idx)
    assert (mine.offsets, mine.sizes) == (theirs.offsets, theirs.sizes)
    assert mine.recv_pos == theirs.recv_pos
    assert mine.exchange_bytes(4) == theirs.exchange_bytes(4) \
        == NSHARDS * 2 * nx * ny * 4
    assert set(mine.offsets) == {1, NSHARDS - 1}


@pytest.mark.parametrize("case", list(CASES))
def test_partition_equals_the_references(case, meshes):
    jm, tm = meshes
    jA = CASES[case]()
    mine = partition_ell(port_ell(jA), tm)
    theirs = par_dict(j_par.partition_ell(jA, jm))
    for k in ("diag_vals", "diag_cols", "offd_vals", "offd_cols",
              "send_idx"):
        got = getattr(mine, k).numpy()
        np.testing.assert_array_equal(got.reshape(theirs[k].shape),
                                      theirs[k], err_msg=k)
    assert (mine.offsets, mine.sizes) == (theirs["offsets"],
                                         theirs["sizes"])
    assert mine.exchange_bytes() == j_par.partition_ell(
        jA, jm).exchange_bytes()


@pytest.mark.parametrize("case", list(CASES))
def test_par_spmv_and_transpose_match_the_references(case, meshes):
    jm, tm = meshes
    jA = CASES[case]()
    jP = j_par.partition_ell(jA, jm)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(jA.n_cols)
    r = rng.standard_normal(jA.n_rows)
    want = j_par.collect_vector(
        j_par.par_spmv(jP, j_par.distribute_vector(x, jm)), jA.n_rows)
    want_t = j_par.collect_vector(
        j_par.par_spmv_t(jP, j_par.distribute_vector(r, jm, jA.n_rows)),
        jA.n_cols)
    for tP in (partition_ell(port_ell(jA), tm),
               par_ell_from_numpy(par_dict(jP), tm)):
        assert isinstance(tP, ParEllMatrix)
        y = collect_vector(par_spmv(tP, distribute_vector(x, tm)), jA.n_rows)
        np.testing.assert_allclose(y, want, rtol=1e-12, atol=1e-12)
        yt = collect_vector(tP.mv_t(distribute_vector(r, tm, jA.n_rows)),
                            jA.n_cols)
        np.testing.assert_allclose(yt, want_t, rtol=1e-12, atol=1e-12)


def test_padded_rows_stay_zero(meshes):
    # 100 rows over 8 shards: 4 padding rows, never written
    _, tm = meshes
    jA = random_ell(100, 100, 0.08, seed=11)
    tP = partition_ell(port_ell(jA), tm)
    assert tP.vec_len_rows == 104 and tP.vec_len_cols == 104
    x = distribute_vector(np.ones(100), tm)
    np.testing.assert_array_equal(par_spmv(tP, x).numpy()[100:], 0.0)
    np.testing.assert_array_equal(par_spmv_t(tP, x).numpy()[100:], 0.0)


def test_get_par_object_equals_the_references(meshes):
    jm, tm = meshes
    A = H.laplacian_2d_5pt(12, 12, dtype=torch.float64, device="cpu")
    csr = H.seq.ell.ell_to_csr(A)
    rows = np.repeat(np.arange(A.n_rows), np.diff(csr.indptr))

    def assembled(ij_cls):
        return ij_cls(A.n_rows, A.n_rows).set_values(
            rows, csr.indices, csr.data).assemble()

    P = assembled(H.IJMatrix).get_par_object(tm, dtype=torch.float64)
    assert isinstance(P, ParEllMatrix) and P.num_shards == NSHARDS
    x = np.random.default_rng(1).standard_normal(A.n_rows)
    y = collect_vector(par_spmv(P, distribute_vector(x, tm)), A.n_rows)
    np.testing.assert_allclose(y, A.mv(torch.from_numpy(x)).numpy(),
                               rtol=1e-12, atol=1e-12)
    theirs = par_dict(assembled(JIJMatrix).get_par_object(jm))
    for k in ("diag_vals", "diag_cols", "offd_vals", "offd_cols"):
        got = getattr(P, k).numpy()
        np.testing.assert_array_equal(got.reshape(theirs[k].shape),
                                      theirs[k], err_msg=k)


def test_one_shard_has_no_halo(meshes):
    A = H.laplacian_2d_5pt(9, 9, dtype=torch.float64, device="cpu")
    P = partition_ell(A, make_mesh(1, device="cpu"))
    assert P.sizes == () and P.offsets == ()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(81))
    torch.testing.assert_close(P.mv(x), A.mv(x), rtol=1e-14, atol=1e-14)
    torch.testing.assert_close(P.mv_t(x), A.mv_t(x), rtol=1e-14, atol=1e-14)


def test_distributed_pcg_matches_the_single_device_solve(meshes):
    # tests/test_parallel.py's TestDistributedSolve on the port
    _, tm = meshes
    A = H.laplacian_3d_7pt(8, 8, 8, dtype=torch.float64, device="cpu")
    P = partition_ell(A, tm)
    b = distribute_vector(np.ones(512), tm)
    x, info = H.pcg(P.mv, b, rtol=1e-10, device="cpu")
    x1, info1 = H.pcg(A.mv, torch.ones(512, dtype=torch.float64), rtol=1e-10,
                      device="cpu")
    assert bool(info.converged)
    assert int(info.iterations) == int(info1.iterations)
    np.testing.assert_allclose(collect_vector(x, 512), x1.numpy(), rtol=1e-8,
                               atol=1e-10)
