"""hypre_tpu_torch's IJ assembly and file IO against hypre_tpu's, on the
CPU: the reference's own cases (tests/test_ij_io.py) run through both
packages, the assembled CSR of the same staged sequence is the same bit
for bit, and files written by either package load in the other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu import io as jio
from hypre_tpu.ij import IJMatrix as JIJMatrix, IJVector as JIJVector
from hypre_tpu.krylov import pcg as j_pcg
from hypre_tpu.problems.laplacian import laplacian_2d_5pt as j_lap5
from hypre_tpu.seq.csr import HostCSR as JHostCSR
from hypre_tpu.seq.ell import ell_from_dense as j_ell_from_dense, \
    ell_to_csr as j_ell_to_csr

import hypre_tpu_torch as H
from hypre_tpu_torch import io as tio
from hypre_tpu_torch.seq.csr import HostCSR
from hypre_tpu_torch.seq.ell import ell_from_dense, ell_to_csr
from torch_one_thread import one_torch_thread  # noqa: F401


def same_csr(t, j):
    assert t.shape == j.shape
    assert np.array_equal(t.indptr, j.indptr)
    assert np.array_equal(t.indices, j.indices)
    assert np.array_equal(t.data, j.data)


def both(fn):
    """Run one staging sequence on a port and on a reference IJMatrix."""
    out = []
    for cls in (H.IJMatrix, JIJMatrix):
        m = cls(3, 3)
        fn(m)
        out.append(m.assemble().get_csr())
    return out


def test_set_then_add_accumulates():
    t, j = both(lambda m: (m.set_values([0], [0], [2.0]),
                           m.add_to_values([0], [0], [1.5])))
    same_csr(t, j)
    assert t.to_dense()[0, 0] == 3.5


def test_add_then_set_overwrites():
    t, j = both(lambda m: (m.add_to_values([1], [2], [5.0]),
                           m.set_values([1], [2], [2.0]),
                           m.add_to_values([1], [2], [0.5])))
    same_csr(t, j)
    # the set wipes the earlier add; the later add accumulates
    assert t.to_dense()[1, 2] == 2.5


@pytest.mark.parametrize("rows,cols", [([3], [0]), ([0], [3]), ([-1], [0])])
def test_out_of_range_raises(rows, cols):
    for cls in (H.IJMatrix, JIJMatrix):
        with pytest.raises(ValueError):
            cls(3, 3).set_values(rows, cols, [1.0])


def test_random_staged_sequence_assembles_the_reference_csr():
    """Interleaved sets and adds with many repeats of each (row, col):
    the latest set drops what came before it, the rest sum in staging
    order; the sums are bit-equal to the reference's."""
    rng = np.random.default_rng(4)
    t, j = H.IJMatrix(40, 30), JIJMatrix(40, 30)
    for _ in range(25):
        k = int(rng.integers(1, 60))
        r, c = rng.integers(0, 40, k), rng.integers(0, 30, k)
        v = rng.standard_normal(k) * 10.0 ** rng.uniform(-8, 8, k)
        op = "set_values" if rng.random() < 0.3 else "add_to_values"
        getattr(t, op)(r, c, v)
        getattr(j, op)(r, c, v)
    same_csr(t.assemble().get_csr(), j.assemble().get_csr())
    A = t.get_object(dtype=torch.float64, device="cpu")
    assert np.array_equal(ell_to_csr(A).data, j.get_csr().data)


def test_ex5_style_laplacian():
    """The 1-D Laplacian assembled row by row as examples/ex5.c does, then
    PCG; the port's x equals the reference's and the dense solve."""
    n = 32
    t, j = H.IJMatrix(n, n), JIJMatrix(n, n)
    for i in range(n):
        cols, vals = [i], [2.0]
        if i > 0:
            cols.append(i - 1), vals.append(-1.0)
        if i < n - 1:
            cols.append(i + 1), vals.append(-1.0)
        t.set_values([i] * len(cols), cols, vals)
        j.set_values([i] * len(cols), cols, vals)
    tA = t.assemble().get_object(dtype=torch.float64, device="cpu")
    jA = j.assemble().get_object(dtype=jnp.float64)
    same_csr(ell_to_csr(tA), j_ell_to_csr(jA))
    tb = H.IJVector(n).set_values(np.arange(n), np.ones(n)).assemble() \
        .get_object(dtype=torch.float64, device="cpu")
    jb = JIJVector(n).set_values(np.arange(n), np.ones(n)).assemble() \
        .get_object()
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    tx, ti = H.pcg(tA.mv, tb, rtol=1e-10, device="cpu")
    jx, ji = j_pcg(jA.mv, jb, rtol=1e-10)
    assert bool(ti.converged) and int(ti.iterations) == int(ji.iterations)
    want = np.linalg.solve(ell_to_csr(tA).to_dense(), np.ones(n))
    np.testing.assert_allclose(tx.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12)


def test_ij_vector_add_and_dtype():
    v = H.IJVector(5).set_values([0, 1], [1.0, 2.0]).add_to_values(
        [1, 1, 4], [0.5, 0.25, 3.0])
    assert v.get_object(device="cpu").dtype == torch.float32
    got = v.get_object(dtype=torch.float64, device="cpu")
    assert got.tolist() == [1.0, 2.75, 0.0, 0.0, 3.0]


def test_get_par_object_names_the_parallel_layer():
    # the parallel layer's ParEllMatrix, split over the mesh's shards
    from hypre_tpu_torch.parallel import ParEllMatrix, make_mesh

    m = H.IJMatrix(2, 2).set_values([0, 1], [0, 1], [1.0, 4.0]).assemble()
    P = m.get_par_object(make_mesh(2, device="cpu"), dtype=torch.float64)
    assert isinstance(P, ParEllMatrix)
    assert (P.num_shards, P.n_rows, P.n_cols) == (2, 2, 2)
    y = P.mv(torch.tensor([3.0, 0.5], dtype=torch.float64))
    assert y.tolist() == [3.0, 2.0]


def test_get_csr_before_assemble_raises():
    with pytest.raises(RuntimeError):
        H.IJMatrix(2, 2).get_csr()


def _random_dense(seed, shape=(7, 5), density=0.4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) * (rng.random(shape) < density)


def test_matrix_market_roundtrip(tmp_path):
    M = _random_dense(0)
    p = str(tmp_path / "m.mtx")
    tio.write_matrix_market(p, ell_from_dense(M, device="cpu"))
    np.testing.assert_array_equal(tio.read_matrix_market(p).to_dense(), M)


def test_matrix_market_symmetric(tmp_path):
    p = str(tmp_path / "s.mtx")
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n")
        f.write("% comment line\n")
        f.write("3 3 4\n1 1 2.0\n2 1 -1.0\n2 2 2.0\n3 3 1.0\n")
    A = tio.read_matrix_market(p)
    same_csr(A, jio.read_matrix_market(p))
    want = np.array([[2.0, -1.0, 0], [-1.0, 2.0, 0], [0, 0, 1.0]])
    np.testing.assert_array_equal(A.to_dense(), want)


def test_ij_ascii_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    dense = np.where(rng.random((7, 7)) < 0.4, rng.standard_normal((7, 7)),
                     0.0)
    r, c = np.nonzero(dense)
    A = HostCSR.from_coo(r, c, dense[r, c], (7, 7))
    for base in (0, 1):
        p = str(tmp_path / f"mat.IJ.{base}.00000")
        tio.write_ij_ascii(p, A, base=base)
        B = tio.read_ij_ascii(p)
        np.testing.assert_allclose(B.to_dense(), dense, rtol=1e-13)
        # content dispatch picks the IJ parser (no MatrixMarket header)
        same_csr(tio.read_any_matrix(p), B)


def test_npz_roundtrip_and_vectors(tmp_path):
    A = H.laplacian_2d_5pt(6, 6, dtype=torch.float64, device="cpu")
    p = str(tmp_path / "a.npz")
    tio.save_matrix(p, A)
    B = tio.load_matrix(p, device="cpu")
    assert torch.equal(A.vals, B.vals) and torch.equal(A.cols, B.cols)
    C = tio.load_matrix(p, dtype=torch.float32, device="cpu")
    assert C.vals.dtype == torch.float32
    same_csr(tio.read_any_matrix(p), ell_to_csr(A))
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(36))
    q = str(tmp_path / "v.npz")
    tio.save_vector(q, v)
    assert torch.equal(tio.load_vector(q, device="cpu"), v)


@pytest.mark.parametrize("fmt", ["mtx", "ij", "npz"])
def test_files_cross_between_packages(tmp_path, fmt):
    """The reference writes and the port reads, and the other way round:
    the same CSR either way."""
    M = _random_dense(7, shape=(9, 9), density=0.35) + np.eye(9)
    t_ell = ell_from_dense(M, device="cpu")
    j_ell = j_ell_from_dense(M)
    writers = {"mtx": (tio.write_matrix_market, jio.write_matrix_market),
               "ij": (tio.write_ij_ascii, jio.write_ij_ascii),
               "npz": (tio.save_matrix, jio.save_matrix)}
    t_write, j_write = writers[fmt]
    suffix = ".npz" if fmt == "npz" else ".txt"
    pt, pj = str(tmp_path / f"port{suffix}"), str(tmp_path / f"ref{suffix}")
    t_write(pt, t_ell)
    j_write(pj, j_ell)
    # each package reads the other's file
    port_reads_ref = tio.read_any_matrix(pj)
    ref_reads_port = jio.read_any_matrix(pt)
    same_csr(port_reads_ref, jio.read_any_matrix(pj))
    same_csr(ref_reads_port, tio.read_any_matrix(pt))
    tol = 1e-13 if fmt == "ij" else 0.0
    np.testing.assert_allclose(port_reads_ref.to_dense(), M, rtol=tol)
    np.testing.assert_allclose(ref_reads_port.to_dense(), M, rtol=tol)
    if fmt == "npz":
        B = tio.load_matrix(pj, device="cpu")
        assert np.array_equal(B.vals.numpy(), np.asarray(j_ell.vals))
        jB = jio.load_matrix(pt)
        assert np.array_equal(np.asarray(jB.vals), t_ell.vals.numpy())


def test_reference_readers_take_a_host_csr(tmp_path):
    """The writers take a HostCSR as well as an EllMatrix, as the
    reference's do."""
    A = ell_to_csr(H.laplacian_2d_5pt(4, 5, dtype=torch.float64,
                                      device="cpu"))
    p = str(tmp_path / "a.mtx")
    tio.write_matrix_market(p, A)
    jA = JHostCSR(A.indptr, A.indices, A.data, A.shape)
    q = str(tmp_path / "b.mtx")
    jio.write_matrix_market(q, jA)
    assert open(p).read() == open(q).read()
    same_csr(tio.read_matrix_market(p), j_ell_to_csr(j_lap5(4, 5)))
