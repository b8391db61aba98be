"""hypre_tpu_torch's auxiliary-space Maxwell solvers (AMS, ADS, AME) and
the vectorized de Rham generators against hypre_tpu's, in float64 on the
CPU.

- ``problems.maxwell`` builds exactly the matrices of the reference tests'
  loop-and-dense helpers (tests/test_mgr_ams.py:70-121,
  tests/test_ads.py:13-97 and the div-div operator of
  tests/test_ads.py:115-119).
- AMS: the Pi matrices, A_G = G^T A G and A_Pi = Pi^T A Pi match the
  reference's (whose products run in its C++ CSR kernels) to 1e-12; PCG
  takes the reference's iterations with the "01210" and the additive
  cycle (tests/test_mgr_ams.py:124).
- ADS: the face weights, normals and Pi match to 1e-12; PCG takes the
  reference's iterations (tests/test_ads.py:110).
- AME: the eigenvalues of both solve paths (LOBPCG in the operator's
  type; the float64 outer loop over a float32 operator) match to 1e-6
  (tests/test_misc_components.py:28 and its float32 variant).

The reference's inner BoomerAMGs get ``setup_backend="jax"`` (its
default picks the C++ setup). Its setups are made once per module.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu import native as j_native
from hypre_tpu.amg import ams as j_ams
from hypre_tpu.amg.ads import ADS as JADS
from hypre_tpu.amg.ame import AME as JAME
from hypre_tpu.krylov import pcg as j_pcg
from hypre_tpu.seq.ell import EllMatrix as JEll, csr_to_ell as j_csr_to_ell, \
    ell_from_dense as j_from_dense, ell_spmv as j_spmv, \
    ell_to_csr as j_ell_to_csr

import hypre_tpu_torch as H
from hypre_tpu_torch.amg.ads import ADS, face_node_pi
from hypre_tpu_torch.amg.ame import AME
from hypre_tpu_torch.amg.ams import AMS, rap_f64
from hypre_tpu_torch.problems import maxwell
from hypre_tpu_torch.seq.ell import ell_to_csr
from test_ads import _hex_grid_complex
from test_mgr_ams import _curl_curl_2d
from torch_one_thread import one_torch_thread  # noqa: F401

F64 = dict(dtype=torch.float64, device="cpu")
J_KNOBS = dict(max_coarse_size=64, setup_backend="jax")
T_KNOBS = J_KNOBS  # the port's inner BoomerAMGs, held against those


def rel_close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max(initial=0.0) <= rtol * max(np.abs(b).max(),
                                                        1e-300)


def same_matrix(t, j, rtol=0.0):
    """Port ELL and reference ELL: the same CSR pattern, values to rtol
    (exact at 0)."""
    tc, jc = ell_to_csr(t), j_ell_to_csr(j)
    assert tc.shape == jc.shape
    assert np.array_equal(tc.indptr, jc.indptr)
    assert np.array_equal(tc.indices, jc.indices)
    if rtol == 0.0:
        assert np.array_equal(tc.data, jc.data)
    else:
        assert rel_close(tc.data, jc.data, rtol)


def same_csr(t, j):
    assert t.shape == j.shape
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(t, f), getattr(j, f)), f


def ref_div_div(n, beta=0.01, seed=0):
    """tests/test_ads.py's rough div-div operator, densely."""
    D, C, G, coords = _hex_grid_complex(n)
    rng = np.random.default_rng(seed)
    Dd = D.to_dense()
    cc = np.exp(rng.standard_normal(D.shape[0]) * 2.0)
    mm = np.exp(rng.standard_normal(D.shape[1]) * 2.0)
    A = j_from_dense(Dd.T @ (cc[:, None] * Dd) + beta * np.diag(mm))
    return A, j_csr_to_ell(C), j_csr_to_ell(G), coords


@pytest.mark.parametrize("nx,ny", [(10, 10), (7, 5)])
def test_curl_curl_2d_is_the_reference_helper(nx, ny):
    jA, jG, jxy = _curl_curl_2d(nx, ny, beta=0.01)
    tA, tG, txy = maxwell.curl_curl_2d(nx, ny, beta=0.01, **F64)
    same_matrix(tA, jA)
    same_matrix(tG, jG)
    assert np.array_equal(txy, jxy)


@pytest.mark.parametrize("n", [3, 4])
def test_hex_complex_is_the_reference_helper(n):
    for t, j in zip(maxwell.hex_complex(n)[:3], _hex_grid_complex(n)[:3]):
        same_csr(t, j)
    assert np.array_equal(maxwell.hex_complex(n)[3], _hex_grid_complex(n)[3])
    D, C, G, _ = maxwell.hex_complex(n)
    assert not (D.to_dense() @ C.to_dense()).any()
    assert not (C.to_dense() @ G.to_dense()).any()


def test_curl_curl_and_div_div_3d_are_the_reference_operators():
    jA, jC, jG, _ = ref_div_div(4)
    tA, tC, tG, _ = maxwell.div_div_3d(4, **F64)
    same_matrix(tA, jA)
    same_matrix(tC, jC)
    same_matrix(tG, jG)
    _, C, _, _ = _hex_grid_complex(4)
    Cd = C.to_dense()
    A = maxwell.curl_curl_3d(4, beta=0.01, **F64)[0]
    same_matrix(A, j_from_dense(Cd.T @ Cd + 0.01 * np.eye(Cd.shape[1])))


@pytest.fixture(scope="module")
def ams_2d():
    """tests/test_mgr_ams.py:124's problem, AMS set up by both packages."""
    jA, jG, xy = _curl_curl_2d(10, 10, beta=0.01)
    tA, tG, _ = maxwell.curl_curl_2d(10, 10, beta=0.01, **F64)
    ja = j_ams.AMS(amg_knobs=J_KNOBS).setup(jA, jG, xy)
    ta = AMS(amg_knobs=T_KNOBS).setup(tA, tG, xy, device="cpu")
    return jA, jG, tA, tG, ja, ta


def test_ams_pi_and_galerkin_products_match(ams_2d):
    jA, jG, tA, tG, ja, ta = ams_2d
    for tPi, jPi in zip(ta.Pis, ja.Pis):
        same_matrix(tPi, jPi, 1e-12)
        same_matrix(rap_f64(tA, tPi), j_ams._host_rap(jA, jPi), 1e-12)
    same_matrix(rap_f64(tA, tG), j_ams._host_rap(jA, jG), 1e-12)
    for tb, jb in zip([ta.B_G] + ta.B_Pi, [ja.B_G] + ja.B_Pi):
        assert [lv.A.n_rows for lv in tb.hierarchy.levels] == \
            [lv.A.n_rows for lv in jb.hierarchy.levels]


@pytest.mark.parametrize("cycle", ["01210", "additive"])
def test_ams_takes_the_reference_iterations(ams_2d, cycle):
    jA, _, tA, _, ja, ta = ams_2d
    b = np.ones(jA.n_rows)
    ja.cycle, ta.cycle = cycle, cycle
    try:
        jx, ji = j_pcg(lambda v: j_spmv(jA, v), jnp.asarray(b),
                       M=ja.precond(), rtol=1e-8, maxiter=2000)
        tx, ti = H.pcg(tA.mv, torch.from_numpy(b), M=ta.precond(),
                       rtol=1e-8, maxiter=2000, device="cpu")
    finally:
        ja.cycle, ta.cycle = "01210", "01210"
    assert bool(ti.converged) and bool(ji.converged)
    assert int(ti.iterations) == int(ji.iterations)
    assert rel_close(tx, jx, 1e-6)


@pytest.fixture(scope="module")
def ads_3d():
    """tests/test_ads.py:110's problem, ADS set up by both packages."""
    jA, jC, jG, xyz = ref_div_div(4)
    tA, tC, tG, _ = maxwell.div_div_3d(4, **F64)
    return (jA, jC, jG, tA, tC, tG, xyz,
            JADS(amg_knobs=J_KNOBS).setup(jA, jC, jG, xyz),
            ADS(amg_knobs=T_KNOBS).setup(tA, tC, tG, xyz, device="cpu"))


def test_ads_face_weights_normals_and_pi_match(ads_3d):
    """The reference forms the face-node incidence |C||G| with its C++
    SpGEMM, then weights, centroids, extents and normals in numpy
    (ads.py:72-110); the same steps here give the port's to 1e-12."""
    jA, jC, jG, tA, tC, tG, xyz, jd, td = ads_3d
    Cc, Gc = j_ell_to_csr(jC), j_ell_to_csr(jG)
    nf = Cc.shape[0]
    p, j, x = j_native.spgemm(
        nf, Gc.shape[1], Cc.indptr.astype(np.int32),
        Cc.indices.astype(np.int32), np.abs(Cc.data).astype(np.float64),
        Gc.indptr.astype(np.int32), Gc.indices.astype(np.int32),
        np.abs(Gc.data).astype(np.float64))
    frows = np.repeat(np.arange(nf), np.diff(p))
    weight = x / np.maximum(np.add.reduceat(x, p[:-1]), 1e-300)[frows]
    cen = np.zeros((nf, 3))
    np.add.at(cen, frows, xyz[j] * weight[:, None])
    ext = np.zeros((nf, 3))
    np.maximum.at(ext, frows, np.abs(xyz[j] - cen[frows]))
    normal = (ext < 1e-12).astype(float)
    normal /= np.maximum(np.linalg.norm(normal, axis=1, keepdims=True),
                         1e-300)
    W, t_normal, _ = face_node_pi(tC, tG, torch.from_numpy(xyz))
    Wc = ell_to_csr(W)
    assert np.array_equal(Wc.indptr, p) and np.array_equal(Wc.indices, j)
    assert rel_close(Wc.data, weight, 1e-12)
    assert rel_close(t_normal, normal, 1e-12)
    for tPi, jPi in zip(td.Pis, jd.Pis):
        same_matrix(tPi, jPi, 1e-12)


def test_ads_takes_the_reference_iterations(ads_3d):
    jA, _, _, tA, _, _, _, jd, td = ads_3d
    b = np.ones(jA.n_rows)
    jx, ji = j_pcg(lambda v: j_spmv(jA, v), jnp.asarray(b), M=jd.precond(),
                   rtol=1e-8, maxiter=500)
    tx, ti = H.pcg(tA.mv, torch.from_numpy(b), M=td.precond(), rtol=1e-8,
                   maxiter=500, device="cpu")
    assert bool(ti.converged) and bool(ji.converged)
    assert int(ti.iterations) == int(ji.iterations)
    assert rel_close(tx, jx, 1e-6)


def test_ads_inner_ams_leaves_out_the_gradient_correction():
    """C G = 0, so the inner AMS's G^T (C^T A C) G is rounding noise; the
    reference builds a BoomerAMG on it anyway, and its ADS stalls once the
    noise grows. The port's inner AMS has no gradient correction (hypre's
    ADS gives it no beta Poisson matrix): at 11^3 PCG converges in 80
    iterations; rebuilt with the correction, as the reference's, the
    relative residual is above 1 after 30. At 4^3 both take 34
    (test_ads_takes_the_reference_iterations)."""
    A, C, G, xyz = maxwell.div_div_3d(11, **F64)
    ads = ADS().setup(A, C, G, xyz, device="cpu")
    assert ads.ams.beta_is_zero and ads.ams.B_G is None
    noise = rap_f64(ads.ams.A, G)
    assert float(noise.vals.abs().max()) < 1e-12 * float(
        ads.ams.A.vals.abs().max())
    b = torch.ones(A.n_rows, dtype=torch.float64)
    _, info = H.pcg(A.mv, b, M=ads.precond(), rtol=1e-6, maxiter=100,
                    device="cpu")
    assert bool(info.converged)
    ads.ams = AMS().setup(ads.ams.A, G, xyz, device="cpu")
    _, info = H.pcg(A.mv, b, M=ads.precond(), rtol=1e-6, maxiter=30,
                    device="cpu")
    assert not bool(info.converged) and float(info.relative_residual) > 0.5


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ame_eigenvalues_match_on_both_paths(dtype):
    """float64: LOBPCG in the operator's type (8x8, block 3, tol 1e-6,
    which 150 iterations do not quite reach, in either package); float32:
    the float64 outer loop with float32 cycles (6x6, block 2, tol 3e-4).
    Eigenvalues to 1e-6; the vectors divergence-free."""
    nx, m, tol, maxiter = (8, 3, 1e-6, 150) if dtype == "float64" else \
        (6, 2, 3e-4, 30)
    jA, jG, xy = _curl_curl_2d(nx, nx, beta=0.05)
    tA, tG, _ = maxwell.curl_curl_2d(nx, nx, beta=0.05, dtype=getattr(
        torch, dtype), device="cpu")
    if dtype == "float32":
        jA, jG = (JEll(vals=M.vals.astype(jnp.float32), cols=M.cols,
                       n_cols=M.n_cols) for M in (jA, jG))
    je = JAME(block_size=m, tol=tol, maxiter=maxiter,
              ams=j_ams.AMS(amg_knobs=J_KNOBS)).setup(jA, jG, xy)
    jl, _, _ = je.solve(seed=3)
    te = AME(block_size=m, tol=tol, maxiter=maxiter,
             ams=AMS(amg_knobs=T_KNOBS)).setup(tA, tG, xy, device="cpu")
    tl, tX, trn = te.solve(seed=3)
    assert rel_close(np.sort(tl.numpy()), np.sort(np.asarray(jl)), 1e-6)
    assert trn.shape == (m,) and bool(torch.isfinite(trn).all())
    Gt = dataclasses.replace(te._Gt, vals=te._Gt.vals.double())
    X = tX.double()
    div = torch.linalg.matrix_norm(Gt.mv(X)) / torch.linalg.matrix_norm(X)
    assert float(div) < 1e-5
