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
- ADS: the face weights, normals and Pi match to 1e-12; the port's
  cycle equals hypre's multiplicative composition of the reference's
  set-up parts to 1e-10, and the reference's additive cycle, rebuilt from
  the port's parts, takes the reference's iterations
  (tests/test_ads.py:110).
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


def reference_cycle(ads):
    """The reference's ADS cycle from the port's parts: the same smoothing,
    curl and Pi corrections, the three Pi_d corrections added on one
    residual (hypre_tpu/amg/ads.py:128-146)."""
    A, C, Ct, l1inv = ads.A, ads.C, ads.Ct, ads.l1inv
    ams_M = ads.ams.precond()

    def smooth(z, r):
        return z + l1inv * (r - A.mv(z))

    def pi_corr(z, r):
        res = r - A.mv(z)
        for Pi, Pit, B in zip(ads.Pis, ads.Pits, ads.B_Pi):
            z = z + Pi.mv(B.cycle(Pit.mv(res)))
        return z

    def M(r):
        z = pi_corr(smooth(torch.zeros_like(r), r), r)
        z = z + C.mv(ams_M(Ct.mv(r - A.mv(z))))
        return smooth(pi_corr(z, r), r)

    return M


def test_ads_takes_the_reference_iterations(ads_3d):
    # with the reference's cycle (reference_cycle) the port takes its
    # iterations; the port's own runs the Pi_d corrections one after
    # another, as hypre does, and takes fewer
    # (test_ads_pi_components_run_one_after_another)
    jA, _, _, tA, _, _, _, jd, td = ads_3d
    b = np.ones(jA.n_rows)
    jx, ji = j_pcg(lambda v: j_spmv(jA, v), jnp.asarray(b), M=jd.precond(),
                   rtol=1e-8, maxiter=500)
    tx, ti = H.pcg(tA.mv, torch.from_numpy(b), M=reference_cycle(td),
                   rtol=1e-8, maxiter=500, device="cpu")
    assert bool(ti.converged) and bool(ji.converged)
    assert int(ti.iterations) == int(ji.iterations)
    assert rel_close(tx, jx, 1e-6)
    _, tm = H.pcg(tA.mv, torch.from_numpy(b), M=td.precond(), rtol=1e-8,
                  maxiter=500, device="cpu")
    assert bool(tm.converged) and int(tm.iterations) < int(ji.iterations)


def test_ads_pi_components_run_one_after_another():
    """The reference adds the three Pi_d corrections to one residual (a
    block-Jacobi step over the coupled nodal-vector system), which makes
    its M indefinite: on the constant-coefficient div-div problem M A has
    eigenvalues down to -1.4 at 4^3, and PCG no longer converges from
    12^3 (1000 iterations at 24^3, relative residual 7.5e-3). Run one
    after another (hypre's ADS cycle), M is SPD and PCG takes 5-6
    iterations from 4^3 to 16^3; on the lognormal draw 7-23."""
    A, C, G, xyz = maxwell.div_div_3d(4, sigma=0.0, **F64)
    n = A.n_rows
    eye = torch.eye(n, dtype=torch.float64)
    Ad = torch.stack([A.mv(eye[i]) for i in range(n)], 1)
    L = torch.linalg.cholesky(Ad)
    lam = {}
    ads = ADS().setup(A, C, G, xyz, device="cpu")
    for cyc, M in (("multiplicative", ads.precond()),
                   ("additive", reference_cycle(ads))):
        Md = torch.stack([M(eye[i]) for i in range(n)], 1)
        assert float((Md - Md.T).abs().max()) < 1e-10 * float(
            Md.abs().max())
        lam[cyc] = float(torch.linalg.eigvalsh(L.T @ Md @ L).min())
    assert lam["multiplicative"] > 0.5 and lam["additive"] < -1.0
    A, C, G, xyz = maxwell.div_div_3d(12, sigma=0.0, **F64)
    b = A.mv(torch.from_numpy(np.random.default_rng(18).random(A.n_cols)))
    its = {}
    ads = ADS().setup(A, C, G, xyz, device="cpu")
    for cyc, M in (("multiplicative", ads.precond()),
                   ("additive", reference_cycle(ads))):
        _, info = H.pcg(A.mv, b, M=M, rtol=1e-6, maxiter=40, device="cpu")
        its[cyc] = (int(info.iterations), bool(info.converged))
    assert its["multiplicative"][1] and its["multiplicative"][0] <= 8
    assert not its["additive"][1]


def test_ads_cycle_is_the_multiplicative_composition_of_reference_parts(
        ads_3d):
    """The port's ADS cycle equals, to 1e-10, hypre's multiplicative
    composition written here in numpy from the reference's own set-up
    parts: l1 smoothing on A, the Pi_d corrections x, y, z on the way
    down and z, y, x on the way up, each on the residual the previous one
    left, and between them C times the inner AMS's 01210 cycle (its Pi
    corrections on one residual, no gradient correction: beta is zero)
    applied to C^T times the residual."""
    _, _, _, tA, _, _, _, jd, td = ads_3d
    dense = lambda M: j_ell_to_csr(M).to_dense()  # noqa: E731
    A, C = dense(jd.A), dense(jd.C)
    l1 = np.asarray(jd.l1inv)
    Pis = [dense(P) for P in jd.Pis]
    ams = jd.ams
    A_C, l1_C = dense(ams.A), np.asarray(ams.l1inv)
    ams_Pis = [dense(P) for P in ams.Pis]

    def cyc(B, v):
        return np.asarray(B.cycle(jnp.asarray(v)))

    def ams_M(r):
        def smooth(z):
            return z + l1_C * (r - A_C @ z)

        def pi_corr(z):
            res = r - A_C @ z
            return z + sum(P @ cyc(B, P.T @ res)
                           for P, B in zip(ams_Pis, ams.B_Pi))

        return smooth(pi_corr(pi_corr(smooth(np.zeros_like(r)))))

    def ads_M(r):
        def smooth(z):
            return z + l1 * (r - A @ z)

        def pi_corr(z, order):
            for d in order:
                z = z + Pis[d] @ cyc(jd.B_Pi[d], Pis[d].T @ (r - A @ z))
            return z

        z = pi_corr(smooth(np.zeros_like(r)), (0, 1, 2))
        z = z + C @ ams_M(C.T @ (r - A @ z))
        return smooth(pi_corr(z, (2, 1, 0)))

    r = np.random.default_rng(13).standard_normal(tA.n_rows)
    want = ads_M(r)
    got = td.precond()(torch.from_numpy(r)).numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


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
