"""hypre_tpu_torch's error-free transforms and iterative refinement
against hypre_tpu's, on the CPU.

The oracle of every true residual is a numpy float64 product of A with
the float64 value of x; nothing here calls the reference's C++ library:
its ``refine_solve`` takes the f64 residual from ``native.matvec``, which
the test replaces with the same numpy CSR product (monkeypatch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu import native as j_native
from hypre_tpu.amg import BoomerAMG as JBoomerAMG
from hypre_tpu.ij import IJMatrix as JIJMatrix
from hypre_tpu.krylov import pcg as j_pcg
from hypre_tpu.problems.laplacian import laplacian_3d_7pt as j_lap7
from hypre_tpu.refine import make_device_refiner as j_make_refiner, \
    refine_solve as j_refine_solve
from hypre_tpu.seq import twofloat as jtf
from hypre_tpu.seq.dia import try_dia as j_try_dia

import hypre_tpu_torch as H
from hypre_tpu_torch.seq import twofloat as ttf
from hypre_tpu_torch.seq.dia import try_dia
from hypre_tpu_torch.seq.ell import ell_to_csr
from torch_one_thread import one_torch_thread  # noqa: F401


def numpy_matvec(n, Ap, Aj, Ax, x):
    rows = np.repeat(np.arange(n), np.diff(Ap))
    y = np.zeros(n)
    np.add.at(y, rows, Ax * np.asarray(x, np.float64)[Aj])
    return y


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(j_native, "matvec", numpy_matvec)


def true_rel(A, x64, b64):
    """||b - A x|| / ||b|| in numpy float64 (A an EllMatrix of the port)."""
    r = b64 - ell_to_csr(A).matvec(np.asarray(x64, np.float64))
    return float(np.linalg.norm(r) / np.linalg.norm(b64))


def test_eft_identities_and_the_reference_bits():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(1000) * 1e3).astype(np.float32)
    b = rng.standard_normal(1000).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    exact_sum = a.astype(np.float64) + b.astype(np.float64)
    exact_prod = a.astype(np.float64) * b.astype(np.float64)
    s, e = ttf.two_sum(ta, tb)
    assert np.array_equal(s.double().numpy() + e.double().numpy(), exact_sum)
    p, pe = ttf.two_prod(ta, tb)
    np.testing.assert_allclose(p.double().numpy() + pe.double().numpy(),
                               exact_prod, rtol=1e-14)
    big, small = (np.where(np.abs(a) >= np.abs(b), v, w)
                  for v, w in ((a, b), (b, a)))
    s, e = ttf.fast_two_sum(torch.from_numpy(big), torch.from_numpy(small))
    assert np.array_equal(s.double().numpy() + e.double().numpy(),
                          big.astype(np.float64) + small)
    # the same bits as the reference's transforms, op for op
    for name, args in (("two_sum", (a, b)), ("two_prod", (a, b)),
                       ("fast_two_sum", (big, small)), ("split", (a,))):
        got = getattr(ttf, name)(*(torch.from_numpy(v) for v in args))
        want = getattr(jtf, name)(*(jnp.asarray(v) for v in args))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), name


@pytest.fixture(scope="module")
def dia12():
    jA = j_lap7(12, 12, 12, dtype=jnp.float32)
    tA = H.laplacian_3d_7pt(12, 12, 12, dtype=torch.float32, device="cpu")
    jD, tD = j_try_dia(jA), try_dia(tA)
    assert np.array_equal(tD.dvals.numpy(), np.asarray(jD.dvals))
    return jD, tD


def pair_close(t_pair, j_pair):
    """The f64 sums of the two pairs within 2^-46 of the largest value."""
    t = t_pair[0].double().numpy() + t_pair[1].double().numpy()
    j = np.asarray(j_pair[0], np.float64) + np.asarray(j_pair[1], np.float64)
    return np.abs(t - j).max() <= 2.0 ** -46 * np.abs(j).max()


def test_dia_mv_2f_is_the_reference(dia12):
    jD, tD = dia12
    x = np.random.default_rng(1).standard_normal(tD.n_rows).astype(np.float32)
    got = ttf.dia_mv_2f(tD, torch.from_numpy(x))
    assert pair_close(got, jax.jit(jtf.dia_mv_2f)(jD, jnp.asarray(x)))
    # op by op, the reference computes the same bits
    want = jtf.dia_mv_2f(jD, jnp.asarray(x))
    assert all(np.array_equal(g.numpy(), np.asarray(w))
               for g, w in zip(got, want))
    # and it is the exact product of the f32 data to ~2^-48
    y64 = ell_to_csr(H.laplacian_3d_7pt(12, 12, 12, dtype=torch.float64,
                                        device="cpu")).matvec(
        x.astype(np.float64))
    err2f = np.abs(got[0].double().numpy() + got[1].double().numpy() - y64)
    err32 = np.abs(tD.mv(torch.from_numpy(x)).double().numpy() - y64)
    assert err2f.max() < 1e-5 * err32.max() + 1e-12 * np.abs(y64).max()


def test_dia_residual_2f_is_the_reference(dia12):
    """Against the reference run op by op: the same bits, and the exact
    residual of the f32 data to 7.8e-14 (of values up to 27). Jitted on
    the CPU, XLA fuses the reference's transforms and its pair lands
    2.4e-7 away from the exact residual (f32 rounding: the error terms
    are lost), so the jitted reference is not the yardstick here."""
    jD, tD = dia12
    rng = np.random.default_rng(2)
    n = tD.n_rows
    b = rng.standard_normal(n).astype(np.float32)
    x_hi = rng.standard_normal(n).astype(np.float32)
    x_lo = (x_hi * rng.standard_normal(n) * 1e-8).astype(np.float32)
    got = ttf.dia_residual_2f(tD, *(torch.from_numpy(v)
                                    for v in (b, x_hi, x_lo)))
    want = jtf.dia_residual_2f(jD, *(jnp.asarray(v)
                                     for v in (b, x_hi, x_lo)))
    assert pair_close(got, want)
    assert all(np.array_equal(g.numpy(), np.asarray(w))
               for g, w in zip(got, want))
    A64 = ell_to_csr(H.laplacian_3d_7pt(12, 12, 12, dtype=torch.float64,
                                        device="cpu"))
    exact = (b.astype(np.float64) - A64.matvec(x_hi.astype(np.float64))
             - A64.matvec(x_lo.astype(np.float64)))
    pair = got[0].double().numpy() + got[1].double().numpy()
    assert np.abs(pair - exact).max() <= 2.0 ** -46 * np.abs(exact).max()


def test_device_refiner_reaches_1e8_on_f32_arithmetic():
    """The reference's own case (tests/test_twofloat.py): 16^3, b = ones,
    three DS-PCG passes in f32 (rtol 1e-5, maxiter 80). With two-float
    residuals the true residual (numpy f64 oracle, relative to ||b||)
    falls under 1e-8, and under the plain refiner's, in the port as in
    the reference (run op by op)."""
    n = 16
    tA = H.laplacian_3d_7pt(n, n, n, dtype=torch.float32, device="cpu")
    jA = j_lap7(n, n, n, dtype=jnp.float32)
    tD, jD = try_dia(tA), j_try_dia(jA)
    tdinv, jdinv = 1.0 / tA.diagonal(), 1.0 / jA.diagonal()
    A64 = H.laplacian_3d_7pt(n, n, n, dtype=torch.float64, device="cpu")
    b64 = np.ones(n ** 3)

    def t_inner(Af, dinv, r):
        return H.pcg(Af.mv, r, M=lambda z: dinv * z, rtol=1e-5, maxiter=80,
                     device="cpu")

    def j_inner(Af, dinv, r):
        return j_pcg(Af.mv, r, M=lambda z: dinv * z, rtol=1e-5, maxiter=80)

    rel = {}
    for two_f in (True, False):
        hi, lo, _ = H.make_device_refiner([t_inner] * 3, residual_2f=two_f)(
            tD, tdinv, torch.ones(n ** 3))
        rel[two_f] = true_rel(A64, hi.double().numpy()
                              + lo.double().numpy(), b64)
    assert rel[True] < 1e-8, rel
    assert rel[False] > rel[True], rel
    j_hi, j_lo, _ = j_make_refiner([j_inner] * 3, residual_2f=True) \
        .__wrapped__(jD, jdinv, jnp.ones(n ** 3, jnp.float32))
    assert true_rel(A64, np.asarray(j_hi, np.float64)
                    + np.asarray(j_lo, np.float64), b64) < 1e-8


@pytest.mark.parametrize("two_f", [True, False])
def test_device_refiner_takes_the_reference_passes(two_f):
    """The refiner's own arithmetic against the reference's (run op by op
    to read each pass): the same f32 residuals, three passes, the same
    inner iterations per pass. The inner solve runs DS-PCG in f64 on the
    f32 residual and hands back an f32 correction, so that its counts do
    not hang on the two packages' different f32 summation orders (f32
    DS-PCG passes took 28/40/45 against 28/40/44)."""
    n = 16
    tA = H.laplacian_3d_7pt(n, n, n, dtype=torch.float32, device="cpu")
    jA = j_lap7(n, n, n, dtype=jnp.float32)
    tA64 = H.laplacian_3d_7pt(n, n, n, dtype=torch.float64, device="cpu")
    jA64 = j_lap7(n, n, n)
    tD, jD = try_dia(tA), j_try_dia(jA)
    t_its, j_its = [], []

    def t_inner(Af, r):
        d, info = H.pcg(tA64.mv, r.double(), M=lambda z: z / 6.0,
                        rtol=1e-5, maxiter=200, device="cpu")
        t_its.append(int(info.iterations))
        return d.float(), info

    def j_inner(Af, r):
        d, info = j_pcg(jA64.mv, r.astype(jnp.float64), M=lambda z: z / 6.0,
                        rtol=1e-5, maxiter=200)
        j_its.append(int(info.iterations))
        return d.astype(jnp.float32), info

    t_hi, t_lo, _ = H.make_device_refiner([t_inner] * 3, residual_2f=two_f)(
        tD, torch.ones(n ** 3))
    j_hi, j_lo, _ = j_make_refiner([j_inner] * 3, residual_2f=two_f) \
        .__wrapped__(jD, jnp.ones(n ** 3, jnp.float32))
    assert len(t_its) == 3 and t_its == j_its
    t_x = t_hi.double().numpy() + t_lo.double().numpy()
    j_x = np.asarray(j_hi, np.float64) + np.asarray(j_lo, np.float64)
    b64 = np.ones(n ** 3)
    t_rel, j_rel = true_rel(tA64, t_x, b64), true_rel(tA64, j_x, b64)
    assert abs(t_rel - j_rel) <= 0.05 * j_rel
    if two_f:
        assert t_rel < 1e-8


def test_refine_solve_takes_the_reference_inner_iterations(no_native):
    """refine_solve at 16^3, b = ones, rtol 1e-6: the solve gets the
    residual in f32 (DS-PCG to rtol 1e-4, run in f64 so that its counts
    do not hang on f32 summation orders); the f64 true residual reaches
    1e-6 in the reference's passes and inner iterations. The port's f64
    residual is A's own product on A's device; the reference's is a host
    CSR product."""
    n = 16
    tA = H.laplacian_3d_7pt(n, n, n, dtype=torch.float64, device="cpu")
    jA = j_lap7(n, n, n)

    def t_solve(r):
        assert r.dtype == torch.float32
        return H.pcg(tA.mv, r.double(), M=lambda z: z / 6.0, rtol=1e-4,
                     maxiter=200, device="cpu")

    def j_solve(r):
        assert r.dtype == np.float32
        return j_pcg(jA.mv, jnp.asarray(r, jnp.float64),
                     M=lambda z: z / 6.0, rtol=1e-4, maxiter=200)

    tx, trel, tits = H.refine_solve(tA, t_solve, torch.ones(n ** 3),
                                    rtol=1e-6)
    jx, jrel, jits = j_refine_solve(jA, j_solve, np.ones(n ** 3), rtol=1e-6)
    assert tx.dtype == torch.float64
    assert tits == jits
    assert trel <= 1e-6 and jrel <= 1e-6
    assert abs(trel - jrel) <= 1e-3 * jrel
    assert abs(true_rel(tA, tx.numpy(), np.ones(n ** 3)) - trel) <= 1e-12
    z, zrel, zits = H.refine_solve(tA, t_solve, torch.zeros(n ** 3))
    assert zits == 0 and zrel == 0.0 and not bool(z.any())


def test_ij_path_then_amg_pcg_then_refinement(no_native):
    """The slice as a whole, as a hypre user runs it (ex5): the 16^3 7-pt
    Laplacian staged row block by row block through IJMatrix.set_values,
    assembled, BoomerAMG-PCG at rtol 1e-8 in f64, then refine_solve with
    the facade's PCG (f32 residuals cast up, rtol 1e-5) as the fast
    solve. Iterations, passes and the final true residual are the
    reference's."""
    n = 16
    grid = H.laplacian_3d_7pt(n, n, n, dtype=torch.float64, device="cpu")
    csr = ell_to_csr(grid)
    rows = np.repeat(np.arange(n ** 3), csr.row_nnz())
    t_ij, j_ij = H.IJMatrix(n ** 3, n ** 3), JIJMatrix(n ** 3, n ** 3)
    for lo in range(0, n ** 3, 1000):
        sel = (rows >= lo) & (rows < lo + 1000)
        t_ij.set_values(rows[sel], csr.indices[sel], csr.data[sel])
        j_ij.set_values(rows[sel], csr.indices[sel], csr.data[sel])
    tA = t_ij.assemble().get_object(dtype=torch.float64, device="cpu")
    jA = j_ij.assemble().get_object(dtype=jnp.float64)
    assert np.array_equal(ell_to_csr(tA).data, csr.data)
    t_amg = H.BoomerAMG(max_coarse_size=50, setup_backend="jax").setup(
        tA, device="cpu")
    j_amg = JBoomerAMG(max_coarse_size=50, setup_backend="jax").setup(jA)
    b = np.ones(n ** 3)
    tx, ti = H.pcg(tA.mv, torch.from_numpy(b), M=t_amg.precond(),
                   rtol=1e-8, device="cpu")
    jx, ji = j_pcg(jA.mv, jnp.asarray(b), M=j_amg.precond(), rtol=1e-8)
    assert int(ti.iterations) == int(ji.iterations)
    assert bool(ti.converged)

    def t_solve(r):
        return H.pcg(tA.mv, r.double(), M=t_amg.precond(), rtol=1e-5,
                     device="cpu")

    def j_solve(r):
        return j_pcg(jA.mv, jnp.asarray(r, jnp.float64), M=j_amg.precond(),
                     rtol=1e-5)

    rx, rrel, rits = H.refine_solve(tA, t_solve, torch.from_numpy(b),
                                    rtol=1e-9)
    jrx, jrrel, jrits = j_refine_solve(jA, j_solve, b, rtol=1e-9)
    assert rits == jrits
    assert rrel <= 1e-9 and jrrel <= 1e-9
    assert abs(rrel - jrrel) <= 1e-2 * jrrel
