"""hypre_tpu_torch's preconditioners (``precond/``) against hypre_tpu's,
in float64 on the CPU, on a 2-D 5-pt Laplacian at 12^2, a 3-D 7-pt
Laplacian at 6^3 and (for the fixed-point factorizations) the 2-D
Laplacian at 24^2 and the 3-D at 8^3.

- ILU(k), ILUT, IC and the shells around them (Euclid, PILUT, DDICT,
  DDILUT, the ILU-Schur interior factor): the factors' (row, col) -> value
  maps (slot order differs: the reference's pattern product is C++) and
  the inverse diagonal, to 1e-10 relative.
- FSAI's G, ParaSails' M, Schwarz's inverse blocks, the polynomial's
  coefficients, NSH's interface inverse, the saddle system's S_hat: to
  1e-10.
- One application M(r) per object, to 1e-10; the ILU-GMRES inner solves
  take the reference's iteration counts.

No test runs the reference's Krylov solve with an ILU-family
preconditioner (the reference's ILU solves are slow on the CPU). The
saddle solvers' A11 BoomerAMG is the pure setup in both packages
(``setup_backend="jax"``), and the reference's C++ SpGEMM (ILU(k)'s
pattern, S_hat) is replaced by a numpy CSR product (monkeypatch).
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypre_tpu.precond as JP
from hypre_tpu import native as j_native
from hypre_tpu.amg import BoomerAMG as JBoomerAMG
from hypre_tpu.precond import saddle as j_saddle
from hypre_tpu.problems.laplacian import laplacian_2d_5pt as j_lap5, \
    laplacian_3d_7pt as j_lap7, stencil_to_ell as j_stencil
from hypre_tpu.seq.csr import HostCSR as JHostCSR
from hypre_tpu.seq.ell import ell_to_csr as j_ell_to_csr
from hypre_tpu.seq.spgemm import ell_add as j_ell_add, \
    ell_transpose as j_ell_transpose

import hypre_tpu_torch as H
import hypre_tpu_torch.precond as TP
from hypre_tpu_torch.convert import saddle_from_numpy
from hypre_tpu_torch.precond import common as t_common
from hypre_tpu_torch.precond import saddle as t_saddle
from hypre_tpu_torch.seq.ell import EllMatrix, ell_to_csr
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL = 1e-10


def to_port(jA) -> EllMatrix:
    return H.ell_from_numpy(np.asarray(jA.vals), np.asarray(jA.cols),
                            jA.n_cols, jA.shifts, device="cpu")


def mat_dict(jA) -> dict:
    return {"vals": np.asarray(jA.vals), "cols": np.asarray(jA.cols),
            "n_cols": jA.n_cols, "shifts": jA.shifts}


def numpy_spgemm(n, m, Ap, Aj, Ax, Bp, Bj, Bx):
    """C = A B over CSR arrays, in numpy (the C++ routine's contract)."""
    A = JHostCSR(Ap, Aj, Ax, (n, int(Bp.shape[0]) - 1))
    B = JHostCSR(Bp, Bj, Bx, (int(Bp.shape[0]) - 1, m))
    C = A.matmat(B)
    return (C.indptr.astype(np.int32), C.indices.astype(np.int32),
            C.data.astype(np.float64))


PROBLEMS = {
    "5pt-12": lambda: j_lap5(12, 12),
    "7pt-6": lambda: j_lap7(6, 6, 6),
    "5pt-24": lambda: j_lap5(24, 24),
    "7pt-8": lambda: j_lap7(8, 8, 8),
}
SMALL = ["5pt-12", "7pt-6"]


@pytest.fixture(scope="module", autouse=True)
def no_native():
    """The reference's C++ SpGEMM (ILU(k)'s pattern, S_hat) replaced by a
    numpy CSR product for this module's tests."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_native, "spgemm", numpy_spgemm)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def problems():
    out = {}
    for name, make in PROBLEMS.items():
        jA = make()
        out[name] = (jA, to_port(jA))
    return out


def rel_close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max(initial=0.0) <= rtol * max(
        np.abs(b).max(initial=0.0), 1e-300)


def nonzero_map(csr) -> dict:
    """(row, col) -> value over the entries with a nonzero value."""
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    keep = csr.data != 0
    return dict(zip(zip(rows[keep].tolist(), csr.indices[keep].tolist()),
                    csr.data[keep].tolist()))


def same_map(t: EllMatrix, j) -> None:
    tm, jm = nonzero_map(ell_to_csr(t)), nonzero_map(j_ell_to_csr(j))
    assert tm.keys() == jm.keys()
    keys = sorted(jm)
    assert rel_close([tm[k] for k in keys], [jm[k] for k in keys])


def same_dense(t: EllMatrix, j) -> None:
    assert rel_close(ell_to_csr(t).to_dense(),
                     np.asarray(j_ell_to_csr(j).to_dense()))


def same_apply(t_obj, j_obj, n: int, seed: int = 1) -> None:
    r = np.random.default_rng(seed).standard_normal(n)
    assert rel_close(t_obj.precond()(torch.from_numpy(r)),
                     j_obj.precond()(jnp.asarray(r)))


def same_ilu(t, j) -> None:
    same_map(t.L, j.L)
    same_map(t.U, j.U)
    assert rel_close(t.dinv, j.dinv)


def build(name, kw, jA, tA):
    return (getattr(JP, name)(**kw).setup(jA),
            getattr(TP, name)(**kw).setup(tA, device="cpu"))


# ---------------------------------------------------------------------------
# Fixed-point factorizations
# ---------------------------------------------------------------------------

ILU_CASES = [
    ("ILU", dict()), ("ILU", dict(fill_level=1)),
    ("ILUT", dict()), ("ILUT", dict(max_row_nnz=4)),
    ("Euclid", dict()),
    ("Euclid", dict(level=0, bj=4, row_scale=True, sparse_a=0.3)),
    ("PILUT", dict()),
    ("PILUT", dict(factor_row_size=8, drop_tolerance=1e-3)),
]


def case_id(case):
    name, kw = case
    return name + "".join(f",{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("problem", list(PROBLEMS))
@pytest.mark.parametrize("case", ILU_CASES[:2] + ILU_CASES[4:5],
                         ids=case_id)
def test_ilu_factors_and_apply(problems, problem, case):
    jA, tA = problems[problem]
    j, t = build(*case, jA, tA)
    same_ilu(t, j)
    same_apply(t, j, jA.n_rows)


@pytest.mark.parametrize("problem", SMALL)
@pytest.mark.parametrize("case", ILU_CASES[2:4] + ILU_CASES[5:],
                         ids=case_id)
def test_threshold_ilu_factors_and_apply(problems, problem, case):
    jA, tA = problems[problem]
    j, t = build(*case, jA, tA)
    same_ilu(t, j)
    same_apply(t, j, jA.n_rows)


IC_CASES = [("IC", dict()), ("DDICT", dict(num_subdomains=2, overlap=3)),
            ("DDICT", dict(threshold=0.3))]


@pytest.mark.parametrize("problem", list(PROBLEMS))
@pytest.mark.parametrize("case", IC_CASES, ids=case_id)
def test_ic_factors_and_apply(problems, problem, case):
    jA, tA = problems[problem]
    j, t = build(*case, jA, tA)
    same_map(t.L, j.L)
    same_map(t.Lt, j.Lt)
    assert rel_close(t.dinv, j.dinv)
    same_apply(t, j, jA.n_rows)


@pytest.mark.parametrize("problem", SMALL)
def test_ddilut_factors_and_apply(problems, problem):
    jA, tA = problems[problem]
    j, t = build("DDILUT", dict(num_subdomains=2, overlap=3), jA, tA)
    same_ilu(t._ilut, j._ilut)
    same_apply(t, j, jA.n_rows)


def test_grow_pattern_is_the_reference_pattern(problems):
    """ILU(2) on the 3-D problem: A's values on the pattern of A^3."""
    from hypre_tpu.precond.ilu import _grow_pattern as j_grow

    from hypre_tpu_torch.precond.ilu import grow_pattern

    jA, tA = problems["7pt-6"]
    jG, tG = j_grow(jA, 2), grow_pattern(tA, 2)
    tc, jc = ell_to_csr(tG), j_ell_to_csr(jG)
    assert np.array_equal(tc.indptr, jc.indptr)
    for r in range(jA.n_rows):
        lo, hi = jc.indptr[r], jc.indptr[r + 1]
        order = np.argsort(jc.indices[lo:hi])
        assert np.array_equal(tc.indices[lo:hi], jc.indices[lo:hi][order])
        assert np.array_equal(tc.data[lo:hi], jc.data[lo:hi][order])


def test_pair_slots_chunks_give_the_same_index(problems, monkeypatch):
    """The (n, k, k) slot index of the Chow-Patel sweep, built in one
    chunk and in chunks of 7 rows, and the factor values with it."""
    from hypre_tpu_torch.precond import ilu as t_ilu

    _, tA = problems["7pt-6"]
    G = t_ilu.grow_pattern(tA, 1)
    whole = t_ilu.pair_index(G.cols, lambda ca, cb: ca < cb)
    F_whole = t_ilu.chow_patel_sweeps(G, 3)
    monkeypatch.setattr(t_common, "CHUNK_ELEMENTS", 7 * G.k * G.k * 8)
    assert len(t_common.row_chunks(G.n_rows, 8 * G.k * G.k)) > 1
    assert torch.equal(t_ilu.pair_index(G.cols, lambda ca, cb: ca < cb),
                       whole)
    assert torch.equal(t_ilu.chow_patel_sweeps(G, 3), F_whole)


def test_ilu_schur_gmres_inner_iterations(problems, monkeypatch):
    """The interior ILU, the interface split and M(r); the inner GMRES
    (maxiter = k_dim = 5) takes the reference's iterations."""
    jA, tA = problems["5pt-12"]
    counts = []

    def counting_gmres(*args, **kw):
        x, info = real_gmres(*args, **kw)
        counts.append(int(info.iterations))
        return x, info

    # the reference's M imports gmres from its module at each call
    j_gmres_mod = importlib.import_module("hypre_tpu.krylov.gmres")
    real_gmres = j_gmres_mod.gmres
    monkeypatch.setattr(j_gmres_mod, "gmres", counting_gmres)
    kw = dict(nparts=2)
    j, t = build("ILUSchurGMRES", kw, jA, tA)
    assert np.array_equal(t.interior.numpy(), np.asarray(j.interior))
    same_ilu(t.B_ilu, j.B_ilu)
    same_ilu(t.C_ilu, j.C_ilu)
    for seed in (1, 2):
        same_apply(t, j, jA.n_rows, seed)
    assert t.inner_iterations == counts
    assert all(0 < c <= 5 for c in counts)


@pytest.mark.parametrize("problem", SMALL)
def test_ilu_schur_nsh_inverse_and_apply(problems, problem):
    jA, tA = problems[problem]
    j, t = build("ILUSchurNSH", dict(nparts=2, nsh_iters=12), jA, tA)
    assert np.array_equal(t.g_idx.numpy(), np.asarray(j.g_idx))
    assert rel_close(t.X, j.X)
    same_apply(t, j, jA.n_rows)
    with pytest.raises(ValueError, match="max_interface"):
        TP.ILUSchurNSH(nparts=2, max_interface=4).setup(tA, device="cpu")


# ---------------------------------------------------------------------------
# Approximate inverses, Schwarz, polynomial
# ---------------------------------------------------------------------------

# (problem, knobs): the reference's adaptive setup compiles for seconds
FSAI_CASES = [("5pt-12", dict()), ("7pt-6", dict()),
              ("7pt-6", dict(algo_type="adaptive", max_steps=4,
                             max_step_size=2))]


@pytest.mark.parametrize("problem,kw", FSAI_CASES,
                         ids=lambda c: c if isinstance(c, str)
                         else case_id(("", c)))
def test_fsai_g_and_apply(problems, problem, kw):
    jA, tA = problems[problem]
    j, t = build("FSAI", kw, jA, tA)
    same_dense(t.G, j.G)
    same_dense(t.Gt, j_ell_transpose(j.G))
    same_apply(t, j, jA.n_rows)


PARASAILS_CASES = [("5pt-12", dict()), ("7pt-6", dict()),
                   ("7pt-6", dict(thresh=0.1, nlevels=1, filter=0.01))]


@pytest.mark.parametrize("problem,kw", PARASAILS_CASES,
                         ids=lambda c: c if isinstance(c, str)
                         else case_id(("", c)))
def test_parasails_m_and_apply(problems, problem, kw):
    jA, tA = problems[problem]
    j, t = build("ParaSails", kw, jA, tA)
    same_dense(t.M, j.M)
    same_apply(t, j, jA.n_rows)


SCHWARZ_CASES = [("5pt-12", dict()), ("7pt-6", dict()),
                 ("5pt-12", dict(block_size=8, overlap=2, weighting="ras")),
                 ("7pt-6", dict(block_size=8, overlap=3))]


@pytest.mark.parametrize("problem,kw", SCHWARZ_CASES,
                         ids=lambda c: c if isinstance(c, str)
                         else case_id(("", c)))
def test_schwarz_blocks_and_apply(problems, problem, kw):
    jA, tA = problems[problem]
    j, t = build("Schwarz", kw, jA, tA)
    assert np.array_equal(t.index.numpy(), np.asarray(j.index))
    assert rel_close(t.inv_blocks, j.inv_blocks)
    assert rel_close(t.weight, j.weight)
    same_apply(t, j, jA.n_rows)


@pytest.mark.parametrize("problem", SMALL)
@pytest.mark.parametrize("order", [2, 4, 6])
def test_poly_coefficients_and_apply(problems, problem, order):
    jA, tA = problems[problem]
    j, t = build("PolyPrecond", dict(order=order), jA, tA)
    assert rel_close(t.coeffs, j.coeffs)
    same_apply(t, j, jA.n_rows)


def test_gather_submatrices_chunks(problems, monkeypatch):
    """The chunked lookups give the one-piece values: FSAI's dense
    blocks and G with a chunk of a few rows."""
    jA, tA = problems["7pt-6"]
    pattern = t_common.row_pattern_lower(tA)
    whole = t_common.gather_submatrices(tA, pattern)
    monkeypatch.setattr(t_common, "CHUNK_ELEMENTS", 5 * pattern.shape[1] ** 2
                        * tA.k)
    assert torch.equal(t_common.gather_submatrices(tA, pattern), whole)
    assert len(t_common.row_chunks(tA.n_rows, pattern.shape[1] ** 2
                                   * tA.k)) > 1
    j = JP.FSAI().setup(jA)
    same_dense(TP.FSAI().setup(tA, device="cpu").G, j.G)


def test_distributed_operators_raise(problems):
    # a ParEllMatrix takes the distributed path (its apply runs on the
    # sharded vector); an operator of another type still raises
    from hypre_tpu_torch.parallel import make_mesh, partition_ell
    from hypre_tpu_torch.parallel.par_ell import distribute_vector

    _, tA = problems["5pt-12"]
    mesh = make_mesh(4, device="cpu")
    Ap = partition_ell(tA, mesh)
    r = distribute_vector(np.ones(tA.n_rows), mesh)
    for name in ("Euclid", "PILUT", "ParaSails"):
        z = getattr(TP, name)().setup(Ap).precond()(r)
        assert z.shape == r.shape and bool(torch.isfinite(z).all())
        with pytest.raises(TypeError, match="EllMatrix or a ParEllMatrix"):
            getattr(TP, name)().setup(object(), device="cpu")


# ---------------------------------------------------------------------------
# Saddle-point systems
# ---------------------------------------------------------------------------


def make_saddle(n=16, eps=1e-2, mass=1.0):
    """tests/test_precond.py's Stokes-like system: A the 5-pt Laplacian
    plus a mass shift, B a one-sided difference, C = eps I."""
    L = j_lap5(n, n)
    A = j_ell_add(1.0, L, 1.0, j_stencil((n, n), [(0, 0)], [mass],
                                         dtype=L.dtype))
    B = j_stencil((n, n), [(0, 0), (1, 0)], [1.0, -1.0], dtype=L.dtype)
    C = j_stencil((n, n), [(0, 0)], [eps], dtype=L.dtype)
    return j_saddle.SaddleSystem(A=A, B=B, Bt=j_ell_transpose(B), C=C)


@pytest.fixture(scope="module")
def saddle():
    """The reference's Uzawa and BlockPrecond on the system, and the
    port's copy of the system."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_saddle, "BoomerAMG",
               functools.partial(JBoomerAMG, setup_backend="jax"))
    try:
        js = make_saddle()
        ju = j_saddle.Uzawa(omega=0.5, rtol=1e-7, maxiter=200).setup(js)
        jb = j_saddle.BlockPrecond(mode="triangular").setup(js)
    finally:
        mp.undo()
    ts = saddle_from_numpy({k: None if getattr(js, k) is None else
                            mat_dict(getattr(js, k))
                            for k in ("A", "B", "Bt", "C")}, device="cpu")
    # the port's A11 BoomerAMG takes the pure setup too, while the tests
    # that hold it against the reference's run
    tp = pytest.MonkeyPatch()
    tp.setattr(t_saddle, "BoomerAMG",
               functools.partial(H.BoomerAMG, setup_backend="jax"))
    yield js, ju, jb, ts
    tp.undo()


def test_saddle_schur_hat_and_block_precond(saddle):
    js, _, jb, ts = saddle
    r = np.random.default_rng(4).standard_normal(js.n_u + js.n_p)
    assert rel_close(ts.mv(torch.from_numpy(r)), js.mv(jnp.asarray(r)))
    tb = TP.BlockPrecond(mode="triangular").setup(ts, device="cpu")
    same_dense(tb.S, jb.S)
    assert [lv.A.n_rows for lv in tb.amg.hierarchy.levels] == \
        [lv.A.n_rows for lv in jb.amg.hierarchy.levels]
    assert rel_close(tb.precond()(torch.from_numpy(r)),
                     jb.precond()(jnp.asarray(r)))
    jd = j_saddle.BlockPrecond(mode="diag")
    jd.sys, jd.amg, jd.S, jd.s_dinv = js, jb.amg, jb.S, jb.s_dinv
    td = TP.BlockPrecond(mode="diag").setup(ts, device="cpu")
    assert rel_close(td.precond()(torch.from_numpy(r)),
                     jd.precond()(jnp.asarray(r)))


def test_uzawa_takes_the_reference_iterations(saddle):
    js, ju, _, ts = saddle
    f, g = np.ones(js.n_u), np.zeros(js.n_p)
    ju_u, ju_p, ji = ju.solve(jnp.asarray(f), jnp.asarray(g))
    tu = TP.Uzawa(omega=0.5, rtol=1e-7, maxiter=200).setup(ts, device="cpu")
    tu_u, tu_p, ti = tu.solve(torch.from_numpy(f), torch.from_numpy(g))
    assert bool(ti.converged) and bool(ji.converged)
    assert int(ti.iterations) == int(ji.iterations)
    assert rel_close(tu_u, ju_u, 1e-8) and rel_close(tu_p, ju_p, 1e-8)


# The reference's Uzawa on make_saddle(48) (setup_backend="jax", float64,
# f = 1, g = 0, omega 0.5, rtol 1e-7, maxiter 200), recorded: the run
# costs ~15 s of one worker. Its A11 BoomerAMG has two levels there (2304
# rows, an 846-row coarse inverse), so two V-cycles are no longer a direct
# solve, and the iteration stalls.
UZAWA_48_REFERENCE = dict(iterations=200, converged=False,
                          relative_residual=0.036941173274281404)


def test_uzawa_stalls_past_38_squared_as_the_reference_does(saddle):
    """ROADMAP Queue 3's "Uzawa stalls past 38^2" is the reference's
    behaviour: at 48^2 the port's Uzawa stalls where the reference's
    does, at the same residual."""
    js = make_saddle(48)
    ts = saddle_from_numpy({k: None if getattr(js, k) is None else
                            mat_dict(getattr(js, k))
                            for k in ("A", "B", "Bt", "C")}, device="cpu")
    tu = TP.Uzawa(omega=0.5, rtol=1e-7, maxiter=200).setup(ts, device="cpu")
    assert len(tu.amg.hierarchy.levels) == 1
    assert tu.amg.hierarchy.coarse_inv.shape == (846, 846)
    _, _, ti = tu.solve(torch.ones(js.n_u, dtype=torch.float64),
                        torch.zeros(js.n_p, dtype=torch.float64))
    ref = UZAWA_48_REFERENCE
    assert int(ti.iterations) == ref["iterations"]
    assert bool(ti.converged) == ref["converged"]
    assert abs(float(ti.relative_residual) - ref["relative_residual"]) \
        <= 1e-6 * ref["relative_residual"]


def test_schur_reduction_solve(saddle):
    """HYPRE_LSI_schur.cxx's reduced system: PCG on S p, then u."""
    js, _, jb, ts = saddle
    f, g = np.ones(js.n_u), np.zeros(js.n_p)
    jb6 = j_saddle.BlockPrecond(inner_cycles=6)
    jb6.sys, jb6.amg, jb6.S, jb6.s_dinv = js, jb.amg, jb.S, jb.s_dinv
    ju, jp, ji = jb6.solve_reduced(jnp.asarray(f), jnp.asarray(g), rtol=1e-8)
    tb = TP.BlockPrecond(inner_cycles=6).setup(ts, device="cpu")
    tu, tp, ti = tb.solve_reduced(torch.from_numpy(f), torch.from_numpy(g),
                                  rtol=1e-8)
    assert int(ti.iterations) == int(ji.iterations)
    assert rel_close(tu, ju, 1e-8) and rel_close(tp, jp, 1e-8)
