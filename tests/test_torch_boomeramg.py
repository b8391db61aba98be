"""hypre_tpu_torch's BoomerAMG facade and the AMG modules under it against
hypre_tpu's, in float64 on the CPU.

- Every coarsening's CF split on a 2-D 5-pt and a 3-D 7-pt Laplacian is
  the reference's, exactly.
- Every interpolation's P has the reference's pattern exactly and its
  values to 1e-12; so has the AIR restriction R.
- Each smoother sweep, the W and F cycles, the transpose cycle, the three
  additive cycles and the AIR cycle, run on the reference's own hierarchy
  (carried across by ``hierarchy_from_numpy``), match to 1e-10.
- The facade takes the reference facade's iteration counts
  (``setup_backend="jax"``) for the knob sets of ``test_amg2.py``.
- A hierarchy whose coarse levels are banded without their ELL payload
  runs the Gauss-Seidel, Kaczmarz and transpose paths and equals the
  plain hierarchy (the reference's facade fails there).

The reference's setups dominate this module's time (each new level shape
compiles), so they are made once per module and shared.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.amg import BoomerAMG as JBoomerAMG
from hypre_tpu.amg import coarsen as j_coarsen, hierarchy as j_hier, \
    interp as j_interp
from hypre_tpu.amg.air import air_restriction as j_air
from hypre_tpu.amg.strength import strength_mask as j_strength
from hypre_tpu.krylov import gmres as j_gmres, pcg as j_pcg
from hypre_tpu.problems.laplacian import laplacian_2d_5pt as j_lap5, \
    laplacian_3d_7pt as j_lap7, stencil_to_ell as j_stencil

import hypre_tpu_torch as H
from hypre_tpu_torch.amg import coarsen as t_coarsen, interp as t_interp
from hypre_tpu_torch.amg.air import air_restriction as t_air
from hypre_tpu_torch.amg.strength import strength_mask as t_strength
from hypre_tpu_torch.problems.laplacian import stencil_to_ell as t_stencil
from hypre_tpu_torch.seq import fastmv
from torch_one_thread import one_torch_thread  # noqa: F401

MAX_COARSE = 20


def rel_close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max(initial=0.0) <= rtol * max(np.abs(b).max(), 1e-300)


def flatten(jh) -> dict:
    """A JAX AMGHierarchy as the dict of numpy arrays hierarchy_from_numpy
    takes."""
    def mat(M):
        if M is None:
            return None
        return {"vals": np.asarray(M.vals), "cols": np.asarray(M.cols),
                "n_cols": M.n_cols, "shifts": M.shifts}

    return {
        "levels": [{"A": mat(lv.A), "P": mat(lv.P), "Pt": mat(lv.Pt),
                    "dinv": np.asarray(lv.dinv),
                    "l1inv": np.asarray(lv.l1inv),
                    "lmax": np.asarray(lv.lmax), "cf": np.asarray(lv.cf),
                    "rw": None if lv.rw is None else np.asarray(lv.rw)}
                   for lv in jh.levels],
        "coarse_inv": np.asarray(jh.coarse_inv),
        "galerkin": jh.galerkin,
    }


PROBLEMS = {
    "5pt-16": (lambda: j_lap5(16, 16),
               lambda: H.laplacian_2d_5pt(16, 16, dtype=torch.float64,
                                          device="cpu")),
    "7pt-8": (lambda: j_lap7(8, 8, 8),
              lambda: H.laplacian_3d_7pt(8, 8, 8, dtype=torch.float64,
                                         device="cpu")),
}


@pytest.fixture(scope="module")
def split_inputs():
    """(jax A, jax S, port A, port S) per problem."""
    out = {}
    for name, (jf, tf) in PROBLEMS.items():
        jA, tA = jf(), tf()
        jS, tS = j_strength(jA, 0.25), t_strength(tA, 0.25)
        assert np.array_equal(np.asarray(jS), tS.numpy())
        out[name] = (jA, jS, tA, tS)
    return out


@pytest.fixture(scope="module")
def lap16():
    """The 16x16 5-pt problem with the reference facade's hierarchy
    (pure setup, PMIS, ext+i, Chebyshev), shared by the cycle and facade
    tests, and the port's copy of it."""
    jA = j_lap5(16, 16)
    tA = H.laplacian_2d_5pt(16, 16, dtype=torch.float64, device="cpu")
    ja = JBoomerAMG(setup_backend="jax", max_coarse_size=MAX_COARSE).setup(jA)
    th = H.hierarchy_from_numpy(flatten(ja.hierarchy), device="cpu")
    b = np.random.default_rng(21).standard_normal(jA.n_rows)
    return jA, tA, ja, th, b


COARSENINGS = ["pmis", "cljp", "ruge_stuben", "hmis", "cr", "cgc"]


@pytest.mark.parametrize("problem", list(PROBLEMS))
@pytest.mark.parametrize("fn", COARSENINGS)
def test_cf_split_is_the_reference_split(split_inputs, problem, fn):
    jA, jS, tA, tS = split_inputs[problem]
    jcf = np.asarray(getattr(j_coarsen, fn)(jA, jS))
    tcf = getattr(t_coarsen, fn)(tA, tS)
    assert tcf.dtype == torch.int32 and tcf.device.type == "cpu"
    assert np.array_equal(tcf.numpy(), jcf)
    assert 0 < int((tcf == 1).sum()) < tA.n_rows


INTERPS = ["direct_interp", "classical_interp", "multipass_interp",
           "jacobi_improved"]


@pytest.mark.parametrize("problem", list(PROBLEMS))
@pytest.mark.parametrize("kind", INTERPS)
def test_interpolation_is_the_reference_p(split_inputs, problem, kind):
    jA, jS, tA, tS = split_inputs[problem]
    # RS splits leave the distance-1 interpolations well posed
    jcf, tcf = j_coarsen.ruge_stuben(jA, jS), t_coarsen.ruge_stuben(tA, tS)
    jcm, jnc = j_coarsen.coarse_map(jcf)
    tcm, tnc = t_coarsen.coarse_map(tcf)
    assert int(tnc) == int(jnc)
    if kind == "jacobi_improved":
        jP = j_interp.jacobi_improve_interp(
            jA, j_interp.direct_interp(jA, jS, jcf, jcm, int(jnc)), jcf,
            passes=2, max_elmts=6)
        tP = t_interp.jacobi_improve_interp(
            tA, t_interp.direct_interp(tA, tS, tcf, tcm, int(tnc)), tcf,
            passes=2, max_elmts=6)
    else:
        jP = getattr(j_interp, kind)(jA, jS, jcf, jcm, int(jnc))
        tP = getattr(t_interp, kind)(tA, tS, tcf, tcm, int(tnc))
    assert (tP.k, tP.n_cols) == (jP.k, jP.n_cols)
    assert np.array_equal(tP.cols.numpy(), np.asarray(jP.cols))
    assert rel_close(tP.vals, jP.vals, 1e-12)


SMOOTHERS = [("jacobi", 0.7, 0), ("jacobi", 0.7, 1), ("l1-jacobi", 1.0, 1),
             ("chebyshev", 1.0, 0), ("two-stage-gs", 1.0, 0),
             ("sym-two-stage-gs", 1.0, 0), ("kaczmarz", 0.5, 0)]


@pytest.mark.parametrize("relax,weight,order", SMOOTHERS)
def test_smoother_sweep_on_every_level(lap16, relax, weight, order):
    _, _, ja, th, _ = lap16
    j_sm = j_hier.make_smoother(relax, weight, 3, 0.3, relax_order=order)
    t_sm = H.make_smoother(relax, weight, 3, 0.3, relax_order=order)
    rng = np.random.default_rng(22)
    for jl, tl in zip(ja.hierarchy.levels, th.levels):
        f, u = rng.standard_normal((2, tl.A.n_rows))
        ref = np.asarray(j_sm(jl, jnp.asarray(u), jnp.asarray(f)))
        got = t_sm(tl, torch.from_numpy(u), torch.from_numpy(f))
        assert rel_close(got, ref, 1e-10)


CYCLES = ["W", "F", "T", "additive", "mult", "simple", "additive-from-1"]


@pytest.mark.parametrize("cycle", CYCLES)
def test_cycle_on_reference_hierarchy(lap16, cycle):
    _, _, ja, th, b = lap16
    jh = ja.hierarchy
    u0 = np.random.default_rng(23).standard_normal(b.shape[0])
    jf, ju = jnp.asarray(b), jnp.asarray(u0)
    tf, tu = torch.from_numpy(b), torch.from_numpy(u0)
    j_sm = j_hier.make_smoother("l1-jacobi", 1.0, 2, 0.3)
    t_sm = H.make_smoother("l1-jacobi", 1.0, 2, 0.3)
    if cycle in ("W", "F"):
        ct = 2 if cycle == "W" else 3
        ref = j_hier.amg_cycle(jh, jf, ju, smoother=j_sm, cycle_type=ct,
                               num_sweeps=2)
        got = H.amg_cycle(th, tf, tu, smoother=t_sm, cycle_type=ct,
                          num_sweeps=2)
    elif cycle == "T":
        ref = j_hier.amg_cycle_t(jh, jf, ju, relax_weight=0.8)
        got = H.amg_cycle_t(th, tf, tu, relax_weight=0.8)
    else:
        variant, start = (("additive", 1) if cycle == "additive-from-1"
                          else (cycle, 0))
        ref = j_hier.amg_additive_cycle(jh, jf, ju, smoother=j_sm,
                                        add_start=start, variant=variant)
        got = H.amg_additive_cycle(th, tf, tu, smoother=t_sm,
                                   add_start=start, variant=variant)
    assert rel_close(got, np.asarray(ref), 1e-10)


# the knob sets of test_amg2.py that keep the PMIS/ext+i hierarchy
SOLVE_KNOBS = [dict(), dict(cycle_type=2), dict(cycle_type=3),
               dict(relax="l1-jacobi"), dict(relax="sym-two-stage-gs"),
               dict(relax="l1-jacobi", relax_order=1),
               dict(additive=0, additive_variant="additive",
                    relax="l1-jacobi"),
               dict(additive=0, additive_variant="mult", relax="l1-jacobi"),
               dict(additive=0, additive_variant="simple",
                    relax="l1-jacobi"),
               dict(additive=1, relax="l1-jacobi"),
               dict(relax="two-stage-gs", num_sweeps=2),
               dict(relax="kaczmarz", relax_weight=0.5, num_sweeps=2)]
# knob sets that change what the setup computes: the reference runs its
# whole setup for them (RS + classical on one level: the interpolation
# test compiled its shapes)
SETUP_KNOBS = [dict(cheby_eig_est=10), dict(relax="jacobi", relax_weight=-10.0),
               dict(coarsen_type="ruge", interp="classical",
                    max_coarse_size=150)]


def knob_id(kw):
    return ",".join(f"{k}={v}" for k, v in kw.items()) or "default"


@pytest.mark.parametrize("kw", SOLVE_KNOBS + SETUP_KNOBS,
                         ids=[knob_id(k) for k in SOLVE_KNOBS + SETUP_KNOBS])
def test_facade_takes_the_reference_iterations(lap16, kw):
    """GMRES for the one-sided smoothers (their cycle is not symmetric),
    PCG otherwise, at rtol 1e-8."""
    jA, tA, ja_shared, _, b = lap16
    if kw in SOLVE_KNOBS:
        # the reference's setup would rebuild the shared hierarchy: bind
        # its smoother to that hierarchy instead, as its setup does
        ja = JBoomerAMG(setup_backend="jax", max_coarse_size=MAX_COARSE, **kw)
        ja.hierarchy = ja_shared.hierarchy
        ja._smoother = j_hier.make_smoother(
            ja.relax, ja.relax_weight, ja.cheby_order, ja.cheby_ratio,
            relax_order=ja.relax_order)
    else:
        kw = dict(dict(max_coarse_size=MAX_COARSE), **kw)
        ja = JBoomerAMG(setup_backend="jax", **kw).setup(jA)
    ta = H.BoomerAMG(setup_backend="jax",
                     **dict(dict(max_coarse_size=MAX_COARSE), **kw)).setup(
        tA, device="cpu")
    assert [lv.A.n_rows for lv in ta.hierarchy.levels] == \
        [lv.A.n_rows for lv in ja.hierarchy.levels]
    one_sided = kw.get("relax") in ("two-stage-gs", "kaczmarz")
    j_solver, t_solver = (j_gmres, H.gmres) if one_sided else (j_pcg, H.pcg)
    jx, ji = j_solver(jA.mv, jnp.asarray(b), M=ja.precond(), rtol=1e-8,
                      maxiter=100)
    tx, ti = t_solver(tA.mv, torch.from_numpy(b), M=ta.precond(), rtol=1e-8,
                      maxiter=100, device="cpu")
    assert bool(ti.converged) and bool(ji.converged)
    assert int(ti.iterations) == int(ji.iterations)
    assert rel_close(tx, jx, 1e-8)


@pytest.mark.parametrize("smooth_type", ["fsai", "ilu", "schwarz"])
def test_smooth_type_matches_the_reference(lap16, monkeypatch, smooth_type):
    """hypre's complex level smoothers (-smtype) on the first two levels,
    l1-Jacobi below: the reference facade's own setup binds them to the
    shared hierarchy (its _do_setup replaced); the port's facade builds
    the same levels, the same cycle to 1e-10 and, for FSAI and Schwarz,
    PCG's iterations (ILU's count is pinned by the ij driver's golden,
    tests/test_torch_ij_driver.py, since the reference's ILU-preconditioned
    solves are slow on the CPU)."""
    jA, tA, ja_shared, _, b = lap16

    def shared_setup(self, A):
        self.hierarchy = ja_shared.hierarchy
        self._setup_As = [lv.A for lv in self.hierarchy.levels]

    monkeypatch.setattr(JBoomerAMG, "_do_setup", shared_setup)
    kw = dict(max_coarse_size=MAX_COARSE, relax="l1-jacobi",
              smooth_type=smooth_type, smooth_num_levels=2,
              smooth_weight=0.7 if smooth_type == "schwarz" else 1.0)
    ja = JBoomerAMG(setup_backend="jax", **kw).setup(jA)
    ta = H.BoomerAMG(setup_backend="jax", **kw).setup(tA, device="cpu")
    assert [lv.A.n_rows for lv in ta.hierarchy.levels] == \
        [lv.A.n_rows for lv in ja.hierarchy.levels]
    assert len(ta.hierarchy.levels) > 2 and isinstance(ta._smoother, list)
    assert rel_close(ta.cycle(torch.from_numpy(b)), ja.cycle(jnp.asarray(b)),
                     1e-10)
    if smooth_type == "ilu":
        return
    jx, ji = j_pcg(jA.mv, jnp.asarray(b), M=ja.precond(), rtol=1e-8,
                   maxiter=100)
    tx, ti = H.pcg(tA.mv, torch.from_numpy(b), M=ta.precond(), rtol=1e-8,
                   maxiter=100, device="cpu")
    assert bool(ti.converged) and bool(ji.converged)
    assert int(ti.iterations) == int(ji.iterations)
    assert rel_close(tx, jx, 1e-8)


def test_facade_solve_and_solve_t_take_the_reference_iterations(lap16):
    jA, tA, ja_shared, _, b = lap16
    ja = JBoomerAMG(setup_backend="jax", max_coarse_size=MAX_COARSE,
                    relax="jacobi", relax_weight=0.8)
    ja.hierarchy = ja_shared.hierarchy
    ja._smoother = j_hier.make_smoother("jacobi", 0.8, 2, 0.3)
    ta = H.BoomerAMG(setup_backend="jax", max_coarse_size=MAX_COARSE,
                     relax="jacobi", relax_weight=0.8).setup(tA, device="cpu")
    for j_fn, t_fn in ((ja.solve, ta.solve), (ja.solveT, ta.solveT)):
        jx, ji = j_fn(jnp.asarray(b), rtol=1e-8, maxiter=60)
        tx, ti = t_fn(torch.from_numpy(b), rtol=1e-8, maxiter=60)
        assert bool(ti.converged)
        assert int(ti.iterations) == int(ji.iterations)
        assert rel_close(tx, jx, 1e-8)
    assert ta.stats().splitlines()[1].split()[:2] == ["0", str(tA.n_rows)]


def test_air_restriction_and_cycle_match_the_reference():
    """AIR on an upwind advection-diffusion operator (the reference's own
    AIR test problem at 10x10): R, the non-Galerkin hierarchy's cycle and
    the GMRES count."""
    n, eps = 10, 1e-3
    offsets = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
    coeffs = [4 * eps + 1.0, -eps - 1.0, -eps, -eps, -eps]
    jA = j_stencil((n, n), offsets, coeffs)
    tA = t_stencil((n, n), offsets, coeffs, torch.float64, "cpu")
    jS, tS = j_strength(jA, 0.25), t_strength(tA, 0.25)
    jcf, tcf = j_coarsen.pmis(jA, jS), t_coarsen.pmis(tA, tS)
    jcm, jnc = j_coarsen.coarse_map(jcf)
    tcm, tnc = t_coarsen.coarse_map(tcf)
    jR = j_air(jA, jS, jcf, jcm, int(jnc))
    tR = t_air(tA, tS, tcf, tcm, int(tnc))
    assert np.array_equal(tR.cols.numpy(), np.asarray(jR.cols))
    assert rel_close(tR.vals, jR.vals, 1e-12)

    # one level: AIR coarsens slowly, and every level shape compiles
    kw = dict(relax="l1-jacobi", restrict_type="air", interp="direct",
              max_coarse_size=70)
    ja = JBoomerAMG(setup_backend="jax", **kw).setup(jA)
    ta = H.BoomerAMG(setup_backend="jax", **kw).setup(tA, device="cpu")
    assert not ta.hierarchy.galerkin and len(ta.hierarchy.levels) >= 1
    th = H.hierarchy_from_numpy(flatten(ja.hierarchy), device="cpu")
    f = np.random.default_rng(24).standard_normal(n * n)
    sm = H.make_smoother("l1-jacobi", 1.0, 2, 0.3)
    ref = j_hier.amg_cycle(ja.hierarchy, jnp.asarray(f),
                           smoother=j_hier.make_smoother("l1-jacobi", 1.0, 2,
                                                         0.3))
    assert rel_close(H.amg_cycle(th, torch.from_numpy(f), smoother=sm),
                     np.asarray(ref), 1e-10)
    b = np.ones(n * n)
    jx, ji = j_gmres(jA.mv, jnp.asarray(b), M=ja.precond(), rtol=1e-8,
                     maxiter=300)
    tx, ti = H.gmres(tA.mv, torch.from_numpy(b), M=ta.precond(), rtol=1e-8,
                     maxiter=300, device="cpu")
    assert bool(ti.converged)
    assert int(ti.iterations) == int(ji.iterations)
    with pytest.raises(ValueError, match="Galerkin"):
        ta.solveT(torch.from_numpy(b))


def _banded_any_dtype(A, block=None, max_window=131072, exact=1):
    """try_banded without its float32 gate (the kernels are float32; the
    plain versions that run on the CPU are not), so that the banded
    formats can be held to float64 parity."""
    n_pad = -(-A.n_rows // 1024) * 1024
    vt, lt, lo, sc = fastmv._banded_sched_payload(A.vals, A.cols, 1024, n_pad)
    wmax, lomax = (int(v) for v in sc.tolist())
    return fastmv.banded_from_sched(A, vt, lt, lo, wmax, lomax, exact=exact)


@pytest.mark.parametrize("relax,weight,solve", [
    ("two-stage-gs", 1.0, "gmres"), ("sym-two-stage-gs", 1.0, "pcg"),
    ("kaczmarz", 0.5, "gmres"), ("jacobi", 0.8, "solveT")])
def test_banded_levels_without_ell_run_every_smoother(monkeypatch, relax,
                                                      weight, solve):
    """The reference's optimize_hierarchy drops the ELL payload of its
    banded levels, after which its two-stage GS and Kaczmarz fail (they
    read A.ell) and its transpose cycle has no A.mv_t. The port's banded
    format answers all of them from its own payload and schedule: the
    optimized hierarchy gives the plain one's cycle (1e-10) and count."""
    monkeypatch.setattr(fastmv, "MIN_BANDED_ELEMENTS", 0)
    monkeypatch.setattr(fastmv, "try_banded", _banded_any_dtype)
    A = H.laplacian_3d_7pt(10, 10, 10, dtype=torch.float64, device="cpu")
    b = torch.from_numpy(np.random.default_rng(25).standard_normal(A.n_rows))
    out = []
    for optimize in (False, True):
        amg = H.BoomerAMG(relax=relax, relax_weight=weight,
                          max_coarse_size=50).setup(A, optimize=optimize,
                                                    device="cpu")
        coarse = [lv.A for lv in amg.hierarchy.levels[1:]]
        if optimize:
            assert coarse and all(isinstance(M, H.BandedEll) and M.ell is None
                                  for M in coarse)
        if solve == "solveT":
            x, info = amg.solveT(b, rtol=1e-10, maxiter=100)
            cyc = amg.cycleT(b)
        else:
            fn = H.gmres if solve == "gmres" else H.pcg
            x, info = fn(A.mv, b, M=amg.precond(), rtol=1e-10, maxiter=200,
                         device="cpu")
            cyc = amg.cycle(b)
        assert bool(info.converged)
        out.append((int(info.iterations), cyc, x))
    assert out[0][0] == out[1][0]
    assert rel_close(out[1][1], out[0][1], 1e-10)
    assert rel_close(out[1][2], out[0][2], 1e-8)


def test_facade_options_that_stay_unported_raise():
    tA = H.laplacian_2d_5pt(8, 8, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="smooth_type"):
        H.BoomerAMG(smooth_type="pilut", smooth_num_levels=1).setup(
            tA, device="cpu")
    # aggressive coarsening stays unported on the pure setup; the host C++
    # setup (ported) runs it, and 'auto' takes that
    with pytest.raises(NotImplementedError, match="native"):
        H.BoomerAMG(setup_backend="jax", agg_num_levels=1,
                    max_coarse_size=10).setup(tA, device="cpu")
    amg = H.BoomerAMG(agg_num_levels=1, max_coarse_size=10).setup(
        tA, device="cpu")
    assert amg.setup_path == "native" and len(amg.hierarchy.levels) >= 1


def test_cg_weights_survive_a_second_setup_and_reach_cycle_t():
    """relax_weight < 0 asks for per-level CG-estimated Jacobi weights.
    The reference overwrites the knob with 1.0 in its first setup, so a
    second setup on the same object builds no weights (12^3: rw 0.515 /
    0.746 / 0.800, then None on every level), and its cycleT runs weight
    1.0 whatever the levels hold. The port keeps the knob, builds the
    weights at every setup, and its transpose cycle uses them: on a
    symmetric A it is the forward cycle."""
    tA = H.laplacian_3d_7pt(12, 12, 12, dtype=torch.float64, device="cpu")
    amg = H.BoomerAMG(max_coarse_size=50, relax="jacobi", relax_weight=-10.0)
    weights = []
    for _ in range(2):
        amg.setup(tA, device="cpu")
        weights.append([round(float(lv.rw), 3) for lv in amg.hierarchy.levels])
    assert weights == [[0.515, 0.746, 0.8]] * 2
    assert amg.relax_weight == -10.0
    f = torch.from_numpy(np.random.default_rng(0).standard_normal(12 ** 3))
    fwd, bwd = amg.cycle(f), amg.cycleT(f)
    assert rel_close(bwd, fwd, 1e-12)
    plain = H.amg_cycle_t(amg.hierarchy, f, relax_weight=1.0)
    assert rel_close(plain, fwd, 1e-12)  # lev.rw wins over the argument
    unweighted = dataclasses.replace(amg.hierarchy, levels=[
        dataclasses.replace(lv, rw=None) for lv in amg.hierarchy.levels])
    assert not rel_close(H.amg_cycle_t(unweighted, f, relax_weight=1.0),
                         fwd, 1e-3)
