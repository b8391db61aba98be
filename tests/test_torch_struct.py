"""hypre_tpu_torch's struct layer against hypre_tpu's, in float64 on the CPU.

The same numpy inputs go through each reference function and its port:

- ``struct_matvec`` and ``struct_matvec_t`` on constant, variable,
  periodic and random (nonzero boundary coefficients) operators in 2-D and
  3-D, and the DIA view's ``mv`` and ``mv_t`` (what the card runs)
  against them: 1e-12;
- ``probe_stencil`` on ``semi_rap_apply`` and the semicoarsening transfers:
  1e-12; ``pcr_solve``: 1e-10; one Jacobi and one RB-GS sweep: 1e-12;
- the PFMG hierarchy at 16^2 (also periodic in x) and 8^3 (cdir sequence,
  offsets, coefficients, coarse pseudo-inverse) and one V-cycle; SMG's
  2-D hierarchy and one cycle at 16^2; SparseMSG's lattice and one cycle
  at 16^2: 1e-10;
- the struct IO round trip, files written by one package and read by the
  other: exact.

The reference is called at <= 16^2 and <= 8^3 only, with one reference
hierarchy per solver shared by the module; its 3-D SMG is never called
(its nested plane-SMG program compiles for 40-80 s). The port's 3-D SMG
runs in ``test_torch_struct_driver.py`` against recorded goldens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hypre_tpu.problems import struct_problems as j_problems
from hypre_tpu.struct import cycred as j_cycred
from hypre_tpu.struct import io as j_io
from hypre_tpu.struct import matrix as j_matrix
from hypre_tpu.struct import probe as j_probe
from hypre_tpu.struct import relax as j_relax
from hypre_tpu.struct import semi as j_semi
from hypre_tpu.struct.pfmg import PFMG as JPFMG
from hypre_tpu.struct.smg import SMG as JSMG
from hypre_tpu.struct.sparse_msg import SparseMSG as JSparseMSG

from hypre_tpu_torch.convert import struct_from_numpy
from hypre_tpu_torch.problems import struct_problems as t_problems
from hypre_tpu_torch.seq import dia
from hypre_tpu_torch.struct import cycred, io, matrix, probe, relax, semi
from hypre_tpu_torch.struct.pfmg import PFMG
from hypre_tpu_torch.struct.smg import SMG
from hypre_tpu_torch.struct.sparse_msg import SparseMSG
from torch_one_thread import one_torch_thread  # noqa: F401

F64 = torch.float64


def close(a, b, tol):
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max(initial=0.0)
    assert err <= tol * max(np.abs(b).max(initial=0.0), 1e-300), err


def carry(A):
    """The reference StructMatrix as the port's, on the CPU."""
    return struct_from_numpy(np.asarray(A.coeffs), A.stencil.offsets,
                             A.shape, A.periodic, device="cpu")


def rand(shape, seed, lead=()):
    return np.random.default_rng(seed).standard_normal(lead + tuple(shape))


def t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


# (label, a function that makes the reference StructMatrix)
OPERATORS = [
    ("const2d", lambda: j_problems.struct_laplacian((9, 7))),
    ("var2d", lambda: j_problems.struct_laplacian(
        (9, 7), weights=(1.0, 0.3), constant=False)),
    ("periodic2d", lambda: j_problems.struct_laplacian(
        (8, 6), periodic=(True, False))),
    ("periodic2d_both", lambda: j_problems.struct_laplacian(
        (8, 6), periodic=(True, True), constant=False)),
    ("random2d", lambda: j_problems.random_struct_matrix((7, 6), seed=3)),
    ("const3d", lambda: j_problems.struct_laplacian((5, 4, 6))),
    ("periodic3d", lambda: j_problems.struct_laplacian(
        (4, 5, 6), periodic=(False, True, True))),
    ("random3d", lambda: j_problems.random_struct_matrix((5, 4, 3), seed=4)),
    ("random2d_ext2", lambda: j_problems.random_struct_matrix(
        (7, 6), extent=2, seed=5)),
]


@pytest.mark.parametrize("label,make", OPERATORS,
                         ids=[o[0] for o in OPERATORS])
def test_struct_matvec_and_dia_view_match_reference(label, make):
    JA = make()
    A = carry(JA)
    x = rand(A.shape, 1)
    want = np.asarray(j_matrix.struct_matvec(JA, jnp.asarray(x)))
    close(matrix.struct_matvec(A, t(x)), want, 1e-12)
    close(A.mv(t(x)), want, 1e-12)  # the DIA view
    close(A.mv(t(x).reshape(-1)), want.reshape(-1), 1e-12)
    want_t = np.asarray(j_matrix.struct_matvec_t(JA, jnp.asarray(x)))
    close(matrix.struct_matvec_t(A, t(x)), want_t, 1e-12)
    close(A.mv_t(t(x)), want_t, 1e-12)  # the DIA view's transpose
    # a leading batch of vectors, one DIA launch each
    xb = rand(A.shape, 2, lead=(3,))
    close(A.mv(t(xb)), np.stack([np.asarray(j_matrix.struct_matvec(
        JA, jnp.asarray(v))) for v in xb]), 1e-12)
    close(A.to_dense(), np.asarray(JA.to_dense()), 1e-12)


def test_dia_view_layout():
    """One plane per stencil entry, two per entry that moves along a
    periodic dim (in the box and wrapped), in stencil order; the static
    kernel's offsets when D is on its ladder."""
    A = t_problems.struct_laplacian((8, 6), dtype=F64, device="cpu")
    D = A.dia
    assert D.offsets.tolist() == [0, -6, 6, -1, 1]
    assert D.offsets_static == (0, -6, 6, -1, 1)
    assert torch.equal(D.dvals[1].reshape(8, 6)[0], torch.zeros(6, dtype=F64))
    assert A.dia is D  # built once per operator
    P = t_problems.struct_laplacian((8, 6), periodic=(True, False),
                                    dtype=F64, device="cpu")
    assert P.dia.offsets.tolist() == [0, -6, 42, 6, -42, -1, 1]
    planes = P.dia.dvals.reshape(7, 8, 6)
    assert bool((planes[1][1:] == -1).all()) and bool((planes[1][0] == 0).all())
    assert bool((planes[2][0] == -1).all()) and bool((planes[2][1:] == 0).all())
    view = matrix.dia_view(P, specialize=False)
    assert view.offsets_static is None
    x = torch.from_numpy(rand(P.shape, 3))
    assert torch.equal(view.mv(x.reshape(-1)), P.dia.mv(x.reshape(-1)))
    assert torch.equal(P.mv(x), matrix.struct_matvec(P, x))
    assert dia.on_static_ladder(48) and dia.on_static_ladder(64)
    assert not dia.on_static_ladder(49) and not dia.on_static_ladder(97)


def test_mv_checks_the_vector_shape():
    A = t_problems.struct_laplacian((4, 4), dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        A.mv(torch.zeros(5, dtype=F64))


@pytest.mark.parametrize("shape,cdir,periodic", [
    ((9, 8), 0, None), ((9, 8), 1, None), ((8, 6), 0, (True, False)),
    ((5, 6, 7), 2, None)])
def test_semi_interp_matches_reference(shape, cdir, periodic):
    JA = j_problems.random_struct_matrix(shape, seed=7)
    if periodic:
        JA = j_matrix.StructMatrix(coeffs=JA.coeffs, stencil=JA.stencil,
                                   shape=JA.shape, periodic=periodic)
    A = carry(JA)
    JP = j_semi.semi_interp_from_matrix(JA, cdir)
    P = semi.semi_interp_from_matrix(A, cdir)
    close(P.w_lo, np.asarray(JP.w_lo), 1e-12)
    close(P.w_hi, np.asarray(JP.w_hi), 1e-12)
    xc = rand(P.coarse_shape, 8)
    close(P.apply(t(xc)), np.asarray(JP.apply(jnp.asarray(xc))), 1e-12)
    r = rand(shape, 9)
    close(P.apply_t(t(r)), np.asarray(JP.apply_t(jnp.asarray(r))), 1e-12)


@pytest.mark.parametrize("shape,cdir,periodic", [
    ((10, 9), 0, (False, False)), ((8, 9), 1, (False, False)),
    ((12, 6), 0, (True, False)), ((6, 5, 4), 2, (False, False, False))])
def test_probe_stencil_on_semi_rap_matches_reference(shape, cdir, periodic):
    JA = j_problems.random_struct_matrix(shape, seed=11)
    JA = j_matrix.StructMatrix(coeffs=JA.coeffs, stencil=JA.stencil,
                               shape=JA.shape, periodic=periodic)
    A = carry(JA)
    JP = j_semi.semi_interp_from_matrix(JA, cdir)
    P = semi.semi_interp_from_matrix(A, cdir)
    cshape = semi.coarse_shape(shape, cdir)
    ext = (1,) * len(shape)
    want = j_probe.probe_stencil(j_probe.semi_rap_apply, cshape, ext,
                                 JA.dtype, periodic=periodic,
                                 operands=(JA, JP))
    got = probe.probe_stencil(probe.semi_rap_apply, cshape, ext, F64,
                              periodic=periodic, operands=(A, P),
                              device="cpu")
    assert got.stencil.offsets == want.stencil.offsets
    close(got.coeffs, np.asarray(want.coeffs), 1e-12)
    assert probe.probe_plan(cshape, ext, periodic) == \
        j_probe.probe_plan(cshape, ext, periodic)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 17, 33])
def test_pcr_solve_matches_reference(n):
    rng = np.random.default_rng(n)
    a, c, d = (rng.standard_normal((4, n)) for _ in range(3))
    b = 4.0 + np.abs(rng.standard_normal((4, n)))
    want = np.asarray(j_cycred.pcr_solve(*(jnp.asarray(v)
                                           for v in (a, b, c, d))))
    close(cycred.pcr_solve(t(a), t(b), t(c), t(d)), want, 1e-10)


def test_cyclic_reduction_matches_reference():
    JA = j_problems.struct_laplacian((37,))
    b = rand((37,), 11)
    want = np.asarray(j_cycred.cyclic_reduction_solve(JA, jnp.asarray(b)))
    close(cycred.cyclic_reduction_solve(carry(JA), t(b)), want, 1e-10)


@pytest.mark.parametrize("shape", [(9, 8), (5, 6, 4)])
def test_relax_sweeps_match_reference(shape):
    JA = j_problems.struct_laplacian(shape, weights=(1.0, 0.5, 2.0)[
        :len(shape)], constant=False)
    A = carry(JA)
    u, f = rand(shape, 1), rand(shape, 2)
    jd = j_relax.diag_inverse(JA)
    d = relax.diag_inverse(A)
    close(d, np.asarray(jd), 1e-12)
    close(relax.weighted_jacobi(A, d, t(u), t(f)),
          np.asarray(j_relax.weighted_jacobi(JA, jd, jnp.asarray(u),
                                             jnp.asarray(f))), 1e-12)
    red = relax.parity_mask(shape, "cpu")
    assert np.array_equal(red.numpy(), j_relax.parity_mask(shape))
    close(relax.red_black_gs(A, d, red, t(u), t(f)),
          np.asarray(j_relax.red_black_gs(JA, jd, jnp.asarray(
              j_relax.parity_mask(shape)), jnp.asarray(u), jnp.asarray(f))),
          1e-12)


# -- the solvers' hierarchies, one reference setup each ----------------------

PFMG_CASES = {
    "16x16": lambda: j_problems.struct_laplacian((16, 16)),
    "16x16 periodic x": lambda: j_problems.struct_laplacian(
        (16, 16), periodic=(True, False)),
    "16x16 aniso": lambda: j_problems.struct_laplacian(
        (16, 16), weights=(1.0, 0.01)),
    "8x8x8": lambda: j_problems.struct_laplacian((8, 8, 8)),
}


@pytest.fixture(scope="module")
def pfmg_pairs():
    """{case: (reference PFMG, port PFMG, reference A)} set up once."""
    out = {}
    for label, make in PFMG_CASES.items():
        JA = make()
        relax_type = "jacobi" if "aniso" in label else "rb-gs"
        out[label] = (JPFMG(relax_type=relax_type).setup(JA),
                      PFMG(relax_type=relax_type).setup(carry(JA)), JA)
    return out


def hold_levels(jlevels, tlevels):
    assert len(tlevels) == len(jlevels)
    for jl, tl in zip(jlevels, tlevels):
        assert tl.A.shape == jl.A.shape
        assert tl.A.stencil.offsets == jl.A.stencil.offsets
        close(tl.A.coeffs, np.asarray(jl.A.coeffs), 1e-10)
        assert tl.P.cdir == jl.P.cdir
        close(tl.P.w_lo, np.asarray(jl.P.w_lo), 1e-10)
        close(tl.P.w_hi, np.asarray(jl.P.w_hi), 1e-10)


@pytest.mark.parametrize("label", list(PFMG_CASES))
def test_pfmg_hierarchy_and_cycle_match_reference(pfmg_pairs, label):
    jp, tp, JA = pfmg_pairs[label]
    jh, th = jp.hierarchy, tp.hierarchy
    assert th.cdirs == [lv.P.cdir for lv in jh.levels]
    hold_levels(jh.levels, th.levels)
    for jl, tl in zip(jh.levels, th.levels):
        close(tl.dinv, np.asarray(jl.dinv), 1e-10)
    assert th.coarse_shape == jh.coarse_shape
    close(th.coarse_inv, np.asarray(jh.coarse_inv), 1e-10)
    f, u = rand(JA.shape, 21), rand(JA.shape, 22)
    want = np.asarray(jax.jit(jp.cycle)(jnp.asarray(f), jnp.asarray(u)))
    close(tp.cycle(t(f), t(u)), want, 1e-10)
    z = tp.precond()(t(f - u).reshape(-1))  # raveled, from x = 0
    close(z, np.asarray(jax.jit(jp.cycle)(jnp.asarray(f - u))).reshape(-1),
          1e-10)


def test_pfmg_cdir_ties_break_to_the_lower_dim(pfmg_pairs):
    """Isotropic 2-D: dxyz ties at the first and third levels, and both
    packages take the lower dim (pfmg.py:152)."""
    th = pfmg_pairs["16x16"][1].hierarchy
    assert th.cdirs == [0, 1, 0]
    assert pfmg_pairs["16x16 aniso"][1].hierarchy.cdirs[:2] == [0, 0]


@pytest.fixture(scope="module")
def smg_pairs():
    out = {}
    for label, make in {
        "16x16": lambda: j_problems.struct_laplacian((16, 16)),
        "16x16 periodic x": lambda: j_problems.struct_laplacian(
            (16, 16), periodic=(True, False)),
    }.items():
        JA = make()
        out[label] = (JSMG().setup(JA), SMG().setup(carry(JA)), JA)
    return out


@pytest.mark.parametrize("label", ["16x16", "16x16 periodic x"])
def test_smg_2d_hierarchy_and_cycle_match_reference(smg_pairs, label):
    jp, tp, JA = smg_pairs[label]
    jh, th = jp.hierarchy, tp.hierarchy
    assert th.cdirs == [lv.P.cdir for lv in jh.levels]
    hold_levels(jh.levels, th.levels)
    close(th.coarse_inv, np.asarray(jh.coarse_inv), 1e-10)
    f, u = rand(JA.shape, 31), rand(JA.shape, 32)
    close(tp.cycle(t(f), t(u)),
          np.asarray(jp.cycle(jnp.asarray(f), jnp.asarray(u))), 1e-10)


@pytest.fixture(scope="module")
def msg_pair():
    JA = j_problems.struct_laplacian((16, 16), weights=(1.0, 0.1))
    return (JSparseMSG(jump=1).setup(JA), SparseMSG(jump=1).setup(carry(JA)),
            JA)


def test_sparse_msg_lattice_and_cycle_match_reference(msg_pair):
    jm, tm, JA = msg_pair
    assert tm._order == jm._order
    assert set(tm.P) == set(jm.P)
    for g in jm._order:
        assert tm.A[g].stencil.offsets == jm.A[g].stencil.offsets
        close(tm.A[g].coeffs, np.asarray(jm.A[g].coeffs), 1e-10)
    for key in jm.P:
        close(tm.P[key].w_lo, np.asarray(jm.P[key].w_lo), 1e-10)
    close(tm.coarse_inv, np.asarray(jm.coarse_inv), 1e-10)
    f = rand(JA.shape, 41)
    close(tm.cycle(t(f)), np.asarray(jax.jit(jm.cycle)(jnp.asarray(f))),
          1e-10)


# -- IO ----------------------------------------------------------------------


@pytest.mark.parametrize("constant", [True, False])
def test_struct_io_round_trip_across_packages(tmp_path, constant):
    JA = j_problems.struct_laplacian((6, 5), weights=(1.0, 0.7),
                                     constant=constant,
                                     periodic=(False, True))
    A = carry(JA)
    x = rand((6, 5), 3)
    # port writes, reference reads
    io.print_struct_matrix(str(tmp_path / "A.t"), A)
    io.print_struct_vector(str(tmp_path / "x.t"), t(x))
    B = j_io.read_struct_matrix(str(tmp_path / "A.t"), jnp.float64)
    assert B.stencil.offsets == JA.stencil.offsets
    assert B.shape == JA.shape and B.periodic == JA.periodic
    assert np.array_equal(np.asarray(B.coeffs), np.asarray(JA.coeffs))
    assert np.array_equal(np.asarray(j_io.read_struct_vector(
        str(tmp_path / "x.t"), jnp.float64)), x)
    # reference writes, port reads; both write the same bytes
    j_io.print_struct_matrix(str(tmp_path / "A.j"), JA)
    j_io.print_struct_vector(str(tmp_path / "x.j"), jnp.asarray(x))
    assert (tmp_path / "A.j").read_text() == (tmp_path / "A.t").read_text()
    assert (tmp_path / "x.j").read_text() == (tmp_path / "x.t").read_text()
    C = io.read_struct_matrix(str(tmp_path / "A.j"), F64, device="cpu")
    assert C.stencil.offsets == A.stencil.offsets
    assert C.shape == A.shape and C.periodic == A.periodic
    assert C.is_constant == constant
    assert torch.equal(C.coeffs, A.coeffs)
    assert torch.equal(io.read_struct_vector(str(tmp_path / "x.j"), F64,
                                             device="cpu"), t(x))


def test_problems_match_reference():
    for JA, A in (
        (j_problems.random_struct_matrix((5, 4, 3), seed=9),
         t_problems.random_struct_matrix((5, 4, 3), seed=9, dtype=F64,
                                         device="cpu")),
        (j_problems.struct_laplacian((4, 3), weights=(2.0, 0.5),
                                     constant=False),
         t_problems.struct_laplacian((4, 3), weights=(2.0, 0.5),
                                     constant=False, dtype=F64,
                                     device="cpu")),
        (j_problems.struct_laplacian((4, 3, 2)),
         t_problems.struct_laplacian((4, 3, 2), dtype=F64, device="cpu")),
    ):
        assert A.stencil.offsets == JA.stencil.offsets
        assert np.array_equal(A.coeffs.numpy(), np.asarray(JA.coeffs))
