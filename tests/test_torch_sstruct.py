"""hypre_tpu_torch's semi-structured layer against hypre_tpu's, in float64
on the CPU.

The same numpy inputs go through each reference function and its port:

- ``SStructMatrix.mv`` on the two-part problem at n = 8, against the
  reference's ``mv`` and against the monolithic strip (the reference
  test's permutation), and ``to_dense``: 1e-12;
- ``SysStructMatrix.mv`` (its flat DIA view) and the plain shifts at 5^2
  and 16^2: 1e-12; ``_probe_sys`` on one composite level: offsets equal,
  coefficients 1e-12; ``_node_block_inverse`` with a singular node:
  1e-12;
- SysPFMG's hierarchy at 16^2 (cdir sequence, offsets, coefficients,
  coarse pseudo-inverse) and one cycle with each relaxation: 1e-10; both
  packages' standalone SysPFMG fail alike on the driver's indefinite
  system at 24^2;
- one Split sweep with PFMG and SMG sub-solvers at n = 10: 1e-10;
- ``composite_poisson_2d`` and ``composite_poisson_nested``: exact; FAC's
  Galerkin operators (sorted by column): 1e-12 relative; one FAC cycle:
  1e-10;
- ``maxwell_grad``: exact; FEM assembly with Dirichlet rows: 1e-12; the
  SStruct IO round trip, each package reading the other's files: exact.

Both packages' FAC are given BoomerAMG(setup_backend="jax"), and the
reference's a numpy SpGEMM in place of its C++ one (monkeypatch), so
nothing here calls the reference's native library. One reference SysPFMG hierarchy is shared by
the module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu import native as j_native
from hypre_tpu.amg import BoomerAMG as JBoomerAMG
from hypre_tpu.drivers import sstruct as j_drv
from hypre_tpu.problems.struct_problems import struct_laplacian as j_lap
from hypre_tpu.seq.csr import HostCSR as JHostCSR
from hypre_tpu.seq.ell import EllMatrix as JEll, ell_to_csr as j_ell_to_csr
from hypre_tpu.sstruct import fac as j_fac
from hypre_tpu.sstruct import fem as j_fem
from hypre_tpu.sstruct import maxwell as j_maxwell
from hypre_tpu.sstruct import syspfmg as j_sys
from hypre_tpu.sstruct.grid import SStructGrid as JGrid
from hypre_tpu.sstruct.matrix import SStructMatrix as JSStructMatrix
from hypre_tpu.sstruct.split import SplitSolver as JSplit
from hypre_tpu.struct import io as j_io
from hypre_tpu.struct.matrix import struct_matvec as j_struct_matvec

import hypre_tpu_torch as H
from hypre_tpu_torch.convert import (
    ell_from_numpy, struct_from_numpy, sys_struct_from_numpy,
)
from hypre_tpu_torch.drivers import sstruct as drv
from hypre_tpu_torch.seq.dia import DiaMatrix
from hypre_tpu_torch.seq.ell import ell_to_csr
from hypre_tpu_torch.sstruct import fac, fem, maxwell, syspfmg
from hypre_tpu_torch.sstruct.grid import SStructGrid
from hypre_tpu_torch.sstruct.matrix import SStructMatrix
from hypre_tpu_torch.sstruct.split import SplitSolver
from hypre_tpu_torch.struct import io
from torch_one_thread import one_torch_thread  # noqa: F401

F64 = torch.float64


def close(a, b, tol):
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max(initial=0.0)
    assert err <= tol * max(np.abs(b).max(initial=0.0), 1e-300), err


def t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def carry_sstruct(JA):
    """The reference SStructMatrix as the port's, on the CPU."""
    parts = tuple(struct_from_numpy(np.asarray(P.coeffs), P.stencil.offsets,
                                    P.shape, P.periodic, device="cpu")
                  for P in JA.parts)
    U = None if JA.U is None else ell_from_numpy(
        np.asarray(JA.U.vals), np.asarray(JA.U.cols), JA.U.n_cols,
        device="cpu")
    return SStructMatrix(parts=parts, U=U,
                         grid=SStructGrid(JA.grid.part_shapes))


def carry_sys(JA):
    return sys_struct_from_numpy(np.asarray(JA.coeffs), JA.stencil.offsets,
                                 JA.shape, device="cpu")


def numpy_spgemm(n, m, Ap, Aj, Ax, Bp, Bj, Bx):
    """C = A B over CSR arrays, in numpy (the C++ routine's contract)."""
    A = JHostCSR(Ap, Aj, Ax, (n, int(Bp.shape[0]) - 1))
    B = JHostCSR(Bp, Bj, Bx, (int(Bp.shape[0]) - 1, m))
    C = A.matmat(B)
    return (C.indptr.astype(np.int32), C.indices.astype(np.int32),
            C.data.astype(np.float64))


# ---------------------------------------------------------------------------
# SStructMatrix
# ---------------------------------------------------------------------------


def test_sstruct_mv_matches_reference_and_monolithic_strip():
    n = 8
    jgrid, JA = j_drv._two_part_problem(n)
    A = carry_sstruct(JA)
    _, own = drv.two_part_problem(n, dtype=F64, device="cpu")
    xs = rand(2 * n * n, 0)
    want = np.asarray(JA.mv(jnp.asarray(xs)))
    close(A.mv(t(xs)), want, 1e-12)
    close(own.mv(t(xs)), want, 1e-12)
    # the monolithic (2n, n) strip, through the reference test's
    # permutation (mono index -> sstruct index)
    perm = np.zeros(2 * n * n, dtype=int)
    for i in range(2 * n):
        for j in range(n):
            part, ii = (0, i) if i < n else (1, i - n)
            perm[i * n + j] = A.grid.global_index(part, (ii, j))
    mono = np.asarray(j_struct_matvec(j_lap((2 * n, n)), jnp.asarray(
        xs[perm].reshape(2 * n, n)))).reshape(-1)
    close(own.mv(t(xs)).numpy()[perm], mono, 1e-12)
    # U takes a DIA view: the two diagonals at +-n^2 - n(n-1) = +-n
    assert isinstance(own.U_op, DiaMatrix)
    assert sorted(own.U_op.offsets.tolist()) == [-n, n]


def test_sstruct_to_dense_matches_reference():
    _, JA = j_drv._two_part_problem(6)
    close(carry_sstruct(JA).to_dense(), np.asarray(JA.to_dense()), 1e-12)


def test_grid_matches_reference():
    shapes = ((4, 3), (3, 5), (2, 2))
    jg, g = JGrid(shapes), SStructGrid(shapes)
    assert (g.part_sizes, g.part_offsets, g.total_size) == \
        (jg.part_sizes, jg.part_offsets, jg.total_size)
    assert g.global_index(1, (2, 4)) == jg.global_index(1, (2, 4))
    x = rand(g.total_size, 1)
    for a, b in zip(g.split(t(x)), jg.split(jnp.asarray(x))):
        close(a, np.asarray(b), 0.0)


# ---------------------------------------------------------------------------
# SysPFMG
# ---------------------------------------------------------------------------


def strong_system(n):
    """The shifted strong-coupling SPD system of the reference's nodal
    relaxation test: [[L + 3, 2.9], [2.9, L + 3]]."""
    JA0 = j_drv._coupled_system(n, 2.9)
    ci = JA0.stencil.center_index()
    coeffs = np.asarray(JA0.coeffs).copy()
    coeffs[0, 0, ci] += 3.0
    coeffs[1, 1, ci] += 3.0
    return j_sys.SysStructMatrix(coeffs=jnp.asarray(coeffs),
                                 stencil=JA0.stencil, shape=JA0.shape)


@pytest.mark.parametrize("n", [5, 16])
def test_sys_mv_and_dia_view_match_reference(n):
    JA = j_drv._coupled_system(n, 0.1)
    A = carry_sys(JA)
    x = rand((2, n, n), n)
    want = np.asarray(JA.mv(jnp.asarray(x)))
    close(A.mv(t(x)), want, 1e-12)
    close(syspfmg.sys_matvec(A, t(x)), want, 1e-12)
    close(A.as_linear_op()(t(x).reshape(-1)), want.reshape(-1), 1e-12)
    # one view of the whole system: (2 nvars - 1) * S planes
    assert A.dia.D == 15 and A.dia.offsets_static is not None
    # the port's own driver problem is the reference's
    own = drv.coupled_system(n, 0.1, dtype=F64, device="cpu")
    close(own.coeffs, np.asarray(JA.coeffs), 0.0)
    close(A.to_dense(), np.asarray(JA.to_dense()), 1e-12)


def test_sys_dia_view_three_variables_random():
    """Three variables, a 9-pt stencil and random coefficients (every
    block nonzero): the view against the plain shifts."""
    rng = np.random.default_rng(9)
    offsets = tuple((i, j) for i in (-1, 0, 1) for j in (-1, 0, 1))
    coeffs = rng.standard_normal((3, 3, 9, 6, 7))
    A = sys_struct_from_numpy(coeffs, offsets, (6, 7), device="cpu")
    x = t(rng.standard_normal((3, 6, 7)))
    assert A.dia.D == 5 * 9
    close(A.mv(x), syspfmg.sys_matvec(A, x), 1e-12)


def test_probe_sys_matches_reference():
    JA = strong_system(8)
    A = carry_sys(JA)
    cdir = 1
    JPs = tuple(j_sys.semi_interp_from_matrix(JA.block(v, v), cdir)
                for v in range(2))
    Ps = tuple(syspfmg.semi_interp_from_matrix(A.block(v, v), cdir)
               for v in range(2))
    cshape = syspfmg.coarse_shape(A.shape, cdir)

    def composite(xc):
        xf = jnp.stack([P.apply(xc[v]) for v, P in enumerate(JPs)])
        yf = JA.mv(xf)
        return jnp.stack([P.apply_t(yf[v]) for v, P in enumerate(JPs)])

    want = j_sys._probe_sys(composite, 2, cshape, (1, 1), JA.dtype)
    got = syspfmg._probe_sys(syspfmg.sys_rap_apply, 2, cshape, (1, 1), F64,
                             "cpu", (A, Ps))
    assert got.stencil.offsets == want.stencil.offsets
    close(got.coeffs, np.asarray(want.coeffs), 1e-12)


def test_node_block_inverse_with_a_singular_node():
    JA = strong_system(5)
    coeffs = np.asarray(JA.coeffs).copy()
    ci = JA.stencil.center_index()
    coeffs[:, :, ci, 2, 3] = 0.0  # a Dirichlet-eliminated node
    coeffs[:, :, ci, 0, 1] = [[1.0, 2.0], [2.0, 4.0]]  # det 0
    JA = dataclasses.replace(JA, coeffs=jnp.asarray(coeffs))
    got = syspfmg._node_block_inverse(carry_sys(JA))
    close(got, np.asarray(j_sys._node_block_inverse(JA)), 1e-12)
    close(got[:, :, 2, 3], np.eye(2), 0.0)


@pytest.fixture(scope="module")
def sys_pair():
    """The reference's and the port's SysPFMG on the 16^2 strong-coupling
    system, set up once with nodal relaxation (both keep the pointwise
    inverse too, so every relaxation runs on one hierarchy)."""
    JA = strong_system(16)
    jp = j_sys.SysPFMG(max_coarse_size=128, relax_type="node-jacobi")
    tp = syspfmg.SysPFMG(max_coarse_size=128, relax_type="node-jacobi")
    return jp.setup(JA), tp.setup(carry_sys(JA)), JA


def test_syspfmg_hierarchy_matches_reference(sys_pair):
    jp, tp, _ = sys_pair
    # the isotropic system ties dxyz; both take the lower dim first
    assert tp.cdirs == [lv.P[0].cdir for lv in jp.levels] == [0, 1]
    for jl, tl in zip(jp.levels, tp.levels):
        assert tl.A.shape == jl.A.shape
        assert tl.A.stencil.offsets == jl.A.stencil.offsets
        close(tl.A.coeffs, np.asarray(jl.A.coeffs), 1e-10)
        close(tl.dinv, np.asarray(jl.dinv), 1e-10)
        close(tl.node_dinv, np.asarray(jl.node_dinv), 1e-10)
        for jP, tP in zip(jl.P, tl.P):
            close(tP.w_lo, np.asarray(jP.w_lo), 1e-10)
            close(tP.w_hi, np.asarray(jP.w_hi), 1e-10)
    assert tp.coarse_meta == jp.coarse_meta
    assert tp.coarse_A.stencil.size == 9 and tp.levels[1].A.dia.D == 27
    close(tp.coarse_inv, np.asarray(jp.coarse_inv), 1e-10)


@pytest.mark.parametrize("relax", ["jacobi", "node-jacobi", "node-rbgs"])
def test_syspfmg_cycle_matches_reference(sys_pair, relax):
    jp, tp, JA = sys_pair
    jp.relax_type = tp.relax_type = relax
    f, u = rand((2, 16, 16), 21), rand((2, 16, 16), 22)
    want = np.asarray(jax.jit(jp.cycle)(jnp.asarray(f), jnp.asarray(u)))
    close(tp.cycle(t(f), t(u)), want, 1e-10)
    z = tp.precond()(t(f).reshape(-1))
    close(z, np.asarray(jax.jit(jp.cycle)(jnp.asarray(f))).reshape(-1),
          1e-10)


def test_syspfmg_fails_alike_on_the_indefinite_driver_system():
    """The sstruct driver's [L, 0.1 I; 0.1 I, L] is indefinite past
    n ~ 13 (lambda_min(L) < eps): standalone SysPFMG with Jacobi smoothing
    does not converge at 24^2 in either package within 60 cycles."""
    JA = j_drv._coupled_system(24, 0.1)
    b = rand((2, 24, 24), 0)
    _, jinfo = j_sys.SysPFMG(max_coarse_size=128).setup(JA).solve(
        jnp.asarray(b), rtol=1e-6, maxiter=60)
    _, tinfo = syspfmg.SysPFMG(max_coarse_size=128).setup(
        carry_sys(JA)).solve(t(b), rtol=1e-6, maxiter=60)
    assert not bool(jinfo.converged) and not bool(tinfo.converged)
    assert int(tinfo.iterations) == int(jinfo.iterations) == 60
    assert float(tinfo.relative_residual) > 1.0
    close(float(tinfo.relative_residual), float(jinfo.relative_residual),
          1e-6)


# ---------------------------------------------------------------------------
# Split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solver", ["pfmg", "smg"])
def test_split_sweep_matches_reference(solver):
    _, JA = j_drv._two_part_problem(10)
    jsp = JSplit(solver=solver).setup(JA)
    tsp = SplitSolver(solver=solver).setup(carry_sstruct(JA))
    x, b = rand(200, 1), rand(200, 2)
    want = np.asarray(jax.jit(jsp._sweep)(jnp.asarray(x), jnp.asarray(b)))
    close(tsp._sweep(t(x), t(b)), want, 1e-10)


# ---------------------------------------------------------------------------
# FAC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(10, (3, 3), (7, 7)), (12, (4, 4), (8, 8)),
                                  (9, (0, 2), (4, 9))])
def test_composite_poisson_2d_is_the_references(args):
    JA, jm, jp, jn = j_fac.composite_poisson_2d(*args)
    A, m, p, n = fac.composite_poisson_2d(*args, dtype=F64, device="cpu")
    assert n == jn
    assert np.array_equal(A.cols.numpy(), np.asarray(JA.cols))
    assert np.array_equal(A.vals.numpy(), np.asarray(JA.vals))
    assert np.array_equal(m, jm) and np.array_equal(p, jp)


def test_composite_poisson_nested_is_the_references():
    patches = [((2, 2), (8, 8)), ((4, 4), (6, 6))]
    JA, jm, jp, jn = j_fac.composite_poisson_nested(10, patches)
    A, m, p, n = fac.composite_poisson_nested(10, patches, dtype=F64,
                                              device="cpu")
    assert n == jn
    assert np.array_equal(A.vals.numpy(), np.asarray(JA.vals))
    assert np.array_equal(A.cols.numpy(), np.asarray(JA.cols))
    assert all(np.array_equal(a, b) for a, b in zip(m, jm))
    assert all(np.array_equal(a, b) for a, b in zip(p, jp))


def fac_pair(monkeypatch, nested):
    monkeypatch.setattr(j_native, "spgemm", numpy_spgemm)
    if nested:
        patches = [((2, 2), (8, 8)), ((4, 4), (6, 6))]
        JA, jm, jp, _ = j_fac.composite_poisson_nested(10, patches)
        A, m, p, _ = fac.composite_poisson_nested(10, patches, dtype=F64,
                                                  device="cpu")
    else:
        JA, jm, jp, _ = j_fac.composite_poisson_2d(12, (4, 4), (8, 8))
        A, m, p, _ = fac.composite_poisson_2d(12, (4, 4), (8, 8), dtype=F64,
                                              device="cpu")
    jf = j_fac.FAC(coarse_amg=JBoomerAMG(max_coarse_size=256,
                                         setup_backend="jax"))
    tf = fac.FAC(coarse_amg=H.BoomerAMG(max_coarse_size=256,
                                        setup_backend="jax"))
    return jf.setup(JA, jm, jp), tf.setup(A, m, p, device="cpu")


def sorted_rows(csr):
    """(row, col) -> value, as arrays sorted by row then column."""
    rows = np.repeat(np.arange(csr.n_rows), np.diff(csr.indptr))
    order = np.lexsort((csr.indices, rows))
    return rows[order], csr.indices[order], csr.data[order]


@pytest.mark.parametrize("nested", [False, True])
def test_fac_operators_and_cycle_match_reference(monkeypatch, nested):
    jf, tf = fac_pair(monkeypatch, nested)
    assert len(tf.levels) == len(jf.levels) == (2 if nested else 1)
    for l, (tl, jl) in enumerate(zip(tf.levels, jf.levels)):
        close(tl.dinv, np.asarray(jl.dinv), 1e-12)
        close(tl.fmask, np.asarray(jl.fmask), 0.0)
        for tM, jM in ((tl.P, jl.P), (tl.R, jl.R)):
            close(ell_to_csr(tM).to_dense(), j_ell_to_csr(jM).to_dense(),
                  0.0)
        # the Galerkin product R (A P), sorted by column
        tC = fac.galerkin(tl.A, tl.P, tl.R)
        jC = j_fac._galerkin(jl.A, jl.P, jl.R, jl.R.n_rows)
        tr, tc, tv = sorted_rows(ell_to_csr(tC))
        jr, jc, jv = sorted_rows(j_ell_to_csr(jC))
        assert np.array_equal(tr, jr) and np.array_equal(tc, jc)
        close(tv, jv, 1e-12)
        # the operator setup stored for the next level (or the base grid)
        nxt = (tf.levels[l + 1].A if l + 1 < len(tf.levels)
               else tf.coarse_A)
        assert nxt is not None
        close(ell_to_csr(nxt).to_dense(), ell_to_csr(tC).to_dense(), 0.0)
    # the base grid's direct solve (Nc^2 <= max_coarse_size 256)
    jbase = jf.coarse_amg.hierarchy
    tbase = tf.coarse_amg.hierarchy
    close(tbase.coarse_inv, np.asarray(jbase.coarse_inv), 1e-10)
    n = tf.A.n_rows
    f, u = rand(n, 31), rand(n, 32)
    close(tf.cycle(t(f), t(u)),
          np.asarray(jf.cycle(jnp.asarray(f), jnp.asarray(u))), 1e-10)


# ---------------------------------------------------------------------------
# Maxwell, FEM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shapes,rf", [(((4, 5),), None),
                                       (((5, 5), (4, 4)), (1.0, 2.0)),
                                       (((3, 4, 3),), None)])
def test_maxwell_grad_is_the_references(shapes, rf):
    JG, jxyz = j_maxwell.maxwell_grad(JGrid(shapes), rf)
    G, xyz = maxwell.maxwell_grad(SStructGrid(shapes), rf, dtype=F64,
                                  device="cpu")
    assert np.array_equal(G.cols.numpy(), np.asarray(JG.cols))
    assert np.array_equal(G.vals.numpy(), np.asarray(JG.vals))
    assert np.array_equal(xyz, jxyz)
    assert maxwell.part_edge_counts(shapes[0]) == \
        j_maxwell.part_edge_counts(shapes[0])


def fem_two_parts(mod, n, **kw):
    """The reference test's two Q1 parts glued along an edge, Dirichlet
    on the combined outer boundary."""
    ke = np.array([[2 / 3, -1 / 6, -1 / 3, -1 / 6],
                   [-1 / 6, 2 / 3, -1 / 6, -1 / 3],
                   [-1 / 3, -1 / 6, 2 / 3, -1 / 6],
                   [-1 / 6, -1 / 3, -1 / 6, 2 / 3]])
    grid = mod.SStructFEMGrid([(n + 1, n + 1), (n + 1, n + 1)])
    for p in (0, 1):
        grid.set_fem_ordering(p, [0, 0, 0, 0],
                              [(0, 0), (1, 0), (1, 1), (0, 1)])
    for j in range(n + 1):
        grid.share_node(1, (0, j), 0, (n, j))
    M = mod.SStructFEMMatrix(grid, **kw)
    fe = np.full(4, 0.25 / (2 * n * n))
    for p in (0, 1):
        for i in range(n):
            for j in range(n):
                M.add_fem_values(p, (i, j), ke * (1.0 + 0.1 * p))
                M.add_fem_rhs(p, (i, j), fe)
    bnd = set()
    for j in range(n + 1):
        bnd.add(grid.dof(0, (0, j), 0))
        bnd.add(grid.dof(1, (n, j), 0))
    for p in (0, 1):
        for i in range(n + 1):
            bnd.add(grid.dof(p, (i, 0), 0))
            bnd.add(grid.dof(p, (i, n), 0))
    return M.assemble(dirichlet=sorted(bnd)), grid


def test_fem_assembly_matches_reference():
    JM, jg = fem_two_parts(j_fem, 6)
    M, g = fem_two_parts(fem, 6, dtype=F64, device="cpu")
    assert g.n_dofs == jg.n_dofs == 13 * 7
    assert g._numbering == jg._numbering
    close(ell_to_csr(M.A).to_dense(), j_ell_to_csr(JM.A).to_dense(), 1e-12)
    assert np.array_equal(M.A.cols.numpy(), np.asarray(JM.A.cols))
    close(M.b, np.asarray(JM.b), 1e-12)


# ---------------------------------------------------------------------------
# SStruct IO
# ---------------------------------------------------------------------------


def io_objects():
    grid = ((4, 3), (3, 3))
    jparts = (j_lap((4, 3)), j_lap((3, 3), weights=(1.0, 0.5)))
    n = 21
    U = JEll(vals=jnp.zeros((n, 2)).at[0, 0].set(-1.0).at[12, 0].set(-0.5),
             cols=jnp.full((n, 2), -1, jnp.int32).at[0, 0].set(12)
             .at[12, 0].set(0), n_cols=n)
    return JSStructMatrix(parts=jparts, U=U, grid=JGrid(grid)), rand(n, 1)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sstruct_io_roundtrip_across_packages(tmp_path, writer):
    JA, x = io_objects()
    A = carry_sstruct(JA)
    d, dv = str(tmp_path / "ss"), str(tmp_path / "ssv")
    if writer == "reference":
        j_io.print_sstruct_matrix(d, JA)
        j_io.print_sstruct_vector(dv, JA.grid, jnp.asarray(x))
        B = io.read_sstruct_matrix(d, F64, device="cpu")
        y = io.read_sstruct_vector(dv, F64, device="cpu")
        close(B.mv(t(x)), np.asarray(JA.mv(jnp.asarray(x))), 0.0)
        assert np.array_equal(ell_to_csr(B.U).to_dense(),
                              j_ell_to_csr(JA.U).to_dense())
    else:
        io.print_sstruct_matrix(d, A)
        io.print_sstruct_vector(dv, A.grid, t(x))
        B = j_io.read_sstruct_matrix(d, jnp.float64)
        y = np.asarray(j_io.read_sstruct_vector(dv, jnp.float64))
        close(np.asarray(B.mv(jnp.asarray(x))), A.mv(t(x)).numpy(), 0.0)
    assert B.grid.part_shapes == JA.grid.part_shapes
    for P, JP in zip(B.parts, JA.parts):
        close(np.asarray(P.coeffs), np.asarray(JP.coeffs), 0.0)
    close(y, x, 0.0)
