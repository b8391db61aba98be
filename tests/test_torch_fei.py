"""hypre_tpu_torch's FEI front end against hypre_tpu's, in float64 on the
CPU, on the reference tests' problems (tests/test_fei.py).

- ``loadComplete``'s A and b, with BCs (zero and nonzero values), with two
  fields per node and with a shared-node two-rank assembly: 1e-12;
- ``getBlockNodeSolution``, ``getNodalSolution`` and ``residualNorm`` on
  the same x: equal;
- ``fei_assemble_shared`` equal to one global assembly;
- ``element_null_candidates`` compared by the spanned subspace Q Q^T
  (the QR's column signs may differ between LAPACK builds): 1e-8;
- ``element_graph_aggregates``: exact;
- every ``solve`` dispatch converges, within the reference test's bound
  where it has one.

The three smoothed-aggregation comparisons of tests/test_fei.py run on
the port alone, with the reference's assertions: the reference's SA
setups take 13-16 s each on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu import fei as j_fei
from hypre_tpu.seq.ell import ell_to_csr as j_ell_to_csr

import hypre_tpu_torch as H
from hypre_tpu_torch import fei
from hypre_tpu_torch.amg.smoothed_agg import SmoothedAggAMG, aggregate
from hypre_tpu_torch.amg.strength import strength_mask
from hypre_tpu_torch.seq.ell import ell_to_csr
from torch_one_thread import one_torch_thread  # noqa: F401

F64 = torch.float64
KE = np.array([[2 / 3, -1 / 6, -1 / 3, -1 / 6],
               [-1 / 6, 2 / 3, -1 / 6, -1 / 3],
               [-1 / 3, -1 / 6, 2 / 3, -1 / 6],
               [-1 / 6, -1 / 3, -1 / 6, 2 / 3]])


def new(mod):
    return (mod.FEISystem(dtype=F64, device="cpu") if mod is fei
            else mod.FEISystem())


def q1_poisson(mod, nx, ny, bc_value=0.0):
    """The reference test's Q1 Poisson FEI sequence (u = bc_value on the
    boundary)."""
    s = new(mod).initFields()
    s.initElemBlock("blk", nx * ny, 4)
    fe = np.full(4, 0.25 / (nx * ny))
    for i in range(nx):
        for j in range(ny):
            conn = [(i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)]
            s.sumInElemMatrix("blk", (i, j), conn, KE)
            s.sumInElemRHS("blk", (i, j), conn, fe)
    bnd = [(i, j) for i in range(nx + 1) for j in range(ny + 1)
           if i in (0, nx) or j in (0, ny)]
    s.loadNodeBCs(bnd, [bc_value + 0.1 * k for k in range(len(bnd))]
                  if bc_value else [0.0] * len(bnd))
    return s.loadComplete()


def vector_poisson(mod, n=6):
    """Two fields per node (the reference's multi-field test), with
    per-dof BC values."""
    s = new(mod).initFields(2, (1, 1))
    s.initElemBlock("v", n * n, 4)
    ke2 = np.kron(KE, np.eye(2))
    fe2 = np.zeros(8)
    fe2[0::2] = 0.25 / (n * n)
    for i in range(n):
        for j in range(n):
            conn = [(i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)]
            s.sumInElemMatrix("v", (i, j), conn, ke2)
            s.sumInElemRHS("v", (i, j), conn, fe2)
    bnd = [(i, j) for i in range(n + 1) for j in range(n + 1)
           if i in (0, n) or j in (0, n)]
    s.loadNodeBCs(bnd, [(0.0, 0.5 * k) for k in range(len(bnd))])
    return s.loadComplete()


def two_ranks(mod, nx=6, ny=4):
    """The reference's two-rank shared-node assembly, merged, and the
    single-rank system."""
    fe = np.full(4, 0.25 / (nx * ny))

    def add_elems(s, i_range, bid):
        s.initElemBlock(bid, len(i_range) * ny, 4)
        for i in i_range:
            for j in range(ny):
                conn = [(i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)]
                s.sumInElemMatrix(bid, (i, j), conn, KE)
                s.sumInElemRHS(bid, (i, j), conn, fe)

    bnd = [(i, j) for i in range(nx + 1) for j in range(ny + 1)
           if i in (0, nx) or j in (0, ny)]
    one = new(mod).initFields()
    add_elems(one, range(nx), "blk")
    one.loadNodeBCs(bnd, np.zeros(len(bnd))).loadComplete()
    half = nx // 2
    r0, r1 = new(mod).initFields(), new(mod).initFields()
    add_elems(r0, range(half), "blk")
    add_elems(r1, range(half, nx), "blk")
    iface = [(half, j) for j in range(ny + 1)]
    r0.initSharedNodes(iface)
    r1.initSharedNodes(iface)
    b0 = [b for b in bnd if b[0] <= half]
    b1 = [b for b in bnd if b[0] >= half]
    r0.loadNodeBCs(b0, np.zeros(len(b0)))
    r1.loadNodeBCs(b1, np.zeros(len(b1)))
    return mod.fei_assemble_shared([r0, r1]), one


def dense(A):
    return ell_to_csr(A).to_dense() if isinstance(A, H.EllMatrix) \
        else j_ell_to_csr(A).to_dense()


def close(a, b, tol):
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max(initial=0.0)
    assert err <= tol * max(np.abs(b).max(initial=0.0), 1e-300), err


SYSTEMS = {
    "q1 zero BCs": lambda mod: q1_poisson(mod, 8, 8),
    "q1 nonzero BCs": lambda mod: q1_poisson(mod, 5, 7, bc_value=1.0),
    "two fields": vector_poisson,
    "two ranks merged": lambda mod: two_ranks(mod)[0],
}


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_load_complete_matches_reference(name):
    ref, got = SYSTEMS[name](j_fei), SYSTEMS[name](fei)
    assert got.n_dofs == ref.n_dofs
    assert list(got._node_ids) == list(ref._node_ids)
    close(dense(got.A), dense(ref.A), 1e-12)
    assert np.array_equal(got.A.cols.numpy(), np.asarray(ref.A.cols))
    close(got.b, np.asarray(ref.b), 1e-12)


def test_solution_getters_match_reference():
    ref, got = q1_poisson(j_fei, 3, 3), q1_poisson(fei, 3, 3)
    x = np.random.default_rng(4).standard_normal(got.n_dofs)
    for call in ("getBlockNodeSolution", "getNodalSolution"):
        args = ("blk", x) if call == "getBlockNodeSolution" else (x,)
        t_ids, t_off, t_val = getattr(got, call)(*args[:-1],
                                                 torch.from_numpy(x))
        j_ids, j_off, j_val = getattr(ref, call)(*args[:-1], jnp.asarray(x))
        assert t_ids == j_ids and t_off == j_off
        close(t_val, np.asarray(j_val), 0.0)
    for which in (0, 1, 2):
        assert got.residualNorm(which, x) == pytest.approx(
            ref.residualNorm(which, jnp.asarray(x)), rel=1e-12)


def test_assemble_shared_equals_one_global_assembly():
    merged, one = two_ranks(fei)
    assert merged.n_dofs == one.n_dofs
    perm = [merged._node_ids[nid] for nid in one._node_ids]
    close(dense(merged.A)[np.ix_(perm, perm)], dense(one.A), 1e-14)
    close(merged.b.numpy()[perm], one.b.numpy(), 1e-14)
    x_m, info_m = merged.parameters(["solver cg"]).solve(rtol=1e-10)
    x_o, _ = one.parameters(["solver cg"]).solve(rtol=1e-10)
    assert bool(info_m.converged)
    close(x_m.numpy()[perm], x_o.numpy(), 1e-8)
    assert merged.residualNorm(2, x_m) < 1e-8


# -- the elasticity systems of the reference's SA tests ---------------------


def p1_elasticity_ke(xy, E=1.0, nu=0.3):
    """Plane-stress linear-triangle stiffness (6x6, node-major (ux, uy))."""
    (x1, y1), (x2, y2), (x3, y3) = xy
    area = 0.5 * abs((x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1))
    b = np.array([y2 - y3, y3 - y1, y1 - y2]) / (2 * area)
    c = np.array([x3 - x2, x1 - x3, x2 - x1]) / (2 * area)
    B = np.zeros((3, 6))
    B[0, 0::2] = b
    B[1, 1::2] = c
    B[2, 0::2] = c
    B[2, 1::2] = b
    D = (E / (1 - nu * nu)) * np.array(
        [[1, nu, 0], [nu, 1, 0], [0, 0, (1 - nu) / 2]])
    return area * B.T @ D @ B


def p1_elasticity(mod, nn=7):
    """ex10-style P1 plane stress on an nn x nn node grid, left edge
    clamped, downward load on the right edge."""
    s = new(mod).initFields(1, (2,))
    h = 1.0 / (nn - 1)
    tris = []
    for j in range(nn - 1):
        for i in range(nn - 1):
            n00, n10 = j * nn + i, j * nn + i + 1
            n01, n11 = (j + 1) * nn + i, (j + 1) * nn + i + 1
            tris += [(n00, n10, n11), (n00, n11, n01)]
    s.initElemBlock(0, len(tris), 3)
    for e, tri in enumerate(tris):
        s.sumInElemMatrix(0, e, tri, p1_elasticity_ke(
            [((t % nn) * h, (t // nn) * h) for t in tri]))
    left = [j * nn for j in range(nn)]
    s.loadNodeBCs(left, [0.0] * len(left))
    s.loadComplete()
    b = np.zeros(s.n_dofs)
    for j in range(nn):
        b[2 * (j * nn + (nn - 1)) + 1] = -1.0
    b[s._bc_rows] = 0.0
    s.b = torch.from_numpy(b) if mod is fei else jnp.asarray(b)
    return s


def q1_elastic_ke(hx, hy, E=1.0, nu=0.3):
    """Plane-stress Q1 rectangle, 2x2 Gauss, node-major (ux, uy) dofs."""
    C = E / (1 - nu**2) * np.array([[1, nu, 0], [nu, 1, 0],
                                    [0, 0, (1 - nu) / 2]])
    gp = 1 / np.sqrt(3)
    K = np.zeros((8, 8))
    for xi in (-gp, gp):
        for eta in (-gp, gp):
            dN = np.array([[-(1 - eta), (1 - eta), (1 + eta), -(1 + eta)],
                           [-(1 - xi), -(1 + xi), (1 + xi), (1 - xi)]]) / 4
            dNx = np.diag([2 / hx, 2 / hy]) @ dN
            B = np.zeros((3, 8))
            for a in range(4):
                B[0, 2 * a] = dNx[0, a]
                B[1, 2 * a + 1] = dNx[1, a]
                B[2, 2 * a] = dNx[1, a]
                B[2, 2 * a + 1] = dNx[0, a]
            K += B.T @ C @ B * (hx * hy / 4)
    return K


def q1_elastic(mod, nx, hx=1.0, hy=1.0):
    s = new(mod).initFields(1, (2,))
    s.initElemBlock(0, (nx - 1) * (nx - 1), 4)
    K = q1_elastic_ke(hx, hy)
    for j in range(nx - 1):
        for i in range(nx - 1):
            nodes = [j * nx + i, j * nx + i + 1, (j + 1) * nx + i + 1,
                     (j + 1) * nx + i]
            s.sumInElemMatrix(0, 0, nodes, K)
            s.sumInElemRHS(0, 0, nodes, [hx * hy / 8] * 8)
    bn = sorted({j * nx for j in range(nx)})
    s.loadNodeBCs(bn, [0.0] * len(bn))
    return s.loadComplete()


def test_element_null_candidates_span_the_references():
    ref, got = p1_elasticity(j_fei), p1_elasticity(fei)
    Qr = np.asarray(ref.element_null_candidates(num_vectors=3, sweeps=30))
    Qg = got.element_null_candidates(num_vectors=3, sweeps=30).numpy()
    assert Qg.shape == Qr.shape == (got.n_dofs, 3)
    close(Qg @ Qg.T, Qr @ Qr.T, 1e-8)


def test_element_graph_aggregates_are_the_references():
    ref, got = q1_elastic(j_fei, 10), q1_elastic(fei, 10)
    ja, jn = ref.element_graph_aggregates()
    ta, tn = got.element_graph_aggregates()
    assert tn == jn and np.array_equal(ta, np.asarray(ja))


DISPATCH = [("cg", "diagonal", None), ("gmres", "boomeramg", 20),
            ("cg", "boomeramg", 20), ("bicgstab", "diagonal", None),
            ("gmres", "ilut", None), ("gmres", "euclid", None),
            ("cg", "parasails", None), ("cg", "schwarz", None)]


@pytest.mark.parametrize("solver,prec,bound", DISPATCH,
                         ids=[f"{s}-{p}" for s, p, _ in DISPATCH])
def test_solve_dispatch_converges(solver, prec, bound):
    s = q1_poisson(fei, 10, 10)
    x, info = s.parameters([f"solver {solver}",
                            f"preconditioner {prec}"]).solve(rtol=1e-8)
    assert bool(info.converged), (solver, prec, info)
    if bound is not None:  # the reference test's bound
        assert int(info.iterations) <= bound
    assert s.residualNorm(2, x) <= 1e-7 * float(torch.linalg.norm(s.b))
    xs = x.numpy()
    assert xs.min() >= -1e-10 and xs.max() > 0


# -- the reference's smoothed-aggregation claims, on the port ---------------


def sa_iters(A, b, rtol=1e-7, max_coarse_size=60, **kw):
    amg = SmoothedAggAMG(max_coarse_size=max_coarse_size, **kw).setup(
        A, device="cpu", optimize=False)
    _, info = H.pcg(A.mv, b, M=amg.precond(), rtol=rtol, maxiter=400,
                    device="cpu")
    assert bool(info.converged)
    return int(info.iterations)


def test_element_null_candidates_drive_sa_amg():
    """Element-derived candidates make SA converge at least as fast as
    the constants, and strictly faster unless the constants need <= 6."""
    s = p1_elasticity(fei, 7)
    B = s.element_null_candidates(num_vectors=3, sweeps=30)
    it_elem = sa_iters(s.A, s.b, rtol=1e-8, max_coarse_size=12,
                       null_space=B)
    it_const = sa_iters(s.A, s.b, rtol=1e-8, max_coarse_size=12)
    assert it_elem <= it_const, (it_elem, it_const)
    assert it_elem < it_const or it_const <= 6


def test_element_graph_aggregation_beats_matrix_graph_elasticity():
    """The element graph never splits a node's two dofs, the matrix
    strength graph does on this mesh, and element-graph aggregation
    converges within one iteration of it at the same null space."""
    s = q1_elastic(fei, 16)
    Z = s.element_null_candidates(num_vectors=3)
    agg_e, n_agg = s.element_graph_aggregates()
    assert int(np.sum(agg_e[0::2] != agg_e[1::2])) == 0
    am, _ = aggregate(s.A, strength_mask(s.A, 0.25))
    assert int(np.sum(np.asarray(am)[0::2] != np.asarray(am)[1::2])) > 0
    it_m = sa_iters(s.A, s.b, null_space=Z)
    it_e = sa_iters(s.A, s.b, null_space=Z, agg0=(agg_e, n_agg))
    assert it_e <= it_m + 1, (it_e, it_m)


def test_fe_data_driven_setup_beats_matrix_only_stretched():
    """On aspect-4 elements the element-derived candidates beat the
    matrix-only setup by more than 20 %."""
    s = q1_elastic(fei, 12, hx=4.0, hy=1.0)
    Z = s.element_null_candidates(num_vectors=3)
    it_plain = sa_iters(s.A, s.b, rtol=1e-6)
    it_fe = sa_iters(s.A, s.b, rtol=1e-6, null_space=Z)
    assert it_fe < 0.8 * it_plain, (it_fe, it_plain)
