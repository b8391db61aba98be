"""The plain reference against dense linear algebra at a tiny size."""

import pytest
import torch
from harness import spec
from reference import cycle, solve, sparse

GRIDS = {"7pt": (4, 3, 5), "27pt": (4, 3, 5)}


def problem(name, grid=None):
    return spec.problem({"problem": "stencil", "stencil": name,
                         "grid": list(grid or GRIDS[name])})


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_stencil_operator_matches_its_dense_form(name):
    p = problem(name)
    A = p.dense(shift=0.3)
    x = torch.rand(A.shape[0], dtype=torch.float64)
    assert torch.allclose(p.apply(x, 0.3), A @ x, atol=1e-12)
    assert int((A != 0).sum()) == p.nnz()
    assert torch.equal(torch.diagonal(A), p.diagonal(0.3))


def test_a_two_dimensional_stencil_file_is_read_on_its_own_axes(tmp_path,
                                                                monkeypatch):
    from reference.problems import stencil

    (tmp_path / "5pt.json").write_text(
        '{"offsets": [[0, 0], [-1, 0], [1, 0], [0, -1], [0, 1]],'
        ' "coefficients": [4, -1, -1, -1, -1]}')
    monkeypatch.setattr(stencil, "STENCIL_DIR", tmp_path)
    p = stencil.Problem((3, 4), "5pt")
    A = p.dense()
    assert A.shape == (12, 12) and p.nnz() == 12 + 2 * (2 * 4 + 3 * 3)
    # row (1, 1) couples to (0, 1), (2, 1), (1, 0), (1, 2)
    assert A[5].nonzero().flatten().tolist() == [1, 4, 5, 6, 9]
    with pytest.raises(ValueError):
        stencil.Problem((3, 4, 2), "5pt")


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_reference_solve_matches_a_dense_solve(name):
    p = problem(name)
    A = p.dense(shift=0.1)
    b = torch.rand(A.shape[0], dtype=torch.float64)
    x_dense = torch.linalg.solve(A, b)
    x, it, ok = solve.pcg_jacobi(b, p, 0.1, rtol=1e-12, maxiter=500)
    assert ok and it < 500
    assert torch.allclose(x, x_dense, rtol=1e-9, atol=1e-10)
    assert solve.rel_residual(x, b, p, 0.1) < 1e-11
    assert solve.rel_residual(x_dense, b, p, 0.1) < 1e-13


def _ell(M):
    """A dense matrix as plain (rows, slots) arrays, -1 in empty slots."""
    k = int((M != 0).sum(1).max())
    vals = torch.zeros(M.shape[0], k, dtype=M.dtype)
    cols = torch.full((M.shape[0], k), -1, dtype=torch.int32)
    for i in range(M.shape[0]):
        nz = M[i].nonzero().flatten()
        vals[i, :len(nz)], cols[i, :len(nz)] = M[i, nz], nz.int()
    return vals, cols, M.shape[1]


def test_reference_v_cycle_matches_its_dense_formula():
    torch.manual_seed(0)
    A0 = problem("7pt", (3, 3, 4)).dense()
    n = A0.shape[0]
    P0 = torch.zeros(n, 12, dtype=torch.float64)
    P0[torch.arange(n), torch.arange(n) % 12] = 1.0
    P0[torch.arange(n), (torch.arange(n) + 5) % 12] += 0.25
    A1 = P0.T @ A0 @ P0
    P1 = torch.rand(12, 4, dtype=torch.float64) * (torch.rand(12, 4) < 0.5)
    P1[torch.arange(4), torch.arange(4)] = 1.0
    A2 = P1.T @ A1 @ P1
    f = torch.rand(n, dtype=torch.float64)

    def dense_v(As, Ps, f, l=0):
        if l == len(Ps):
            return torch.linalg.solve(As[l], f)
        D = torch.diag(1.0 / As[l].abs().sum(1))
        u = D @ f
        e = dense_v(As, Ps, Ps[l].T @ (f - As[l] @ u), l + 1)
        u = u + Ps[l] @ e
        return u + D @ (f - As[l] @ u)

    levels = [(_ell(A0), _ell(P0)), (_ell(A1), _ell(P1))]
    z = cycle.VCycle(levels, 1, torch.float64)(f)
    assert torch.allclose(z, dense_v([A0, A1, A2], [P0, P1], f),
                          rtol=1e-10, atol=1e-12)
    assert torch.allclose(cycle.galerkin_dense(*levels[1]), A2, atol=1e-12)
    # a block of P's columns at a time gives the same product
    assert torch.allclose(cycle.galerkin_dense(*levels[1], block_bytes=8 * 12),
                          A2, atol=1e-12)


def test_reference_cycle_refuses_a_cycle_it_does_not_compute():
    assert cycle.sweeps_of(["-rlx", "18", "-ns", "2"]) == 2
    for flags in (["-rlx", "16"], [], ["-rlx", "18", "-CF", "1"],
                  ["-rlx", "18", "-smtype", "4"]):
        with pytest.raises(ValueError):
            cycle.sweeps_of(flags)


def test_sparse_products_match_dense():
    n, m, k = 9, 5, 3
    cols = torch.randint(0, m, (n, k), dtype=torch.int32)
    cols[0, 2] = -1  # an empty slot
    vals = torch.rand(n, k, dtype=torch.float64)
    M = torch.zeros(n, m, dtype=torch.float64)
    for i in range(n):
        for s in range(k):
            if cols[i, s] >= 0:
                M[i, cols[i, s]] += vals[i, s]
    x, y = torch.rand(m, dtype=torch.float64), torch.rand(n, dtype=torch.float64)
    X = torch.rand(m, 4, dtype=torch.float64)
    assert torch.allclose(sparse.matvec(vals, cols, m, x), M @ x)
    assert torch.allclose(sparse.rmatvec(vals, cols, m, y), M.T @ y)
    assert torch.allclose(sparse.spmm(vals, cols, m, X), M @ X)
    Y = torch.rand(n, 3, dtype=torch.float64)
    assert torch.allclose(sparse.rmatmat(vals, cols, m, Y), M.T @ Y)
    assert torch.allclose(sparse.dense(vals, cols, m), M)
    assert torch.allclose(sparse.abs_row_sums(vals, cols, m), M.abs().sum(1))
    assert sparse.stored(cols, m) == n * k - 1
