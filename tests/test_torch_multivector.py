"""hypre_tpu_torch's multivector interpreter against hypre_tpu's, in
float64 on the CPU.

The reference's test (tests/test_krylov2.py:191-215) runs LOBPCG over
struct-grid vectors, whose layer is not ported yet; here both packages
run on the same (n, n)-shaped vectors with a 5-pt operator applied by
array shifts, written once in jnp and once in torch, and on a tuple
vector. The eigenvalues agree with each other and with a dense oracle to
1e-6, the reference test's own tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.multivector import MultiVector as JMultiVector, \
    lobpcg_interpreted as j_lobpcg

from hypre_tpu_torch.multivector import Interpreter, MultiVector, \
    lobpcg_interpreted
from torch_one_thread import one_torch_thread  # noqa: F401

N = 12


def j_lap(v):
    p = jnp.pad(v, 1)
    return 4 * v - p[:-2, 1:-1] - p[2:, 1:-1] - p[1:-1, :-2] - p[1:-1, 2:]


def t_lap(v):
    p = torch.nn.functional.pad(v, (1, 1, 1, 1))
    return 4 * v - p[:-2, 1:-1] - p[2:, 1:-1] - p[1:-1, :-2] - p[1:-1, 2:]


def lap_dense(n):
    T = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    return np.kron(T, np.eye(n)) + np.kron(np.eye(n), T)


def j_pair_op(v):
    a, b = v
    return (2 * a - jnp.roll(a, 1) - jnp.roll(a, -1) + 0.5 * b[:, 0],
            3 * b + 0.5 * a[:, None])


def t_pair_op(v):
    a, b = v
    return (2 * a - torch.roll(a, 1) - torch.roll(a, -1) + 0.5 * b[:, 0],
            3 * b + 0.5 * a[:, None])


def pair_dense(n):
    """The tuple operator's matrix over (a, b[:, 0]), b a column."""
    T = 2 * np.eye(n) - np.roll(np.eye(n), 1, 0) - np.roll(np.eye(n), -1, 0)
    return np.block([[T, 0.5 * np.eye(n)], [0.5 * np.eye(n), 3 * np.eye(n)]])


@pytest.mark.parametrize("case", ["grid", "tuple"])
def test_lobpcg_interpreted_matches_reference_and_oracle(case):
    rng = np.random.default_rng(0)
    if case == "grid":
        starts = [rng.standard_normal((N, N)) for _ in range(4)]
        jv = [jnp.asarray(x) for x in starts]
        tv = [torch.from_numpy(x) for x in starts]
        jop, top, dense = j_lap, t_lap, lap_dense(N)
    else:
        starts = [(rng.standard_normal(N), rng.standard_normal((N, 1)))
                  for _ in range(3)]
        jv = [tuple(jnp.asarray(p) for p in s) for s in starts]
        tv = [tuple(torch.from_numpy(p) for p in s) for s in starts]
        jop, top, dense = j_pair_op, t_pair_op, pair_dense(N)
    jw, _, _ = j_lobpcg(jop, JMultiVector.from_vectors(jv), tol=1e-8,
                        maxiter=300)
    tw, tV, tres = lobpcg_interpreted(top, MultiVector.from_vectors(tv),
                                      tol=1e-8, maxiter=300)
    want = np.sort(np.linalg.eigvalsh(dense))[:len(starts)]
    np.testing.assert_allclose(np.sort(tw.numpy()), np.sort(np.asarray(jw)),
                               rtol=1e-6)
    np.testing.assert_allclose(np.sort(tw.numpy()), want, rtol=1e-6)
    # vectors come back in the user's shape, with the residuals reported
    v0 = tV.vectors()[0]
    flat = tV.interp.ravel
    r0 = torch.linalg.vector_norm(flat(top(v0)) - tw[0] * flat(v0))
    assert abs(float(r0) - float(tres[0])) <= 1e-10
    if case == "grid":
        assert v0.shape == (N, N)
    else:
        assert isinstance(v0, tuple) and v0[1].shape == (N, 1)


def test_interpreter_flattens_like_the_reference():
    """Leaf order (dict keys sorted, sequences in order), dtype promotion,
    and the single-vector slots on flat coordinates."""
    from jax.flatten_util import ravel_pytree

    rng = np.random.default_rng(1)
    parts = {"b": rng.standard_normal((2, 3)), "a": rng.standard_normal(4),
             "c": [rng.standard_normal(2), rng.standard_normal((1, 2))]}
    tvec = {k: ([torch.from_numpy(x) for x in v] if isinstance(v, list)
                else torch.from_numpy(v)) for k, v in parts.items()}
    tvec["a"] = tvec["a"].float()
    jvec = {k: ([jnp.asarray(x) for x in v] if isinstance(v, list)
                else jnp.asarray(v)) for k, v in parts.items()}
    jvec["a"] = jvec["a"].astype(jnp.float32)
    interp = Interpreter.for_vector(tvec)
    flat = interp.ravel(tvec)
    assert interp.size == 4 + 6 + 2 + 2 and flat.dtype == torch.float64
    np.testing.assert_array_equal(flat.numpy(), np.asarray(
        ravel_pytree(jvec)[0]))
    back = interp.unravel(flat)
    assert list(back) == list(tvec) and back["a"].dtype == torch.float32
    for k in ("a", "b"):
        assert torch.equal(back[k], tvec[k])
    assert torch.equal(back["c"][1], tvec["c"][1])
    y = interp.axpy(2.0, tvec, interp.scale(0.5, tvec))
    assert torch.allclose(interp.ravel(y), 2.5 * flat)
    assert float(interp.inner_prod(tvec, tvec)) == pytest.approx(
        float(flat @ flat))
    assert not interp.ravel(interp.clear(tvec)).any()
    assert torch.equal(interp.ravel(interp.copy(tvec)), flat)


def test_multivector_block_operations():
    rng = np.random.default_rng(2)
    vecs = [torch.from_numpy(rng.standard_normal((3, 4))) for _ in range(3)]
    X = MultiVector.from_vectors(vecs)
    assert X.num_vectors == 3 and X.data.shape == (12, 3)
    G = X.inner_prod_matrix(X)
    assert torch.allclose(G, X.data.T @ X.data)
    coef = torch.from_numpy(rng.standard_normal((3, 2)))
    assert torch.allclose(X.by_matrix(coef).data, X.data @ coef)
    assert torch.allclose(X.axpy(2.0, X).data, 3 * X.data)
    Y = X.apply(lambda v: 2 * v.T.T)
    assert torch.allclose(Y.data, 2 * X.data)
    assert all(torch.equal(a, b) for a, b in zip(X.vectors(), vecs))
