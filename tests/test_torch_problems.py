"""hypre_tpu_torch's problem generators against hypre_tpu's, in float64 on
the CPU: the same columns and ``shifts`` exactly, the values bit for bit.
The unstructured generators go through each package's own IJMatrix from
the same seed and must assemble the same CSR, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from hypre_tpu.problems import laplacian as jl
from hypre_tpu.problems import unstructured as ju

import hypre_tpu_torch as H
from torch_one_thread import one_torch_thread  # noqa: F401


def same_ell(t, j):
    assert t.n_cols == j.n_cols
    assert t.shifts == j.shifts
    assert t.vals.dtype == torch.float64
    assert np.array_equal(t.cols.numpy(), np.asarray(j.cols))
    assert np.array_equal(t.vals.numpy(), np.asarray(j.vals))


def same_csr(t, j):
    assert t.shape == j.shape
    assert np.array_equal(t.indptr, j.indptr)
    assert np.array_equal(t.indices, j.indices)
    assert t.data.dtype == j.data.dtype
    assert np.array_equal(t.data, j.data)


# (name, arguments): each generator at a small size, with its knobs moved
# off their defaults where it has them
CASES = [
    ("laplacian_1d", (13,), {}),
    ("laplacian_2d_5pt", (7, 9), {}),
    ("laplacian_2d_9pt", (7, 9), {}),
    ("laplacian_3d_7pt", (5, 6, 7), {}),
    ("laplacian_3d_27pt", (5, 6, 7), {}),
    ("difconv_3d_7pt", (6, 5, 4), {}),
    ("difconv_3d_7pt", (6, 5, 4), dict(ax=2.0, az=0.5, cx=3.0, cy=1.0,
                                       cz=0.25)),
    ("rotated_anisotropy_2d", (8, 7), {}),
    ("rotated_anisotropy_2d", (8, 7), dict(eps=0.1, theta_deg=30.0)),
    ("elasticity_2d", (8, 8), {}),
    ("elasticity_2d", (5, 9), dict(lam=2.0, mu=0.5)),
    ("vardifconv_3d", (12, 12, 12), {}),
    ("vardifconv_3d", (7, 9, 11), dict(eps=0.5)),
]


@pytest.mark.parametrize("name,args,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_generator_is_the_reference(name, args, kw):
    j = getattr(jl, name)(*args, **kw)
    t = getattr(H, name)(*args, dtype=torch.float64, device="cpu", **kw)
    same_ell(t, j)
    if name != "elasticity_2d":
        # the stencil generators annotate every slot's column shift
        assert t.shifts is not None and len(t.shifts) == t.k
        valid = t.cols >= 0
        rows = torch.arange(t.n_rows)[:, None]
        want = rows + torch.tensor(t.shifts)[None, :]
        assert bool((t.cols[valid] == want.expand_as(t.cols)[valid]).all())


def test_generators_cast_to_float32_as_the_reference_does():
    """In f32 the stencil coefficients are the f64 ones rounded once; the
    vardifconv coefficients are computed in f64 and then cast."""
    for name, args in (("difconv_3d_7pt", (4, 5, 6)),
                       ("rotated_anisotropy_2d", (6, 5)),
                       ("vardifconv_3d", (6, 6, 6))):
        j = getattr(jl, name)(*args, dtype=jnp.float32)
        t = getattr(H, name)(*args, dtype=torch.float32, device="cpu")
        assert t.vals.dtype == torch.float32
        assert np.array_equal(t.vals.numpy(), np.asarray(j.vals))
        assert np.array_equal(t.cols.numpy(), np.asarray(j.cols))


@settings(max_examples=12, deadline=None)
@given(shape=st.lists(st.integers(1, 6), min_size=1, max_size=3),
       which=st.sampled_from(["5/7", "27/9"]))
def test_stencil_generators_over_grid_shapes(shape, which):
    """Every grid shape, degenerate ones (a dimension of 1) included."""
    if len(shape) == 1:
        j, t = jl.laplacian_1d(*shape), H.laplacian_1d(
            *shape, dtype=torch.float64, device="cpu")
    elif len(shape) == 2:
        name = "laplacian_2d_5pt" if which == "5/7" else "laplacian_2d_9pt"
        j = getattr(jl, name)(*shape)
        t = getattr(H, name)(*shape, dtype=torch.float64, device="cpu")
    else:
        name = "laplacian_3d_7pt" if which == "5/7" else "laplacian_3d_27pt"
        j = getattr(jl, name)(*shape)
        t = getattr(H, name)(*shape, dtype=torch.float64, device="cpu")
    same_ell(t, j)


def test_fem_stiffness_2d_is_the_reference():
    jij, jpts = ju.fem_stiffness_2d(m=12)
    tij, tpts = H.fem_stiffness_2d(m=12)
    assert np.array_equal(tpts, jpts)
    same_csr(tij.get_csr(), jij.get_csr())
    same_ell(tij.get_object(dtype=torch.float64, device="cpu"),
             jij.get_object(dtype=jnp.float64))


def test_circuit_laplacian_is_the_reference():
    same_csr(H.circuit_laplacian(n=2000).get_csr(),
             ju.circuit_laplacian(n=2000).get_csr())


def test_fem_block_2d_is_the_reference():
    jij, _ = ju.fem_block_2d(m=8)
    tij, _ = H.fem_block_2d(m=8)
    same_csr(tij.get_csr(), jij.get_csr())
    assert tij.get_csr().shape[0] % 2 == 0


def test_elasticity_2d_assembles_1024_squared_nodes_quickly():
    """The reference's double loop over nodes takes minutes at this size;
    the vectorized assembly must not. 1024 x 1024 nodes, 2 097 152 rows;
    an interior row holds 9 entries (its diagonal, 4 neighbours of its
    own field, 4 corners of the other) and sums to 0."""
    import time

    t0 = time.perf_counter()
    A = H.elasticity_2d(1024, 1024, dtype=torch.float64, device="cpu")
    seconds = time.perf_counter() - t0
    assert A.n_rows == 2 * 1024 * 1024 and A.k == 9
    assert seconds < 60.0, seconds
    row = 2 * (512 * 1024 + 512)  # an interior u row
    assert int((A.cols[row] >= 0).sum()) == 9
    assert float(A.vals[row].sum()) == 0.0
