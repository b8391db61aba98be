"""hypre_tpu_torch's multi-shard struct grids (``struct/par_struct.py``)
against the unsharded port and hypre_tpu's PFMG, in float64 on the CPU,
with 8 shards held in one process (the local backend).

The sharded matvec (ghost planes by ring shifts, one DIA view over the
stacked slabs) equals the unsharded one to 1e-12 with variable
coefficients; sharded PFMG takes the reference PFMG's iterations (a 2-D
reference solve runs here; the 3-D reference setup alone costs ~12 s of
XLA compile, so its count is recorded: ``PFMG().setup(struct_laplacian(
(32, 8, 8))).solve(b, rtol=1e-6)`` with b from seed 2 took 6) and its x
equals the unsharded port's, which tests/test_torch_struct.py holds
against the reference (tests/test_struct_parallel.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypre_tpu.problems.struct_problems import struct_laplacian as j_lap
from hypre_tpu.struct import PFMG as JPFMG
from hypre_tpu.struct.matrix import struct_matvec as j_matvec

from hypre_tpu_torch.convert import struct_from_numpy
from hypre_tpu_torch.krylov import pcg
from hypre_tpu_torch.parallel import make_mesh
from hypre_tpu_torch.problems.struct_problems import struct_laplacian
from hypre_tpu_torch.struct import PFMG
from hypre_tpu_torch.struct.matrix import struct_matvec
from hypre_tpu_torch.struct.par_struct import (
    ShardedStructMatrix, distribute_pfmg, distribute_struct_matrix,
    distribute_struct_vector,
)
from torch_one_thread import one_torch_thread  # noqa: F401

NSHARDS = 8
F64 = dict(dtype=torch.float64, device="cpu")
REFERENCE_3D_ITERATIONS = 6


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(NSHARDS, device="cpu")


def port_of(jA):
    return struct_from_numpy(np.asarray(jA.coeffs), jA.stencil.offsets,
                             jA.shape, jA.periodic, device="cpu")


MATVEC_CASES = {"32x16 axis 0": ((32, 16), 0, None),
                "16x32 axis 1": ((16, 32), 1, None),
                "32x8x8 axis 0": ((32, 8, 8), 0, None),
                "32x16 periodic axis 0": ((32, 16), 0, (True, False))}


@pytest.mark.parametrize("key", sorted(MATVEC_CASES))
def test_sharded_matvec_equals_the_unsharded(mesh, key):
    shape, axis, periodic = MATVEC_CASES[key]
    jA = j_lap(shape, constant=False)
    A = port_of(jA)
    if periodic:
        A = type(A)(coeffs=A.coeffs, stencil=A.stencil, shape=A.shape,
                    periodic=periodic)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape))
    Ad = distribute_struct_matrix(A, mesh, axis)
    assert isinstance(Ad, ShardedStructMatrix) and Ad.depth == 1
    # its own view of the ghosted slabs, with static offsets (kernel 2)
    assert Ad.dia is not A.dia and Ad.dia.offsets_static is not None
    y = Ad.layout.gather(Ad.mv(distribute_struct_vector(x, mesh, axis)))
    want = struct_matvec(A, x)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))
    if not periodic:  # and the reference's matvec on its coefficients
        want_j = np.asarray(j_matvec(jA, jnp.asarray(x.numpy())))
        np.testing.assert_allclose(y.numpy(), want_j, rtol=1e-12,
                                   atol=1e-12 * np.abs(want_j).max())


def test_sharded_pfmg_2d_takes_the_reference_iterations(mesh):
    shape = (64, 32)
    b_np = np.random.default_rng(1).standard_normal(shape)
    xj, ij = JPFMG().setup(j_lap(shape)).solve(jnp.asarray(b_np), rtol=1e-6)
    solver = PFMG().setup(struct_laplacian(shape, **F64))
    sd = distribute_pfmg(solver, mesh)
    assert all(lev.layout is not None for lev in sd.levels)
    x, info = sd.solve(distribute_struct_vector(torch.from_numpy(b_np), mesh),
                       rtol=1e-6)
    assert bool(info.converged)
    assert int(info.iterations) == int(ij.iterations)
    np.testing.assert_allclose(sd.fine_layout.gather(x).numpy(),
                               np.asarray(xj), rtol=0, atol=1e-8)


def test_sharded_pfmg_3d_takes_the_reference_iterations(mesh):
    shape = (32, 8, 8)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(shape))
    solver = PFMG().setup(struct_laplacian(shape, **F64))
    x0, i0 = solver.solve(b, rtol=1e-6)
    sd = distribute_pfmg(solver, mesh)
    x, info = sd.solve(distribute_struct_vector(b, mesh), rtol=1e-6)
    assert int(info.iterations) == int(i0.iterations) == \
        REFERENCE_3D_ITERATIONS
    np.testing.assert_allclose(sd.fine_layout.gather(x).numpy(),
                               x0.numpy(), rtol=0, atol=1e-8)


def test_a_coarse_level_that_does_not_split_is_replicated(mesh):
    # 24 rows over 8 shards: level 0 splits (3 a shard), its coarse grid
    # (12 rows) does not, and every level below stays whole
    shape = (24, 40)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(shape))
    solver = PFMG().setup(struct_laplacian(shape, **F64))
    sd = distribute_pfmg(solver, mesh)
    placed = [lev.layout is not None for lev in sd.levels]
    assert placed[0] and not any(placed[1:]) and sd.coarse_layout is None
    assert not isinstance(sd.levels[1].A, ShardedStructMatrix)
    x0, i0 = solver.solve(b, rtol=1e-6)
    x, info = sd.solve(distribute_struct_vector(b, mesh), rtol=1e-6)
    assert int(info.iterations) == int(i0.iterations)
    np.testing.assert_allclose(sd.fine_layout.gather(x).numpy(), x0.numpy(),
                               rtol=0, atol=1e-12)


def test_sharded_pfmg_pcg_takes_the_unsharded_iterations(mesh):
    # the struct driver's PFMG-PCG (id 11) on slabs: the operator and the
    # preconditioner both sharded, PCG over the flat slab vectors
    shape = (32, 32, 16)
    A = struct_laplacian(shape, **F64)
    solver = PFMG().setup(A)
    b = torch.ones(shape, dtype=torch.float64)
    _, i0 = pcg(A.as_linear_op(), b.reshape(-1), M=solver.precond(),
                rtol=1e-8, device="cpu")
    sd = distribute_pfmg(solver, mesh)
    bd = distribute_struct_vector(b, mesh).reshape(-1)
    _, info = pcg(sd.operator(), bd, M=sd.precond(), rtol=1e-8, device="cpu")
    assert int(info.iterations) == int(i0.iterations) > 0
