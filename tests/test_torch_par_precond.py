"""hypre_tpu_torch's distributed ILU family (``precond/par_ilu.py``) and
the distributed dispatch of Euclid, PILUT and ParaSails, against
hypre_tpu's on its 8-device CPU mesh, in float64.

The port holds the 8 shards in one process (the local backend); each
preconditioner is set up on the same 24^2 Laplacian partitioned over 8
shards, and its apply on one numpy-seeded vector must equal the
reference's to 1e-10. The reference objects are built once per module.
Its Krylov solves with these preconditioners cost 10-20 s of XLA compile
each on the CPU, so their iteration counts are recorded below (the
reference's ``pcg``/``gmres`` over ``par_spmv`` on its 8-device mesh,
rtol 1e-8, b = ones).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypre_tpu.parallel import make_mesh as j_make_mesh
from hypre_tpu.parallel import partition_ell as j_partition
from hypre_tpu.parallel.par_ell import collect_vector as j_collect
from hypre_tpu.parallel.par_ell import distribute_vector as j_distribute
from hypre_tpu.precond import par_ilu as J
from hypre_tpu.problems.laplacian import laplacian_2d_5pt as j_lap5

import hypre_tpu_torch as H
from hypre_tpu_torch import precond as TP
from hypre_tpu_torch.convert import ell_from_numpy
from hypre_tpu_torch.parallel import ParEllMatrix, make_mesh, partition_ell
from hypre_tpu_torch.parallel.par_ell import collect_vector, distribute_vector
from hypre_tpu_torch.precond import par_ilu as T
from torch_one_thread import one_torch_thread  # noqa: F401

NSHARDS = 8
ILUT_KNOBS = dict(fill_levels=1, drop_tolerance=1e-3, factor_row_size=8)
# the reference's iterations (see the module docstring)
REFERENCE_ITERATIONS = {"pcg ParILU": 30, "pcg Euclid(level=1)": 35,
                        "gmres PILUT(10, 1e-3)": 17}


def nnz(P) -> int:
    return int((np.asarray(P.diag_cols) >= 0).sum()
               + (np.asarray(P.offd_cols) >= 0).sum())


@pytest.fixture(scope="module")
def case():
    jA = j_lap5(24, 24)
    tA = ell_from_numpy(np.asarray(jA.vals), np.asarray(jA.cols), jA.n_cols,
                        device="cpu")
    jm, tm = j_make_mesh(NSHARDS), make_mesh(NSHARDS, device="cpu")
    r = np.random.default_rng(3).standard_normal(jA.n_rows)
    return dict(jA=jA, tA=tA, jm=jm, tm=tm, jAp=j_partition(jA, jm),
                tAp=partition_ell(tA, tm), r=r, n=jA.n_rows)


@pytest.fixture(scope="module")
def ref(case):
    """The reference's objects and applies, built once."""
    jAp, jm, n = case["jAp"], case["jm"], case["n"]
    rd = j_distribute(jnp.asarray(case["r"]), jm)
    jx = J.par_extend_pattern(jAp, 1)
    out = {"envelope_nnz": nnz(jx)}
    for key, obj in (("ilu0", J.ParILU().setup(jAp)),
                     ("ilu1", J.ParILU().setup(jx)),
                     ("ilut", J.ParILUT(**ILUT_KNOBS).setup(jAp))):
        out[key] = j_collect(obj.precond()(rd), n)
    return out


def port_apply(case, obj):
    rd = distribute_vector(case["r"], case["tm"])
    return collect_vector(obj.precond()(rd), case["n"])


def close(z, z_ref):
    np.testing.assert_allclose(z, z_ref, rtol=1e-10,
                               atol=1e-10 * np.abs(z_ref).max())


def pcg_count(case, M) -> int:
    bd = distribute_vector(np.ones(case["n"]), case["tm"])
    _, info = H.pcg(case["tAp"].mv, bd, M=M, rtol=1e-8, device="cpu")
    assert bool(info.converged)
    return int(info.iterations)


def test_par_ilu_apply_equals_the_reference(case, ref):
    close(port_apply(case, T.ParILU().setup(case["tAp"])), ref["ilu0"])


def test_ilu1_envelope_and_apply_equal_the_reference(case, ref):
    # Euclid's ILU(1) on a ParEllMatrix: par_extend_pattern, then ParILU
    tx = T.par_extend_pattern(case["tAp"], 1)
    assert nnz(tx) == ref["envelope_nnz"] > nnz(case["tAp"])
    close(port_apply(case, T.ParILU().setup(tx)), ref["ilu1"])


def test_par_ilut_apply_equals_the_reference_on_8_shards(case, ref):
    close(port_apply(case, T.ParILUT(**ILUT_KNOBS).setup(case["tAp"])),
          ref["ilut"])


@pytest.mark.parametrize("what", sorted(REFERENCE_ITERATIONS))
def test_krylov_takes_the_reference_iterations(case, what):
    tAp = case["tAp"]
    if what == "pcg ParILU":
        got = pcg_count(case, T.ParILU().setup(tAp).precond())
    elif what == "pcg Euclid(level=1)":
        got = pcg_count(case, TP.Euclid().setup(tAp).precond())
    else:
        bd = distribute_vector(np.ones(case["n"]), case["tm"])
        M = TP.PILUT(factor_row_size=10, drop_tolerance=1e-3).setup(
            tAp).precond()
        _, info = H.gmres(tAp.mv, bd, M=M, rtol=1e-8, device="cpu")
        assert bool(info.converged)
        got = int(info.iterations)
    assert got == REFERENCE_ITERATIONS[what]


def test_par_ilut_honours_factor_row_size_per_side():
    # tests/test_multihost.py:233-260: the envelope grows the pattern and
    # the dual drop keeps at most factor_row_size entries a side
    A = H.laplacian_2d_5pt(16, 16, dtype=torch.float64, device="cpu")
    Ap = partition_ell(A, make_mesh(NSHARDS, device="cpu"))
    assert nnz(T.par_extend_pattern(Ap, 1)) > nnz(Ap)
    p = T.ParILUT(fill_levels=1, drop_tolerance=0.0, factor_row_size=3,
                  factor_sweeps=6, solve_sweeps=4).setup(Ap)
    for F in (p.L, p.Us):
        per_row = ((F.diag_cols >= 0).sum(dim=2)
                   + (F.offd_cols >= 0).sum(dim=2))
        assert int(per_row.max()) == 3


def test_par_ilut_one_shard_equals_eight(case):
    # the 8-shard factorization acts as the same algorithm on one shard
    one = make_mesh(1, device="cpu")
    p1 = T.ParILUT(**ILUT_KNOBS).setup(partition_ell(case["tA"], one))
    p8 = T.ParILUT(**ILUT_KNOBS).setup(case["tAp"])
    z1 = collect_vector(p1.precond()(distribute_vector(case["r"], one)),
                        case["n"])
    close(port_apply(case, p8), z1)


@pytest.mark.parametrize("name", ["Euclid", "PILUT", "ParaSails"])
def test_distributed_dispatch(case, name):
    # Euclid, PILUT and ParaSails on a ParEllMatrix take the distributed
    # path (hypre_tpu/precond/euclid.py:89-109,136-149, parasails.py:82-92)
    # and apply as the distributed class they wrap
    from hypre_tpu_torch.precond.par_sails import ParSails

    # exported as the reference exports them (precond/__init__.py:16,18)
    assert TP.ParILU is T.ParILU and TP.ParSails is ParSails
    tAp = case["tAp"]
    obj = getattr(TP, name)().setup(tAp)
    if name == "Euclid":
        # Euclid's sweeps are ILU's (5 and 6), ParILU's defaults 8 and 6
        want = T.ParILU(factor_sweeps=5).setup(T.par_extend_pattern(tAp, 1))
        assert isinstance(obj._par, T.ParILU)
    elif name == "PILUT":
        want = T.ParILUT(drop_tolerance=1e-4, factor_row_size=20).setup(tAp)
        assert isinstance(obj._par, T.ParILUT)
    else:
        want = ParSails().setup(tAp)
        assert isinstance(obj.M, ParEllMatrix)
    assert np.array_equal(port_apply(case, obj), port_apply(case, want))
