"""hypre_tpu_torch's distributed AMG (``parallel/par_setup.py``,
``par_amg.py``) on 8 shards of the local backend, against hypre_tpu.

The distributed PMIS must be exactly the reference's global PMIS (the
boundary exchanges make the neighbor maxima right, and the hash ties on
global row ids make the split shard-invariant). The distributed
hierarchy's operators and interpolation equal the reference's
single-device device setup (which the reference pins equal to its own
distributed setup, ``tests/test_par_setup.py:61-83``) to 1e-10, those of
the port's device setup on the same A in column order bit for bit, and
the distributed PCG takes the single-device PCG's iterations. All in
float64.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from hypre_tpu.amg.coarsen import pmis as j_pmis
from hypre_tpu.amg.device_setup import setup_hierarchy_device as j_device
from hypre_tpu.amg.hierarchy import setup_hierarchy as j_setup
from hypre_tpu.amg.hierarchy import unpad_hierarchy as j_unpad
from hypre_tpu.amg.strength import strength_mask as j_strength
from hypre_tpu.parallel import make_mesh as j_make_mesh
from hypre_tpu.parallel.par_amg import partition_hierarchy as j_partition
from hypre_tpu.problems.laplacian import laplacian_3d_7pt as j_lap7

import hypre_tpu_torch as H
from hypre_tpu_torch.amg.hierarchy import (
    amg_cycle, make_smoother, unpad_hierarchy,
)
from hypre_tpu_torch.convert import par_hierarchy_from_numpy
from hypre_tpu_torch.parallel import make_mesh, partition_ell
from hypre_tpu_torch.parallel.par_amg import partition_hierarchy
from hypre_tpu_torch.parallel.par_ell import collect_vector, distribute_vector
from hypre_tpu_torch.parallel.par_setup import (
    _gather_dense, par_rap_phase, par_split_phase, setup_hierarchy_par,
)
from torch_one_thread import one_torch_thread  # noqa: F401

NSHARDS = 8


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(NSHARDS, device="cpu")


def lap7(n):
    return H.laplacian_3d_7pt(n, n, n, dtype=torch.float64, device="cpu")


def dense(M):
    """A reference or port ELL matrix, dense on the host."""
    cols, vals = np.asarray(M.cols), np.asarray(M.vals)
    out = np.zeros((M.n_rows, M.n_cols))
    r, s = np.nonzero(cols >= 0)
    np.add.at(out, (r, cols[r, s]), vals[r, s])
    return out


@pytest.fixture(scope="module")
def reference_8():
    """The reference's single-device device setup of the 8^3 Laplacian at
    max_coarse_size=40 (unpadded), its PMIS split of the same operator,
    and the port's distributed hierarchy."""
    env = {k: os.environ.get(k) for k in ("HYPRE_TPU_NO_FAST_SETUP",
                                          "HYPRE_TPU_SHAPE_REGISTRY")}
    os.environ["HYPRE_TPU_NO_FAST_SETUP"] = "1"
    os.environ["HYPRE_TPU_SHAPE_REGISTRY"] = os.devnull
    try:
        jA = j_lap7(8, 8, 8)
        cf = np.asarray(j_pmis(jA, j_strength(jA, 0.25)))
        jh = j_unpad(j_device(dataclasses.replace(jA, shifts=None),
                              max_coarse_size=40))
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return cf, jh


def test_par_pmis_equals_the_references_global_pmis(reference_8, mesh):
    cf_ref, _ = reference_8
    Apar = partition_ell(lap7(8), mesh)
    _, _, cf, cmap, n_c = par_split_phase(Apar, 0.25, s_cap=12)
    np.testing.assert_array_equal(cf.numpy()[:512], cf_ref)
    assert n_c == int((cf_ref == 1).sum())
    expect = np.where(cf_ref == 1, np.cumsum(cf_ref == 1) - 1, -1)
    np.testing.assert_array_equal(cmap.numpy()[:512], expect)


def test_par_hierarchy_equals_the_reference(reference_8, mesh):
    _, jh = reference_8
    stats = []
    hier = setup_hierarchy_par(partition_ell(lap7(8), mesh),
                               max_coarse_size=40, level_stats=stats)
    assert len(hier.levels) == len(jh.levels) == len(stats)
    for lp, lr, st in zip(hier.levels, jh.levels, stats):
        assert lp.A.n_rows == lr.A.n_rows == st["n"]
        assert lp.P.n_cols == lr.P.n_cols == st["n_coarse"]
        np.testing.assert_allclose(_gather_dense(lp.A), dense(lr.A),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(
            _gather_dense(lp.P)[: lr.P.n_rows, : lr.P.n_cols], dense(lr.P),
            rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(_gather_dense(lp.Pt), dense(lr.P).T,
                                   rtol=1e-10, atol=1e-10)
    # the coarsest level: the reference's Galerkin operator, inverted
    nc = jh.coarse_inv.shape[0]
    np.testing.assert_allclose(hier.coarse_inv.numpy()[:nc, :nc],
                               np.asarray(jh.coarse_inv), rtol=1e-8,
                               atol=1e-10)


def test_rap_retries_at_the_widths_it_reports(mesh):
    # too narrow on purpose: each run reports the widths it needed (which
    # grow once its inputs stop being cut), and the retry loop of
    # setup_hierarchy_par ends at widths that hold the exact product
    from hypre_tpu_torch.parallel.par_setup import (
        _par_from_global_np, _transpose_sharded, par_from_global_cols,
        par_interp_phase,
    )

    A = partition_ell(lap7(8), mesh)
    scols, svals, cf, cmap, nc = par_split_phase(A, 0.25, 12)
    pc, pv, _ = par_interp_phase(A, scols, svals, cf, cmap, 16, 4, 0.0)
    P = par_from_global_cols(pc, pv, A.n_rows, nc, mesh)
    Pt = _par_from_global_np(*_transpose_sharded(P, nc), nc, A.n_rows, mesh)
    widths, runs = (4, 4), 0
    while True:
        c1, v1, *req = par_rap_phase(A, P, Pt, *widths)
        runs += 1
        if all(r <= w for r, w in zip(req, widths)):
            break
        widths = tuple(max(r, w) for r, w in zip(req, widths))
    assert runs > 1
    c2, v2, *req2 = par_rap_phase(A, P, Pt, *(w + 8 for w in widths))
    assert req2 == req
    torch.testing.assert_close(c1, c2[..., : c1.shape[2]])
    torch.testing.assert_close(v1, v2[..., : v1.shape[2]])
    assert bool((c2[..., c1.shape[2]:] < 0).all())


def test_distributed_pcg_takes_the_single_device_iterations(mesh):
    n = 16
    A = lap7(n)
    hier = setup_hierarchy_par(partition_ell(A, mesh), max_coarse_size=100)
    assert len(hier.levels) >= 2
    sm = make_smoother("l1-jacobi", 1.0, 2, 0.3)
    b_host = np.random.default_rng(0).standard_normal(A.n_rows)
    b = distribute_vector(b_host, mesh, A.n_rows)
    x, info = H.pcg(hier.levels[0].A.mv, b,
                    M=lambda r: amg_cycle(hier, r, smoother=sm), rtol=1e-8,
                    maxiter=60, device="cpu")
    xg = collect_vector(x, A.n_rows)
    r = b_host - A.mv(torch.from_numpy(xg)).numpy()
    assert bool(info.converged)
    assert np.linalg.norm(r) / np.linalg.norm(b_host) < 1e-6
    # the port's device setup on the same A with its rows in column order
    # (the order the distributed setup sums in) builds the same hierarchy,
    # bit for bit
    key = torch.where(A.cols >= 0, A.cols, torch.full_like(A.cols, 2**30))
    order = torch.sort(key, dim=1, stable=True)[1]
    A_ordered = H.EllMatrix(vals=torch.gather(A.vals, 1, order),
                            cols=torch.gather(A.cols, 1, order),
                            n_cols=A.n_cols)
    ref = unpad_hierarchy(H.setup_hierarchy_device(
        A_ordered, max_coarse_size=100, device="cpu"))
    assert [lv.A.n_rows for lv in ref.levels] == \
        [lv.A.n_rows for lv in hier.levels]
    for lp, lr in zip(hier.levels, ref.levels):
        np.testing.assert_array_equal(_gather_dense(lp.A), dense(lr.A))
        np.testing.assert_array_equal(
            _gather_dense(lp.P)[:, : lr.P.n_cols], dense(lr.P))
    _, info1 = H.pcg(ref.levels[0].A.mv, torch.from_numpy(b_host),
                     M=lambda r: amg_cycle(ref, r, smoother=sm), rtol=1e-8,
                     maxiter=60, device="cpu")
    assert int(info.iterations) == int(info1.iterations)


def test_hmis_coarsening_runs(mesh):
    # per-shard interior RS seeds + boundary PMIS: a valid split that
    # coarsens and converges in the PMIS class
    A = H.laplacian_2d_5pt(24, 24, dtype=torch.float64, device="cpu")
    Ap = partition_ell(A, mesh)
    b = distribute_vector(np.ones(A.n_rows), mesh)
    its = {}
    for coarsen in ("hmis", "pmis"):
        hier = setup_hierarchy_par(Ap, max_coarse_size=32, coarsen=coarsen)
        assert hier.levels[0].P.n_cols < A.n_rows
        _, info = H.pcg(Ap.mv, b, M=lambda r: amg_cycle(hier, r), rtol=1e-8,
                        device="cpu")
        assert bool(info.converged)
        its[coarsen] = int(info.iterations)
    assert abs(its["hmis"] - its["pmis"]) <= 3, its


def test_partition_hierarchy_keeps_the_iterations(mesh):
    # the default facade's native hierarchy, partitioned (15^3: the last
    # shard holds a padding row, which must stay zero)
    A = lap7(15)
    amg = H.BoomerAMG(max_coarse_size=100).setup(A, device="cpu")
    assert amg.setup_path == "native"
    part = partition_hierarchy(amg.ell_hierarchy, mesh)
    b_host = np.ones(A.n_rows)
    b = distribute_vector(b_host, mesh)
    sm = amg._smoother
    x, info = H.pcg(part.levels[0].A.mv, b,
                    M=lambda r: amg_cycle(part, r, smoother=sm), rtol=1e-8,
                    device="cpu")
    _, info1 = H.pcg(A.mv, torch.from_numpy(b_host), M=amg.precond(),
                     rtol=1e-8, device="cpu")
    assert bool(info.converged)
    assert int(info.iterations) == int(info1.iterations)
    assert x.shape[0] == 3376 and float(x[3375]) == 0.0


def test_par_hierarchy_from_numpy_takes_the_references_partition(mesh):
    # the reference's partitioned native hierarchy, carried across, equals
    # the port's partition of the port's (bit-equal) native hierarchy
    jm = j_make_mesh(NSHARDS)
    jh = j_partition(j_setup(j_lap7(9, 9, 9), setup_backend="native",
                             max_coarse_size=60), jm)

    def pdict(M):
        return {k: np.asarray(getattr(M, k)) if k not in (
            "offsets", "sizes", "n_rows", "n_cols") else getattr(M, k)
            for k in ("diag_vals", "diag_cols", "offd_vals", "offd_cols",
                      "send_idx", "offsets", "sizes", "n_rows", "n_cols")}

    d = {"levels": [{"A": pdict(lv.A), "P": pdict(lv.P), "Pt": pdict(lv.Pt),
                     "dinv": np.asarray(lv.dinv),
                     "l1inv": np.asarray(lv.l1inv),
                     "lmax": np.asarray(lv.lmax)} for lv in jh.levels],
         "coarse_inv": np.asarray(jh.coarse_inv)}
    theirs = par_hierarchy_from_numpy(d, mesh)
    mine = partition_hierarchy(H.setup_hierarchy(
        lap7(9), setup_backend="native", max_coarse_size=60, device="cpu"),
        mesh)
    assert len(mine.levels) == len(theirs.levels) >= 2
    for lm, lt in zip(mine.levels, theirs.levels):
        for name in ("A", "P", "Pt"):
            for k in ("diag_vals", "diag_cols", "offd_vals", "offd_cols",
                      "send_idx"):
                torch.testing.assert_close(getattr(getattr(lm, name), k),
                                           getattr(getattr(lt, name), k),
                                           rtol=0, atol=0)
        torch.testing.assert_close(lm.l1inv, lt.l1inv, rtol=0, atol=0)
    torch.testing.assert_close(mine.coarse_inv, theirs.coarse_inv, rtol=0,
                               atol=0)
