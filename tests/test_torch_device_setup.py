"""hypre_tpu_torch.amg.device_setup against hypre_tpu.amg.device_setup.

Mirrors tests/test_device_setup.py case for case: the same numpy arrays go
through the JAX function (CPU, float64, its jnp route) and through the
port with CPU tensors. CF splittings, level sizes, slab widths and sparsity
patterns must be equal exactly; float64 values to 1e-12 relative; the
coarse inverse to 1e-8; AMG-PCG must take the reference's iteration count.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.amg import device_setup as JD
from hypre_tpu.amg import hierarchy as j_hier
from hypre_tpu.amg.coarsen import coarse_map as j_coarse_map, pmis as j_pmis
from hypre_tpu.amg.interp import ext_plus_i_interp as j_extpi
from hypre_tpu.amg.strength import strength_mask as j_strength
from hypre_tpu.krylov import pcg as j_pcg
from hypre_tpu.problems.laplacian import laplacian_2d_5pt as j_lap5, \
    laplacian_3d_7pt as j_lap7
from hypre_tpu.seq.ell import ell_from_dense as j_from_dense

import hypre_tpu_torch as H
from hypre_tpu_torch.amg import device_setup as TD
from hypre_tpu_torch.convert import ell_from_numpy
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_spans import span_paths


RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def reference_setup_env(tmp_path_factory):
    """The reference records every setup in a registry file and replays
    it; keep the file in a temporary directory and the replay off."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HYPRE_TPU_SHAPE_REGISTRY",
              str(tmp_path_factory.mktemp("reg") / "reg.json"))
    mp.setenv("HYPRE_TPU_NO_FAST_SETUP", "1")
    yield
    mp.undo()


def to_t(jA) -> H.EllMatrix:
    """The port's copy of a reference ELL matrix (CPU, same dtype)."""
    return ell_from_numpy(np.asarray(jA.vals), np.asarray(jA.cols),
                          jA.n_cols, jA.shifts, device="cpu")


def tt(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, ref, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max(initial=0.0) <= rtol * max(
        np.abs(ref).max(initial=0.0), 1e-300)


def same_slab(got_c, got_v, ref_c, ref_v):
    assert np.array_equal(got_c.numpy(), np.asarray(ref_c))
    assert close(got_v, ref_v)


def split_of(jA):
    """Reference strength pattern and first-pass PMIS of jA as numpy."""
    S = j_strength(jA, 0.25)
    cf = j_pmis(jA, S)
    scols = np.asarray(jnp.where(S, jA.cols, -1))
    svals = np.asarray(jnp.where(S, jA.vals, 0.0))
    return S, cf, scols, svals


def nonsymmetric_matrix(n=20, seed=5):
    """Pattern-symmetric, value-nonsymmetric, diagonally dominant."""
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, n)) < 0.2,
                     -np.abs(rng.standard_normal((n, n))), 0.0)
    np.fill_diagonal(dense, 0.0)
    pat = (dense != 0) | (dense.T != 0)
    dense = np.where(pat & (dense == 0), -0.05, dense)
    np.fill_diagonal(dense, 4.0 + np.abs(dense).sum(axis=1))
    return j_from_dense(dense)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_shifts", [False, True])
def test_pmis_device_matches_reference(use_shifts):
    jA = j_lap5(12, 11)
    _, _, scols, _ = split_of(jA)
    shifts = jA.shifts if use_shifts else None
    ref = np.asarray(JD.pmis_device(jnp.asarray(scols), jA.n_rows,
                                    shifts=shifts))
    got = TD.pmis_device(tt(scols), jA.n_rows, shifts=shifts)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    # and the oracle path of both packages
    assert np.array_equal(ref, np.asarray(j_pmis(jA, j_strength(jA, 0.25))))


@pytest.mark.parametrize("use_shifts", [False, True])
def test_second_pass_pmis_matches_reference_on_both_routes(use_shifts):
    jA = j_lap7(7, 6, 5)
    _, cf1, scols, _ = split_of(jA)
    shifts = jA.shifts if use_shifts else None
    cap = 32 if use_shifts else 64
    ref = np.asarray(JD.second_pass_pmis(jnp.asarray(scols), cf1, jA.n_rows,
                                         s2_cap=cap, shifts=shifts))
    got = TD.second_pass_pmis(tt(scols), tt(np.asarray(cf1)), jA.n_rows,
                              s2_cap=cap, shifts=shifts)
    assert np.array_equal(got.numpy(), ref)
    other = TD.second_pass_pmis(tt(scols), tt(np.asarray(cf1)), jA.n_rows,
                                s2_cap=64 if use_shifts else 32,
                                shifts=None if use_shifts else jA.shifts)
    assert torch.equal(got, other)  # the two routes agree with each other
    assert 0 < int((got == 1).sum()) < int((np.asarray(cf1) == 1).sum())


def test_paired_transpose_vals_sort_route():
    jA = nonsymmetric_matrix()
    ref = JD.paired_transpose_vals(jA.cols, jA.vals, jA.n_rows)
    got = TD.paired_transpose_vals(tt(np.asarray(jA.cols)),
                                   tt(np.asarray(jA.vals)), jA.n_rows)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    dense = np.zeros((jA.n_rows, jA.n_rows))
    cols, vals = np.asarray(jA.cols), np.asarray(jA.vals)
    for i in range(jA.n_rows):
        dense[i, cols[i][cols[i] >= 0]] = vals[i][cols[i] >= 0]
    for i in range(jA.n_rows):
        for a, c in enumerate(cols[i]):
            if c >= 0:
                assert got[i, a] == dense[c, i]


def test_paired_transpose_vals_shift_route():
    jA = j_lap5(7, 6)
    vals = np.asarray(jA.vals).copy()
    vals[:, 1] *= 1.5  # asymmetric values, same stencil structure
    cols = np.asarray(jA.cols)
    ref = JD.paired_transpose_vals(jnp.asarray(cols), jnp.asarray(vals),
                                   jA.n_rows, shifts=jA.shifts)
    by_shift = TD.paired_transpose_vals(tt(cols), tt(vals), jA.n_rows,
                                        shifts=jA.shifts)
    by_sort = TD.paired_transpose_vals(tt(cols), tt(vals), jA.n_rows)
    assert np.array_equal(by_shift.numpy(), np.asarray(ref))
    assert torch.equal(by_shift, by_sort)


@pytest.mark.parametrize("s_cap,with_back,mxrs", [
    (64, False, 1.0), (3, False, 1.0), (3, True, 1.0), (64, True, 0.9)])
def test_strength_and_cap_matches_reference(s_cap, with_back, mxrs):
    jA = nonsymmetric_matrix(24, seed=8)
    ref = JD.strength_and_cap(jA, 0.25, s_cap, with_back=with_back,
                              mxrs=mxrs)
    got = TD.strength_and_cap(to_t(jA), 0.25, s_cap, with_back=with_back,
                              mxrs=mxrs)
    assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
    same_slab(got[1], got[2], ref[1], ref[2])
    if with_back:
        assert close(got[3], ref[3])
    else:
        assert got[3] is None and ref[3] is None


def extpi_inputs(jA, use_shifts=False, nonsym=False):
    shifts = jA.shifts if use_shifts else None
    _, scols, svals, sback = JD.strength_and_cap(
        jA, 0.25, s_cap=jA.k, shifts=shifts, with_back=nonsym)
    cf = JD.pmis_device(scols, jA.n_rows, shifts=shifts)
    back_hat = None
    if nonsym:
        diag = jA.diagonal()
        sgn = jnp.where(diag >= 0, 1.0, -1.0)
        g = sgn[jnp.maximum(scols, 0)]
        back_hat = jnp.where(sback * g < 0, sback, 0.0)
    return shifts, scols, svals, cf, back_hat


def t_or_none(a):
    return None if a is None else tt(np.asarray(a))


@pytest.mark.parametrize("case", ["symmetric", "shifts", "back_hat", "trunc"])
def test_ext_plus_i_device_matches_reference(case):
    nonsym = case == "back_hat"
    jA = nonsymmetric_matrix(26, seed=9) if nonsym else j_lap5(10, 9)
    shifts, scols, svals, cf, back_hat = extpi_inputs(
        jA, use_shifts=case == "shifts", nonsym=nonsym)
    kw = dict(p_max_elmts=4, trunc_factor=0.1) if case == "trunc" else {}
    rc, rv, rreq = JD.ext_plus_i_device(jA, scols, svals, cf, out_k=24,
                                        shifts=shifts, back_hat=back_hat,
                                        **kw)
    gc, gv, greq = TD.ext_plus_i_device(
        to_t(jA), tt(np.asarray(scols)), tt(np.asarray(svals)),
        tt(np.asarray(cf)), out_k=24, shifts=shifts,
        back_hat=t_or_none(back_hat), **kw)
    same_slab(gc, gv, rc, rv)
    assert int(greq) == int(rreq)
    cmap, _ = j_coarse_map(cf)
    rm = JD.remap_fine_to_coarse(rc, rv, cmap)
    gm = TD.remap_fine_to_coarse(gc, gv, tt(np.asarray(cmap)))
    same_slab(gm[0], gm[1], rm[0], rm[1])


def test_ext_plus_i_distribution_hooks_match_reference():
    """col_sources / out_cols are plain arguments: gather sources over the
    column space and the emitted column numbering (here a coarse
    numbering, which makes the later remap unnecessary)."""
    jA = j_lap5(10, 9)
    _, scols, svals, cf, _ = extpi_inputs(jA)
    cmap, _ = j_coarse_map(cf)
    diag = jA.diagonal()
    sgn = jnp.where(diag >= 0, 1.0, -1.0)
    is_c = cf == 1
    jpf, jpi = JD.extpi_pack_sources(scols, svals, sgn, is_c, cmap_cols=cmap)
    t = lambda a: tt(np.asarray(a))
    tpf, tpi = TD.extpi_pack_sources(t(scols), t(svals), t(sgn), t(is_c),
                                     cmap_cols=t(cmap))
    assert np.array_equal(tpi.numpy(), np.asarray(jpi))
    assert close(tpf, jpf)
    cand1 = jnp.where(scols >= 0, cmap[jnp.maximum(scols, 0)], -1)
    ref = JD.ext_plus_i_device(
        jA, scols, svals, cf, out_k=24, col_sources=(is_c, jpf, jpi, sgn),
        out_cols=(cand1, cmap))
    got = TD.ext_plus_i_device(
        to_t(jA), t(scols), t(svals), t(cf), out_k=24,
        col_sources=(t(is_c), tpf, tpi, t(sgn)),
        out_cols=(t(cand1), t(cmap)))
    same_slab(got[0], got[1], ref[0], ref[1])
    # the same P as the default route followed by the remap
    pc, pv, _ = TD.ext_plus_i_device(to_t(jA), t(scols), t(svals), t(cf),
                                     out_k=24)
    pc, pv = TD.remap_fine_to_coarse(pc, pv, t(cmap))
    n_c = int((np.asarray(cf) == 1).sum())

    def dense(c, v):
        d = np.zeros((jA.n_rows, n_c))
        for i in range(jA.n_rows):
            d[i, c[i][c[i] >= 0]] = v[i][c[i] >= 0]
        return d

    assert np.allclose(dense(got[0].numpy(), got[1].numpy()),
                       dense(pc.numpy(), pv.numpy()), rtol=1e-12, atol=1e-15)


def test_ext_plus_i_oneshot_chunked_and_slot_blocked_agree(monkeypatch):
    # gather route: one-shot = row-chunked
    jA = dataclasses.replace(j_lap5(13, 11), shifts=None)
    _, scols, svals, cf, _ = extpi_inputs(jA)
    args = (to_t(jA), tt(np.asarray(scols)), tt(np.asarray(svals)),
            tt(np.asarray(cf)))
    p1 = TD.ext_plus_i_device(*args, out_k=24, chunks=1)
    p4 = TD.ext_plus_i_device(*args, out_k=24, chunks=4)
    assert torch.equal(p1[0], p4[0]) and torch.equal(p1[1], p4[1])
    assert int(p1[2]) == int(p4[2])
    ref = JD.ext_plus_i_device(jA, scols, svals, cf, out_k=24, chunks=4)
    same_slab(p4[0], p4[1], ref[0], ref[1])
    # stencil route: one-shot = slot-blocked
    jA = j_lap7(6, 5, 4)
    shifts, scols, svals, cf, _ = extpi_inputs(jA, use_shifts=True)
    args = (to_t(jA), tt(np.asarray(scols)), tt(np.asarray(svals)),
            tt(np.asarray(cf)))
    one = TD.ext_plus_i_device(*args, out_k=32, shifts=shifts)
    monkeypatch.setattr(TD, "_SLOT_BLOCK_BUDGET", 1.0)  # force blocking
    blk = TD.ext_plus_i_device(*args, out_k=32, shifts=shifts)
    assert int(blk[2]) <= 32
    assert torch.equal(one[0], blk[0]) and close(blk[1], one[1].numpy())
    monkeypatch.setattr(JD, "_SLOT_BLOCK_BUDGET", 1.0)
    ref = JD.ext_plus_i_device(jA, scols, svals, cf, out_k=32, shifts=shifts)
    same_slab(blk[0], blk[1], ref[0], ref[1])
    assert int(blk[2]) == int(ref[2])


def spgemm_inputs(jA):
    S, cf, _, _ = split_of(jA)
    cmap, n_c = j_coarse_map(cf)
    P = j_extpi(jA, S, cf, cmap, int(n_c))
    return P, int(n_c)


@pytest.mark.parametrize("use_shifts", [False, True])
def test_spgemm_slab_matches_reference(use_shifts):
    jA = j_lap5(9, 8)
    P, _ = spgemm_inputs(jA)
    shifts = jA.shifts if use_shifts else None
    t_args = tuple(tt(np.asarray(a))
                   for a in (jA.cols, jA.vals, P.cols, P.vals))
    for kw in (dict(), dict(max_elmts=4, rescale_rowsum=True)):
        rc, rv, rreq = JD.spgemm_slab(jA.cols, jA.vals, P.cols, P.vals,
                                      out_k=32, shifts=shifts, **kw)
        gc, gv, greq = TD.spgemm_slab(*t_args, out_k=32, shifts=shifts, **kw)
        same_slab(gc, gv, rc, rv)
        assert int(greq) == int(rreq) <= 32


def test_spgemm_oneshot_chunked_and_slot_blocked_agree(monkeypatch):
    jA = j_lap5(13, 11)
    P, _ = spgemm_inputs(jA)
    t_args = tuple(tt(np.asarray(a))
                   for a in (jA.cols, jA.vals, P.cols, P.vals))
    c1 = TD.spgemm_slab(*t_args, 32, chunks=1)
    c3 = TD.spgemm_slab(*t_args, 32, chunks=3)
    assert torch.equal(c1[0], c3[0]) and torch.equal(c1[1], c3[1])
    assert int(c1[2]) == int(c3[2])
    one = TD.spgemm_slab(*t_args, 32, shifts=jA.shifts)
    monkeypatch.setattr(TD, "_SLOT_BLOCK_BUDGET", 1.0)  # force blocking
    blk = TD.spgemm_slab(*t_args, 32, shifts=jA.shifts)
    assert int(blk[2]) == int(one[2]) == int(c1[2])
    # the one-shot slab is only as wide as its candidates (5 x 6 < 32)
    w = one[0].shape[1]
    assert w == 30 and bool((blk[0][:, w:] == -1).all())
    assert torch.equal(one[0], blk[0][:, :w])
    assert close(blk[1][:, :w], one[1].numpy())
    assert torch.equal(one[0], c1[0]) and close(one[1], c1[1].numpy())
    # truncation applied once at the end of the blocked path
    blk2 = TD.spgemm_slab(*t_args, 32, shifts=jA.shifts, max_elmts=4,
                          rescale_rowsum=True)
    monkeypatch.setattr(JD, "_SLOT_BLOCK_BUDGET", 1.0)
    ref2 = JD.spgemm_slab(jA.cols, jA.vals, P.cols, P.vals, 32,
                          shifts=jA.shifts, max_elmts=4, rescale_rowsum=True)
    same_slab(blk2[0], blk2[1], ref2[0], ref2[1])


def test_transpose_slab_matches_reference():
    jA = j_lap5(9, 8)
    P, n_c = spgemm_inputs(jA)
    for out_k in (16, 3):  # wide enough, and too narrow (req reports it)
        rc, rv, rreq = JD.transpose_slab(P.cols, P.vals, n_c, out_k=out_k)
        gc, gv, greq = TD.transpose_slab(tt(np.asarray(P.cols)),
                                         tt(np.asarray(P.vals)), n_c,
                                         out_k=out_k)
        same_slab(gc, gv, rc, rv)
        assert int(greq) == int(rreq)
    assert int(greq) > 3


@pytest.mark.parametrize("use_shifts", [False, True])
def test_multipass_interp_device_matches_reference(use_shifts):
    jA = j_lap5(12, 10)
    _, cf1, scols, svals = split_of(jA)
    shifts = jA.shifts if use_shifts else None
    cf = JD.second_pass_pmis(jnp.asarray(scols), cf1, jA.n_rows, s2_cap=24)
    cmap, n_c = j_coarse_map(cf)
    ref = JD.multipass_interp_device(jA, jnp.asarray(scols),
                                     jnp.asarray(svals), cf, cmap, 4,
                                     shifts=shifts)
    got = TD.multipass_interp_device(
        to_t(jA), tt(scols), tt(svals), tt(np.asarray(cf)),
        tt(np.asarray(cmap)), 4, shifts=shifts)
    same_slab(got[0], got[1], ref[0], ref[1])
    assert int(got[2]) == int(ref[2]) and int(got[3]) == int(ref[3]) == 0
    # too few passes leave rows unassigned, and both say how many
    ref1 = JD.multipass_interp_device(jA, jnp.asarray(scols),
                                      jnp.asarray(svals), cf, cmap, 4,
                                      max_passes=1)
    got1 = TD.multipass_interp_device(
        to_t(jA), tt(scols), tt(svals), tt(np.asarray(cf)),
        tt(np.asarray(cmap)), 4, max_passes=1)
    assert int(got1[3]) == int(ref1[3]) > 0


def test_direct_interp_slab_matches_reference():
    jA = j_lap5(10, 9)
    S, cf, _, _ = split_of(jA)
    rc, rv = JD.direct_interp_slab(jA, S, cf)
    gc, gv = TD.direct_interp_slab(to_t(jA), tt(np.asarray(S)),
                                   tt(np.asarray(cf)))
    same_slab(gc, gv, rc, rv)


def test_buckets_match_reference():
    for k in (1, 4, 5, 13, 33, 63, 64, 65, 97, 700):
        assert TD._bucket(k) == JD._bucket(k)
    for n in (1, 256, 257, 343, 384, 385, 1000, 126394, 2097152):
        assert TD._row_bucket(n) == JD._row_bucket(n)


# ---------------------------------------------------------------------------
# the orchestrator
# ---------------------------------------------------------------------------

CASES = {
    "5pt-48": (lambda: j_lap5(48, 48),
               dict(max_coarse_size=40, relax="l1-jacobi")),
    "7pt-16-agg": (lambda: j_lap7(16, 16, 16),
                   dict(max_coarse_size=60, agg_num_levels=1)),
    "5pt-10x9-bucket": (lambda: j_lap5(10, 9),
                        dict(max_coarse_size=20, row_bucket=True)),
    "5pt-10x9-nobucket": (lambda: j_lap5(10, 9),
                          dict(max_coarse_size=20, row_bucket=False)),
    "7pt-7-gather-nobucket": (
        lambda: dataclasses.replace(j_lap7(7, 7, 7), shifts=None),
        dict(max_coarse_size=40, row_bucket=False)),
    "7pt-12-drop": (lambda: j_lap7(12, 12, 12),
                    dict(max_coarse_size=100, relax="chebyshev",
                         agg_num_levels=1, coarse_drop_tol=0.02)),
    "nonsym-mrs": (lambda: nonsymmetric_matrix(300, seed=3),
                   dict(max_coarse_size=30, max_row_sum=0.9,
                        symmetric=False)),
}
_built: dict = {}


def built(name):
    """(jax A, port A, jax hierarchy, port hierarchy), built once."""
    if name not in _built:
        make, kw = CASES[name]
        jA = make()
        tA = to_t(jA)
        plan = {}
        _built[name] = (jA, tA, JD.setup_hierarchy_device(jA, **kw),
                        H.setup_hierarchy_device(tA, device="cpu",
                                                 width_plan=plan, **kw),
                        plan)
    return _built[name]


@pytest.mark.parametrize("name", list(CASES))
def test_setup_hierarchy_device_matches_reference(name):
    jA, tA, jh, th, plan = built(name)
    assert len(th.levels) == len(jh.levels) >= 1
    assert th.n_fine == jh.n_fine == jA.n_rows
    assert th.n_level_true == tuple(jh.n_level_true)
    if CASES[name][1].get("row_bucket", True):
        assert th.n_level_true[0] == jA.n_rows
        assert th.levels[0].A.n_rows == TD._row_bucket(jA.n_rows)
    else:
        assert th.n_level_true == ()
        assert th.levels[0].A.n_rows == jA.n_rows
    assert th.levels[0].A.shifts == jh.levels[0].A.shifts
    for li, (jl, tl) in enumerate(zip(jh.levels, th.levels)):
        assert tl.cf.dtype == torch.int8
        assert np.array_equal(tl.cf.numpy(), np.asarray(jl.cf)), li
        for tM, jM in ((tl.A, jl.A), (tl.P, jl.P), (tl.Pt, jl.Pt)):
            assert (tM.n_rows, tM.k, tM.n_cols) == \
                (jM.n_rows, jM.k, jM.n_cols), li
            same_slab(tM.cols, tM.vals, jM.cols, jM.vals)
        assert close(tl.dinv, jl.dinv) and close(tl.l1inv, jl.l1inv)
        assert close(tl.lmax, jl.lmax)
        assert plan[(li, "p")] == tl.P.k
    assert close(th.coarse_inv, jh.coarse_inv, 1e-8)


@pytest.mark.parametrize("name", ["5pt-48", "7pt-16-agg", "5pt-10x9-bucket",
                                  "7pt-12-drop"])
def test_amg_pcg_on_device_setup_takes_the_reference_iterations(name):
    jA, tA, jh, th, _ = built(name)
    relax = CASES[name][1].get("relax", "l1-jacobi")
    b = np.random.default_rng(0).standard_normal(jA.n_rows)
    j_sm = j_hier.make_smoother(relax, 1.0, 2, 0.3)
    t_sm = H.make_smoother(relax, 1.0, 2, 0.3)
    _, jinfo = j_pcg(jA.mv, jnp.asarray(b),
                     M=lambda r: j_hier.amg_cycle(jh, r, smoother=j_sm),
                     rtol=1e-8, maxiter=60)
    tx, tinfo = H.pcg(tA.mv, torch.from_numpy(b),
                      M=lambda r: H.amg_cycle(th, r, smoother=t_sm),
                      rtol=1e-8, maxiter=60, device="cpu")
    assert bool(tinfo.converged) and bool(jinfo.converged)
    assert int(tinfo.iterations) == int(jinfo.iterations) <= 20
    r = torch.from_numpy(b) - tA.mv(tx)
    assert float(r.norm() / np.linalg.norm(b)) < 1e-6


def test_row_bucket_is_an_algorithmic_no_op():
    """The reference's own pin: the bucketed hierarchy, unpadded, equals
    the one built without buckets."""
    _, _, _, hb, _ = built("5pt-10x9-bucket")
    _, _, _, hu, _ = built("5pt-10x9-nobucket")
    hb = H.unpad_hierarchy(hb)
    assert hb.n_fine == 0 and hb.n_level_true == ()
    assert len(hb.levels) == len(hu.levels)
    for lb, lu in zip(hb.levels, hu.levels):
        for Mb, Mu in ((lb.A, lu.A), (lb.P, lu.P), (lb.Pt, lu.Pt)):
            assert Mb.shape == Mu.shape
            assert torch.equal(Mb.cols, Mu.cols)
            assert close(Mb.vals, Mu.vals.numpy())
        assert torch.equal(lb.cf, lu.cf)
    assert close(hb.coarse_inv, hu.coarse_inv.numpy(), 1e-8)
    assert H.unpad_hierarchy(hu) is hu


def test_aggressive_level_coarsens_harder_and_galerkin_is_exact():
    jA, tA, _, th, _ = built("7pt-16-agg")
    plain = H.setup_hierarchy_device(tA, device="cpu", max_coarse_size=60)
    assert th.n_level_true[1] < 0.6 * plain.n_level_true[1]

    def dense(M):
        d = torch.zeros(M.n_rows, M.n_cols, dtype=M.dtype)
        rows = torch.arange(M.n_rows)[:, None].expand(M.cols.shape)
        ok = M.cols >= 0
        d[rows[ok], M.cols[ok].long()] = M.vals[ok]
        return d

    lev = plain.levels[0]
    Pf = dense(lev.P)
    assert close(dense(plain.levels[1].A),
                 (Pf.T @ dense(lev.A) @ Pf).numpy(), 1e-12)
    assert close(dense(lev.Pt), Pf.T.numpy(), 0.0)


def test_setup_hierarchy_dispatches_to_the_device_backend():
    jA, tA, _, th, _ = built("7pt-16-agg")
    via = H.setup_hierarchy(tA, setup_backend="device", agg_num_levels=1,
                            max_coarse_size=60, relax="l1-jacobi",
                            device="cpu")
    assert via.n_level_true == th.n_level_true
    for a, b in zip(via.levels, th.levels):
        assert torch.equal(a.A.cols, b.A.cols)
        assert torch.equal(a.A.vals, b.A.vals)
        assert torch.equal(a.P.vals, b.P.vals)
    with pytest.raises(ValueError, match="pmis"):
        H.setup_hierarchy(tA, setup_backend="device", coarsen="ruge",
                          device="cpu")
    with pytest.raises(ValueError, match="not wired"):
        H.setup_hierarchy(tA, setup_backend="device", nongalerkin_tol=0.1,
                          device="cpu")


def test_two_setups_give_the_same_bits_and_the_plan_is_reused():
    jA, tA, _, th, plan = built("7pt-12-drop")
    kw = CASES["7pt-12-drop"][1]
    before = dict(plan)
    again = H.setup_hierarchy_device(tA, device="cpu", width_plan=plan, **kw)
    assert plan == before
    for a, b in zip(again.levels, th.levels):
        for Ma, Mb in ((a.A, b.A), (a.P, b.P), (a.Pt, b.Pt)):
            assert torch.equal(Ma.cols, Mb.cols)
            assert torch.equal(Ma.vals, Mb.vals)
    assert torch.equal(again.coarse_inv, th.coarse_inv)


def test_stage_times_and_memory_guard():
    from hypre_tpu_torch.core import memory

    _, tA, _, _, _ = built("5pt-10x9-bucket")
    _, paths = span_paths(lambda: H.setup_hierarchy_device(
        tA, device="cpu", max_coarse_size=20))
    assert {("setup.slow", f"setup.L0.{stage}") for stage in (
        "split", "interp", "ap", "transpose", "rap")} \
        | {("setup.slow", "setup.coarse_inv")} <= set(paths)
    # on a CPU device there is no budget and the guard passes
    assert memory.hbm_bytes_limit("cpu") == 0
    assert memory.hbm_bytes_free("cpu") == 0
    memory.check_hbm_request(10**15, "cpu")


def test_singular_coarse_operator_takes_the_pinv_retry():
    """A pure Neumann-like operator (zero row sums) has a singular coarsest
    matrix; both packages fall back to the pseudo-inverse."""
    n = 40
    dense = np.zeros((n, n))
    for i in range(n):
        for j in (i - 1, i + 1):
            if 0 <= j < n:
                dense[i, j] = -1.0
        dense[i, i] = -dense[i].sum()
    jA = j_from_dense(dense)
    kw = dict(max_coarse_size=60)  # no coarsening: the inverse of A itself
    jh = JD.setup_hierarchy_device(jA, **kw)
    th = H.setup_hierarchy_device(to_t(jA), device="cpu", **kw)
    assert len(th.levels) == len(jh.levels) == 0
    assert bool(torch.isfinite(th.coarse_inv).all())
    assert close(th.coarse_inv, jh.coarse_inv, 1e-8)
