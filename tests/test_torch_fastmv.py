"""hypre_tpu_torch's banded (BandedEll) format against hypre_tpu's.

The schedule and payload must equal the reference's ``try_banded`` on the
same float32 matrix. The plain gather and transpose versions are held
against the reference's ``ell_spmv``/``ell_spmv_t`` (the exact product; the
reference's bf16 gather modes are a TPU device choice), at float32
tolerance: the sums run in another order. The transpose reads the schedule
of ``with_transpose_schedule`` (the nonzeros sorted by destination column),
which is checked on its own: a stable permutation of the nonzero slots,
with a chunk table that keeps what the CUDA kernel assumes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from hypre_tpu.seq import fastmv as j_fastmv
from hypre_tpu.seq.ell import EllMatrix as JEll, ell_spmv as j_spmv, \
    ell_spmv_t as j_spmv_t

from hypre_tpu_torch import kernels
from hypre_tpu_torch.convert import ell_from_numpy
from hypre_tpu_torch.problems.laplacian import laplacian_3d_7pt
from hypre_tpu_torch.seq import fastmv
from hypre_tpu_torch.seq.dia import DiaMatrix


def banded_matrix(rng, n, m, k, band):
    """f32 ELL whose row i touches columns near i*m/n (a coarse-level-like
    band), with some padded slots and some empty rows."""
    centre = (np.arange(n) * m // n)[:, None]
    cols = np.clip(centre + rng.integers(-band, band + 1, (n, k)), 0, m - 1)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    pad = rng.random((n, k)) < 0.25
    pad[rng.random(n) < 0.05] = True
    cols = np.where(pad, -1, cols).astype(np.int32)
    vals[pad] = 0
    return vals, cols


@pytest.mark.parametrize("n,m,k,band", [(5000, 5000, 9, 700),
                                        (7000, 2100, 4, 300)])
def test_try_banded_schedule_matches_reference(n, m, k, band):
    rng = np.random.default_rng(n)
    vals, cols = banded_matrix(rng, n, m, k, band)
    jb = j_fastmv.try_banded(JEll(vals=jnp.asarray(vals),
                                  cols=jnp.asarray(cols), n_cols=m))
    tb = fastmv.try_banded(ell_from_numpy(vals, cols, m, device="cpu"))
    assert (tb.W, tb.B, tb.n_xpad) == (jb.W, jb.B, jb.n_xpad)
    assert (tb.n_rows, tb.n_cols) == (jb.n_rows, jb.n_cols)
    assert np.array_equal(tb.starts.numpy(), np.asarray(jb.starts))
    assert np.array_equal(tb.lcols_t.numpy(), np.asarray(jb.lcols_t))
    assert np.array_equal(tb.vals_t.numpy(), np.asarray(jb.vals_t))
    assert tb.vals_t.is_contiguous() and tb.lcols_t.is_contiguous()


def test_plain_banded_versions_match_reference_ell_products():
    rng = np.random.default_rng(7)
    n, m = 6000, 1900
    vals, cols = banded_matrix(rng, n, m, 6, 400)
    jA = JEll(vals=jnp.asarray(vals), cols=jnp.asarray(cols), n_cols=m)
    tb = fastmv.try_banded(ell_from_numpy(vals, cols, m, device="cpu"))
    x = rng.standard_normal(m).astype(np.float32)
    r = rng.standard_normal(n).astype(np.float32)
    tb = fastmv.with_transpose_schedule(tb)
    launches = dict(kernels.LAUNCHES)
    y = tb.drop_ell().mv(torch.from_numpy(x)).numpy()
    yt = tb.drop_ell().mv_t(torch.from_numpy(r)).numpy()
    assert kernels.LAUNCHES == launches  # CPU tensors: plain versions only
    # every output is summed in a fixed order: a second call gives the bits
    assert np.array_equal(yt, tb.mv_t(torch.from_numpy(r)).numpy())
    ref = np.asarray(j_spmv(jA, jnp.asarray(x)))
    ref_t = np.asarray(j_spmv_t(jA, jnp.asarray(r)))
    assert y.shape == (n,) and yt.shape == (m,)
    # float32 sums in another order: a few ulps of the largest term
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(yt - ref_t).max() <= 1e-5 * np.abs(ref_t).max()


def test_optimize_operator_picks_formats():
    rng = np.random.default_rng(8)
    A = laplacian_3d_7pt(8, 8, 8, device="cpu")
    assert isinstance(fastmv.optimize_operator(A, dia_detect="shifts"),
                      DiaMatrix)
    vals, cols = banded_matrix(rng, 70000, 20000, 4, 500)
    P = ell_from_numpy(vals, cols, 20000, device="cpu")
    # on a CPU tensor the kernel format is built only when asked for
    assert fastmv.optimize_operator(P, dia_detect="shifts") is P
    assert isinstance(fastmv.optimize_operator(P, prefer_pallas=True,
                                               dia_detect="shifts"),
                      fastmv.BandedEll)
    small = ell_from_numpy(vals[:100], cols[:100], 20000, device="cpu")
    assert fastmv.optimize_operator(small, prefer_pallas=True,
                                    dia_detect="shifts") is small
    assert fastmv.try_banded(ell_from_numpy(vals.astype(np.float64), cols,
                                            20000, device="cpu")) is None


def test_banded_rejects_wrong_shapes():
    rng = np.random.default_rng(9)
    vals, cols = banded_matrix(rng, 3000, 1000, 4, 200)
    tb = fastmv.try_banded(ell_from_numpy(vals, cols, 1000, device="cpu"))
    with pytest.raises(ValueError):
        tb.mv(torch.zeros(999))
    with pytest.raises(ValueError):
        tb.mv_t(torch.zeros(1000))


def banded_of(vals, cols, m, cap=fastmv.T_CHUNK):
    tb = fastmv.try_banded(ell_from_numpy(vals, cols, m, device="cpu"))
    return fastmv.with_transpose_schedule(tb, cap=cap)


def nonzero_slots(vals, cols):
    """(destination, row, value) of the nonzero slots in (row, slot)
    order."""
    rows, slots = np.nonzero((cols >= 0) & (vals != 0))
    return cols[rows, slots], rows, vals[rows, slots]


def check_chunk_table(tb):
    """What the CUDA kernel takes for granted: the chunks cover every
    column once, and all columns of a chunk but the last fit, with the
    16-byte alignment slack at both ends, into its 2 * cap staging slots."""
    colptr, chunks, cap = tb.t_colptr.numpy(), tb.t_chunks.numpy(), tb.t_cap
    assert chunks[0] == 0 and chunks[-1] == tb.n_cols
    assert (np.diff(chunks) > 0).all() or tb.n_cols == 0
    for c0, c1 in zip(chunks[:-1], chunks[1:]):
        assert c1 - c0 <= cap
        assert colptr[c1 - 1] - colptr[c0] + 6 <= 2 * cap


@pytest.mark.parametrize("n,m,k,band", [(5000, 5000, 9, 700),
                                        (7000, 2100, 4, 300)])
def test_transpose_schedule_is_stable_sort_of_nonzeros(n, m, k, band):
    rng = np.random.default_rng(n + 1)
    vals, cols = banded_matrix(rng, n, m, k, band)
    tb = banded_of(vals, cols, m, cap=256)
    dest, rows, v = nonzero_slots(vals, cols)
    order = np.argsort(dest, kind="stable")
    nnz = dest.shape[0]
    assert int(tb.t_colptr[-1]) == nnz
    assert tb.t_vals.shape[0] == -(-nnz // 4) * 4
    assert tb.t_rows.dtype == torch.int32 and tb.t_colptr.dtype == torch.int32
    assert np.array_equal(tb.t_rows.numpy()[:nnz], rows[order])
    assert np.array_equal(tb.t_vals.numpy()[:nnz], v[order])
    assert not tb.t_vals.numpy()[nnz:].any()
    assert np.array_equal(tb.t_colptr.numpy(),
                          np.concatenate([[0], np.cumsum(
                              np.bincount(dest, minlength=m))]))
    check_chunk_table(tb)
    assert tb.t_chunks.shape[0] - 1 >= nnz // 256


def edge_case(name):
    rng = np.random.default_rng(len(name))
    if name == "dense-column":
        n, m = 3000, 900
        vals, cols = banded_matrix(rng, n, m, 4, 100)
        rows = np.arange(200, 1700)
        cols[rows, 0] = 450  # one column longer than a chunk
        vals[rows, 0] = rng.standard_normal(rows.shape[0]).astype(np.float32)
    elif name == "empty-column":
        n, m = 3000, 900
        vals, cols = banded_matrix(rng, n, m, 4, 100)
        for j in (0, 450, 451, 899):
            vals[cols == j] = 0
            cols[cols == j] = -1
    elif name == "empty-rows":
        n, m = 4096, 1200
        vals, cols = banded_matrix(rng, n, m, 4, 100)
        cols[1000:2100] = -1
        vals[1000:2100] = 0
    elif name == "k=1":
        n, m = 2500, 2500
        vals, cols = banded_matrix(rng, n, m, 1, 50)
    elif name == "ragged-rows":
        n, m = 1025, 300
        vals, cols = banded_matrix(rng, n, m, 3, 40)
    return vals, cols, m


@pytest.mark.parametrize("name", ["dense-column", "empty-column",
                                  "empty-rows", "k=1", "ragged-rows"])
def test_transpose_edge_cases_match_reference(name):
    vals, cols, m = edge_case(name)
    n = vals.shape[0]
    tb = banded_of(vals, cols, m, cap=512)
    check_chunk_table(tb)
    seg = np.diff(tb.t_colptr.numpy())
    if name == "dense-column":
        assert seg.max() > 2 * tb.t_cap
        # the long column closes its chunk
        assert 451 in tb.t_chunks.numpy()
    if name == "empty-column":
        assert not seg[[0, 450, 451, 899]].any()
    r = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    yt = tb.drop_ell().mv_t(torch.from_numpy(r)).numpy()
    jA = JEll(vals=jnp.asarray(vals), cols=jnp.asarray(cols), n_cols=m)
    ref_t = np.asarray(j_spmv_t(jA, jnp.asarray(r)))
    assert yt.shape == (m,)
    # float32 sums in another order
    assert np.abs(yt - ref_t).max() <= 1e-5 * np.abs(ref_t).max()
    assert not yt[seg == 0].any()


def test_transpose_without_schedule_raises():
    rng = np.random.default_rng(10)
    vals, cols = banded_matrix(rng, 3000, 1000, 4, 200)
    tb = fastmv.try_banded(ell_from_numpy(vals, cols, 1000, device="cpu"))
    with pytest.raises(ValueError, match="with_transpose_schedule"):
        tb.mv_t(torch.zeros(3000))
    with pytest.raises(ValueError, match="with_transpose_schedule"):
        fastmv.banded_spmv_t(tb.drop_ell(), torch.zeros(3000))


def test_transpose_schedule_survives_drop_ell_and_to():
    rng = np.random.default_rng(11)
    vals, cols = banded_matrix(rng, 3000, 1000, 4, 200)
    tb = banded_of(vals, cols, 1000)
    moved = tb.drop_ell().to("cpu")
    assert moved.ell is None and moved.t_cap == tb.t_cap
    for name in ("t_vals", "t_rows", "t_colptr", "t_chunks"):
        assert torch.equal(getattr(moved, name), getattr(tb, name))
    r = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
    assert torch.equal(moved.mv_t(r), tb.mv_t(r))


@settings(max_examples=25, deadline=None, derandomize=True)
@given(n=st.integers(1, 2300), m=st.integers(1, 400), k=st.integers(1, 6),
       band=st.integers(0, 60), cap=st.sampled_from([8, 64, 2048]),
       seed=st.integers(0, 2**31 - 1))
def test_transpose_plain_equals_dense_product(n, m, k, band, cap, seed):
    rng = np.random.default_rng(seed)
    vals, cols = banded_matrix(rng, n, m, k, band)
    tb = banded_of(vals, cols, m, cap=cap)
    check_chunk_table(tb)
    r = rng.standard_normal(n).astype(np.float32)
    dense = np.zeros((n, m))
    dest, rows, v = nonzero_slots(vals, cols)
    np.add.at(dense, (rows, dest), v.astype(np.float64))
    ref = dense.T @ r.astype(np.float64)
    yt = tb.mv_t(torch.from_numpy(r)).numpy()
    assert np.abs(yt - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0)
