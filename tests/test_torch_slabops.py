"""hypre_tpu_torch.seq.slabops against hypre_tpu.seq.slabops.

The same numpy arrays, made from a seed, go through the JAX function (on
the CPU in float64; none of these reaches a Pallas kernel) and through the
port with CPU tensors. Integer results and sparsity patterns must be equal
exactly; float64 values to 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from hypre_tpu.seq import slabops as J

from hypre_tpu_torch.seq import slabops as T
from torch_one_thread import one_torch_thread  # noqa: F401


RTOL = 1e-12


def make_slab(seed, n=23, K=17, ncols=9, pad=0.3, dtype=np.float64):
    """A candidate slab with duplicate columns and padding slots."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, ncols, (n, K)).astype(np.int32)
    vals = rng.standard_normal((n, K)).astype(dtype)
    hole = rng.random((n, K)) < pad
    cols[hole] = -1
    vals[hole] = 0
    return cols, vals


def tt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max(initial=0.0) <= RTOL * max(
        np.abs(ref).max(initial=0.0), 1e-300)


def dense_rows(cols, vals, ncols):
    d = np.zeros((cols.shape[0], ncols))
    for i in range(cols.shape[0]):
        for c, v in zip(cols[i], vals[i]):
            if c >= 0:
                d[i, c] += v
    return d


@pytest.mark.parametrize("num_keys", [1, 2])
def test_sort_slab_matches_reference(num_keys):
    rng = np.random.default_rng(3)
    k1 = rng.integers(0, 4, (11, 13)).astype(np.int32)
    k2 = rng.integers(0, 3, (11, 13)).astype(np.int32)
    v = rng.standard_normal((11, 13))
    ref = J.sort_slab(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(v),
                      num_keys=num_keys)
    got = T.sort_slab(tt(k1), tt(k2), tt(v), num_keys=num_keys)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_sort_slab_float_key_with_integer_tie_break():
    mag = np.array([[1.0, 2.0, 2.0, -0.0, 0.0, 2.0]])
    tie = np.array([[5, 4, 1, 9, 3, 2]], np.int32)
    ref = J.sort_slab(jnp.asarray(-mag), jnp.asarray(tie), num_keys=2)
    got = T.sort_slab(tt(-mag), tt(tie), num_keys=2)
    assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[1].tolist() == [[1, 2, 4, 5, 3, 9]]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_seg_total_sorted_adds_in_the_reference_order(dtype):
    """Bit-equal totals: truncation ranks compare them for equality."""
    cols, vals = make_slab(7, n=40, K=33, ncols=5, dtype=dtype)
    key = np.where(cols >= 0, cols, 2**30).astype(np.int32)
    order = np.argsort(key, axis=1, kind="stable")
    key_s = np.take_along_axis(key, order, 1)
    val_s = np.take_along_axis(vals, order, 1)
    ref = np.asarray(J.seg_total_sorted(jnp.asarray(key_s),
                                        jnp.asarray(val_s)))
    got = T.seg_total_sorted(tt(key_s), tt(val_s)).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(max_elmts=3),
    dict(trunc_factor=0.3),
    dict(max_elmts=4, rescale_rowsum=True),
    dict(max_elmts=2, trunc_factor=0.2, rescale_rowsum=True),
], ids=["plain", "max_elmts", "trunc_factor", "rescale", "all"])
def test_merge_slab_matches_reference(kw):
    cols, vals = make_slab(11)
    rc, rv, rreq = J.merge_slab(jnp.asarray(cols), jnp.asarray(vals), 12,
                                **kw)
    gc, gv, greq = T.merge_slab(tt(cols), tt(vals), 12, **kw)
    assert np.array_equal(gc.numpy(), np.asarray(rc))
    assert close(gv.numpy(), rv)
    assert int(greq) == int(rreq)


def test_merge_slab_reports_required_k_above_out_k():
    cols, vals = make_slab(12, K=30, ncols=20, pad=0.05)
    rc, rv, rreq = J.merge_slab(jnp.asarray(cols), jnp.asarray(vals), 6)
    gc, gv, greq = T.merge_slab(tt(cols), tt(vals), 6)
    assert int(greq) == int(rreq) > 6
    assert np.array_equal(gc.numpy(), np.asarray(rc))
    assert close(gv.numpy(), rv)


def test_merge_slab_equal_magnitudes_tie_break_by_column():
    """Built on purpose: every unique column of a row sums to +-1/4, as on
    a Laplacian, in several slot orders; max_elmts=2 must keep the two
    smallest columns, as the reference does."""
    cols = np.array([[7, 3, 5, 3, 9, 7, -1, 5],
                     [9, 9, 2, 2, 4, 4, 6, 6],
                     [1, 8, 8, 1, 6, -1, 6, -1]], np.int32)
    vals = np.array([[.125, .125, -.25, .125, .25, .125, 0, 0],
                     [.125, .125, -.125, -.125, .25, 0, .125, .125],
                     [.25, .125, .125, 0, -.125, 0, -.125, 0]])
    rc, rv, _ = J.merge_slab(jnp.asarray(cols), jnp.asarray(vals), 8,
                             max_elmts=2)
    gc, gv, _ = T.merge_slab(tt(cols), tt(vals), 8, max_elmts=2)
    assert np.array_equal(gc.numpy(), np.asarray(rc))
    assert np.array_equal(gv.numpy(), np.asarray(rv))
    assert gc.tolist() == [[3, 5], [2, 4], [1, 6]]


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(1, 6), K=st.integers(1, 12),
       ncols=st.integers(1, 7))
def test_merge_slab_equals_dense_rowwise_merge(seed, n, K, ncols):
    cols, vals = make_slab(seed, n=n, K=K, ncols=ncols)
    gc, gv, greq = T.merge_slab(tt(cols), tt(vals), K)
    gc, gv = gc.numpy(), gv.numpy()
    assert np.allclose(dense_rows(gc, gv, ncols),
                       dense_rows(cols, vals, ncols), rtol=1e-12, atol=1e-14)
    uniq = [len(set(c for c in row if c >= 0)) for row in cols]
    assert int(greq) == max(uniq)
    for i, row in enumerate(gc):
        live = row[row >= 0]
        assert len(live) == uniq[i] and np.all(np.diff(live) > 0)
        assert np.all(row[len(live):] == -1)


@pytest.mark.parametrize("kw", [
    dict(), dict(lump_largest=True), dict(rescale_rowsum=True),
], ids=["plain", "lump_largest", "rescale"])
def test_cap_slab_matches_reference(kw):
    # unique columns per row, as cap_slab's callers give it
    rng = np.random.default_rng(21)
    cols = np.stack([rng.permutation(40)[:14] for _ in range(19)]) \
        .astype(np.int32)
    vals = rng.standard_normal(cols.shape)
    vals[:, 3] = vals[:, 5]  # equal magnitudes: the column breaks the tie
    cols[rng.random(cols.shape) < 0.2] = -1
    ref = J.cap_slab(jnp.asarray(cols), jnp.asarray(vals), 5, **kw)
    got = T.cap_slab(tt(cols), tt(vals), 5, **kw)
    assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert close(got[1].numpy(), ref[1])


def test_cap_slab_extra_and_tie_cols():
    rng = np.random.default_rng(22)
    cols = np.stack([rng.permutation(30)[:10] for _ in range(12)]) \
        .astype(np.int32)
    vals = np.round(rng.standard_normal(cols.shape), 1)  # many ties
    extra = rng.standard_normal(cols.shape)
    tie = (1000 - cols).astype(np.int32)  # reversed ids
    ref = J.cap_slab(jnp.asarray(cols), jnp.asarray(vals), 4,
                     extra=(jnp.asarray(extra),), tie_cols=jnp.asarray(tie))
    got = T.cap_slab(tt(cols), tt(vals), 4, extra=(tt(extra),),
                     tie_cols=tt(tie))
    assert len(got) == len(ref) == 3
    assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        assert close(g.numpy(), r)
    # kcap >= K returns the operands unchanged
    same = T.cap_slab(tt(cols), tt(vals), 10, extra=(tt(extra),))
    assert len(same) == 3 and np.array_equal(same[0].numpy(), cols)


def test_compact_mask_slab_matches_reference():
    cols, vals = make_slab(31)
    keep = np.random.default_rng(32).random(cols.shape) < 0.6
    rc, rv = J.compact_mask_slab(jnp.asarray(cols), jnp.asarray(vals),
                                 jnp.asarray(keep), 9)
    gc, gv = T.compact_mask_slab(tt(cols), tt(vals), tt(keep), 9)
    assert np.array_equal(gc.numpy(), np.asarray(rc))
    assert np.array_equal(gv.numpy(), np.asarray(rv))


SHIFT_SETS = {
    "5pt": ((0, -1, 1, -12, 12), 132),
    "7pt": ((0, -1, 1, -7, 7, -42, 42), 210),
    "one-sided": ((0, 1, 5), 40),
}


@pytest.mark.parametrize("name", list(SHIFT_SETS))
def test_make_stencil_pack_matches_reference(name):
    shifts, n = SHIFT_SETS[name]
    ref = J.make_stencil_pack(shifts, n, with_d2=True)
    got = T.make_stencil_pack(shifts, n, with_d2=True)
    assert got.offs == tuple(int(o) for o in np.asarray(ref.offs))
    assert got.k == ref.k
    assert got.margin == ref.margin
    assert got.pair_idx == ref.pair_idx
    assert got.d2 == ref.d2
    assert T.make_stencil_pack(shifts, n).d2 is None
    sub = got.slice(1, 3)
    assert sub.offs == got.offs[1:3] and sub.margin == got.margin


@pytest.mark.parametrize("name", list(SHIFT_SETS))
def test_shift_gathers_and_scatters_match_reference(name):
    shifts, n = SHIFT_SETS[name]
    rng = np.random.default_rng(41)
    jp = J.make_stencil_pack(shifts, n)
    tp = T.make_stencil_pack(shifts, n)
    x1 = rng.standard_normal(n)
    x2 = rng.standard_normal((n, 3))
    xi = rng.integers(0, 50, (n, 2)).astype(np.int32)
    for x, fill, flat in ((x1, 0, False), (x2, 0, False), (x2, 0, True),
                          (xi, -1, True), (xi, -1, False)):
        ref = J.shift_gather_dyn(jnp.asarray(x), jp, fill=fill, flat=flat)
        got = T.shift_gather_dyn(tt(x), tp, fill=fill, flat=flat)
        assert np.array_equal(got.numpy(), np.asarray(ref))
        ref = J.shift_gather_rows(jnp.asarray(x), shifts, fill=fill,
                                  flat=flat)
        got = T.shift_gather_rows(tt(x), shifts, fill=fill, flat=flat)
        assert np.array_equal(got.numpy(), np.asarray(ref))
    contrib = rng.standard_normal((n, len(shifts)))
    ref = J.shift_scatter_add_dyn(jnp.asarray(contrib), jp)
    got = T.shift_scatter_add_dyn(tt(contrib), tp)
    assert np.array_equal(got.numpy(), np.asarray(ref))  # same add order
    counts = (rng.random((n, len(shifts))) < 0.5).astype(np.int32)
    assert np.array_equal(
        T.shift_scatter_add_dyn(tt(counts), tp).numpy(),
        np.asarray(J.shift_scatter_add_dyn(jnp.asarray(counts), jp)))
    pos = np.abs(contrib)
    ref = J.shift_scatter_max_dyn(jnp.asarray(pos), jp, fill=0.0)
    got = T.shift_scatter_max_dyn(tt(pos), tp, fill=0.0)
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_detect_shifts_and_row_gather():
    from hypre_tpu.problems.laplacian import laplacian_3d_7pt

    A = laplacian_3d_7pt(5, 4, 3)
    cols = np.asarray(A.cols)
    ref = J.detect_shifts(cols)
    got = T.detect_shifts(cols)
    assert np.array_equal(got, ref) and tuple(got) == tuple(A.shifts)
    broken = cols.copy()
    broken[7, 1] = broken[7, 1] + 1 if broken[7, 1] >= 0 else 3
    assert T.detect_shifts(broken) is None and J.detect_shifts(broken) is None
    assert T.detect_shifts(np.zeros((0, 3), np.int32)) is None
    x = np.random.default_rng(5).standard_normal((cols.shape[0], 2))
    for shifts in (None, tuple(int(s) for s in got)):
        ref = J.make_row_gather(shifts)(jnp.asarray(x),
                                        jnp.asarray(np.maximum(cols, 0)))
        out = T.make_row_gather(shifts)(tt(x), tt(np.maximum(cols, 0)))
        valid = cols >= 0
        assert np.array_equal(out.numpy()[valid], np.asarray(ref)[valid])
