"""The row-list route of the DIA kernels on the CPU.

``compact_dia`` lists a DiaMatrix's non-empty rows (implicitly, when a
pointer per row costs fewer bytes) with their nonzeros in ascending plane
order, and ``dia_rows_plain`` sums each listed row in that order and
writes a zero in every other row. The same seeded planes go through the
reference's ``hypre_tpu.seq.dia.DiaMatrix.mv`` (its jnp loop, float64, the
CPU path of ``_dia_kernel``) and the port's dense plain versions: the row
list must match the reference to 1e-12 and the dense plain versions bit for
bit, with the offsets as the device table and as the static tuple, on
U-like (two planes at +-n, a few
hundred listed rows), P-like (every row listed), P^T-like (~6 % listed)
and empty layouts. Then the compaction rule, on synthetic rows, on a
device setup and on a semi-structured U. (The solve ``optimize_hierarchy``
sets up with it is held against the reference's in
``test_torch_transfer_dia.py``.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from hypre_tpu.seq import dia as j_dia

import hypre_tpu_torch as H
from hypre_tpu_torch import kernels
from hypre_tpu_torch.seq import dia
from torch_one_thread import one_torch_thread  # noqa: F401


SETUP = dict(max_coarse_size=60, relax="chebyshev", agg_num_levels=1,
             coarse_drop_tol=0.02, transfer_dia=True)


def sparse_planes(rng, D, n, density, reach):
    """(D, n) planes with about ``density`` nonzeros and D distinct sorted
    offsets in [-reach, reach], both ends included."""
    inner = rng.choice(np.arange(-reach + 1, reach), D - 2, replace=False)
    offs = tuple(sorted(int(o) for o in inner) + [reach])
    offs = (-reach,) + offs
    dv = np.where(rng.random((D, n)) < density,
                  rng.standard_normal((D, n)), 0.0)
    return dv, offs


def layout_rows(C):
    """Per listed row, the (plane id or column, value) pairs of the layout,
    in order."""
    ptr = C.r_ptr.tolist()
    ids, vals = C.r_ids.tolist(), C.r_vals.tolist()
    return [list(zip(ids[a:b], vals[a:b])) for a, b in zip(ptr, ptr[1:])]


def layout(C):
    """The positional arguments of dia_rows / dia_rows_plain up to the
    offsets."""
    return C.r_ptr, C.r_ids, C.r_vals


def rows_plain(C, offsets, x):
    return dia.dia_rows_plain(*layout(C), offsets, x, C.n_rows, C.n_cols,
                              C.r_rows)


def test_row_list_matches_reference_and_dense_plain_versions():
    rng = np.random.default_rng(0)
    D, n = 64, 5003
    dv, offs = sparse_planes(rng, D, n, 0.02, 1023)
    M = dia.DiaMatrix(dvals=torch.from_numpy(dv), offsets=offs, n_cols=n)
    assert M.margin == 1024  # offsets reach +-(margin - 1)
    C = dia.compact_dia(M)
    # ~73 % of the rows hold an entry: a pointer per row is the smaller
    # layout, so every row is listed
    assert C.r_ptr is not None and C.r_lanes == 1 and C.r_rows is None
    assert C.r_mask is None and C.r_ptr.shape == (n + 1,)
    assert C.r_ptr.dtype == torch.int32 and C.r_ids.dtype == torch.uint8
    assert torch.equal(C.dvals, M.dvals)  # the planes stay
    # the layout holds exactly the nonzeros, planes ascending in each row
    rows = layout_rows(C)
    for i in (0, 1, 2, n // 2, n - 1):
        assert rows[i] == [(d, dv[d, i]) for d in range(D) if dv[d, i] != 0]
    assert C.r_vals.numel() == int((dv != 0).sum())

    x = rng.standard_normal(n)
    xt = torch.from_numpy(x)
    ref = np.asarray(j_dia.DiaMatrix(dvals=jnp.asarray(dv), offsets=offs,
                                     n_cols=n).mv(jnp.asarray(x)))
    got = rows_plain(C, C.offsets, xt)
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    for dtype in (torch.float64, torch.float32):
        Md = dia.DiaMatrix(dvals=M.dvals.to(dtype), offsets=offs, n_cols=n)
        Cd = dia.compact_dia(Md)
        xd = xt.to(dtype)
        launches = dict(kernels.LAUNCHES)
        dyn = dia.dia_rows(*layout(Cd), Cd.offsets, xd, n, n, Cd.r_rows,
                           Cd.r_mask, Cd.r_lanes)
        # kernel 2's case: the static offsets go through the same entry
        st_ = dia.dia_rows(*layout(Cd), offs, xd, n, n, Cd.r_rows,
                           Cd.r_mask, Cd.r_lanes)
        assert kernels.LAUNCHES == launches  # CPU tensors: plain versions
        assert torch.equal(dyn, dia.dia_spmv_plain(Md.dvals, Md.offsets, xd,
                                                   Md.margin))
        assert torch.equal(st_, dia.dia_spmv_static_plain(Md.dvals, offs,
                                                          xd))
        # on the CPU mv keeps the dense plain version
        assert torch.equal(Cd.mv(xd), dyn)
    # .to() carries the layout
    moved = C.to("cpu")
    for f in ("r_ptr", "r_ids", "r_vals"):
        assert torch.equal(getattr(moved, f), getattr(C, f))


def u_like(rng, n, listed):
    """Two planes at +-n/2 (a coupling between two halves of a flat
    space), ``listed`` rows holding one or two nonzeros."""
    half = n // 2
    dv = np.zeros((2, n))
    rows = np.sort(rng.choice(np.arange(half - 200, half + 200), listed,
                              replace=False))
    lower = rows >= half
    dv[0, rows[lower]] = rng.standard_normal(lower.sum())
    dv[1, rows[~lower]] = rng.standard_normal((~lower).sum())
    both = rows[::7]
    dv[0, both[both >= half]] = 0.5
    dv[1, both[both < half]] = -0.5
    return dv, (-half, half)


def p_like(rng, n):
    """Every row holds 1-4 entries of 64 planes (P's shape)."""
    dv = np.zeros((64, n))
    for i in range(n):
        dv[rng.choice(64, rng.integers(1, 5), replace=False), i] = \
            rng.standard_normal()
    return dv, tuple(range(-40, 24))


def pt_like(rng, n):
    """~6 % of the rows hold ~25 entries each of 64 planes (P^T's)."""
    dv = np.zeros((64, n))
    for i in rng.choice(n, n // 16, replace=False):
        dv[rng.choice(64, rng.integers(20, 31), replace=False), i] = \
            rng.standard_normal()
    return dv, tuple(range(-32, 32))


@pytest.mark.parametrize("shape", ["U", "P", "Pt", "empty"])
def test_layouts_match_reference_and_dense_plain_versions(shape):
    rng = np.random.default_rng(len(shape))
    n = 4099
    if shape == "U":
        dv, offs = u_like(rng, n, 300)
    elif shape == "P":
        dv, offs = p_like(rng, n)
    elif shape == "Pt":
        dv, offs = pt_like(rng, n)
    else:
        dv, offs = np.zeros((3, n)), (-5, 0, 5)
    M = dia.DiaMatrix(dvals=torch.from_numpy(dv), offsets=offs, n_cols=n)
    old = dia.ROWS_MAX_SHARE
    dia.ROWS_MAX_SHARE = float("inf")  # P's layout is not the smaller one
    try:
        C = dia.compact_dia(M)
    finally:
        dia.ROWS_MAX_SHARE = old
    non_empty = np.nonzero((dv != 0).any(0))[0]
    if shape == "P":
        assert C.r_rows is None and C.r_mask is None and C.r_lanes == 1
    else:
        assert np.array_equal(C.r_rows.numpy(), non_empty)
        assert C.r_ptr.shape == (len(non_empty) + 1,)
        bits = ((C.r_mask.long()[:, None] >> torch.arange(32)) & 1)
        assert np.array_equal(np.nonzero(bits.reshape(-1).numpy())[0],
                              non_empty)
        assert C.r_lanes == (4 if shape == "Pt" else 1)
    assert C.r_ids.dtype == torch.uint8
    x = rng.standard_normal(n)
    xt = torch.from_numpy(x)
    ref = np.asarray(j_dia.DiaMatrix(dvals=jnp.asarray(dv), offsets=offs,
                                     n_cols=n).mv(jnp.asarray(x)))
    for offsets in (C.offsets, offs):
        got = dia.dia_rows(*layout(C), offsets, xt, n, n, C.r_rows, C.r_mask,
                           C.r_lanes)
        assert np.abs(got.numpy() - ref).max() <= \
            1e-12 * max(np.abs(ref).max(), 1.0)
        assert torch.equal(got, dia.dia_spmv_plain(M.dvals, M.offsets, xt,
                                                   M.margin))
        assert torch.equal(got, dia.dia_spmv_static_plain(M.dvals, offs, xt))
    if shape == "U":
        # the layout's bytes against the planes' (the compaction rule)
        assert dia.row_list_bytes(C.r_vals.numel(), n, C.r_rows.numel(),
                                  8) < 0.25 * M.dvals.numel() * 8


@st.composite
def row_cases(draw):
    n = draw(st.integers(1, 150).filter(lambda v: v % 32 != 0))
    D = draw(st.integers(1, 12))
    reach = 1023  # the margin of these sizes is 1024
    offs = sorted(draw(st.lists(st.integers(-reach, reach), min_size=D,
                                max_size=D, unique=True)))
    if D >= 2:
        offs[0], offs[-1] = -reach, reach
    seed = draw(st.integers(0, 2**31))
    rng = np.random.default_rng(seed)
    mask = rng.random((D, n)) < draw(st.sampled_from([0.0, 0.1, 0.5, 1.0]))
    dv = np.where(mask, rng.standard_normal((D, n)), 0.0)
    # explicit zero values, both signs, stay out of the layout
    dv[rng.random((D, n)) < 0.05] = 0.0
    dv[rng.random((D, n)) < 0.05] = -0.0
    empty = draw(st.integers(0, n - 1))
    dv[:, empty] = 0.0  # an empty row
    zero_plane = None
    if n > 1 and draw(st.booleans()):
        full = draw(st.integers(0, n - 1).filter(lambda i: i != empty))
        dv[:, full] = rng.uniform(1, 2, D)  # a full row
    else:
        zero_plane = draw(st.integers(0, D - 1))
        dv[zero_plane] = 0.0
    return dv, tuple(offs), zero_plane, rng.standard_normal(n)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(case=row_cases())
def test_row_list_property(case):
    dv, offs, zero_plane, x = case
    D, n = dv.shape
    M = dia.DiaMatrix(dvals=torch.from_numpy(dv), offsets=offs, n_cols=n)
    old = dia.ROWS_MAX_SHARE
    dia.ROWS_MAX_SHARE = float("inf")  # the layout whatever the density
    try:
        C = dia.compact_dia(M)
    finally:
        dia.ROWS_MAX_SHARE = old
    counts = (dv != 0).sum(axis=0)
    listed = np.nonzero(counts)[0]
    if C.r_rows is None:
        slots = np.arange(n)
        assert C.r_mask is None
    else:
        slots = listed
        assert np.array_equal(C.r_rows.numpy(), listed)
    assert C.r_ptr.shape == (len(slots) + 1,) and int(C.r_ptr[0]) == 0
    assert bool((C.r_ptr[1:] >= C.r_ptr[:-1]).all())
    assert bool((C.r_vals != 0).all())
    assert np.array_equal((C.r_ptr[1:] - C.r_ptr[:-1]).numpy(), counts[slots])
    if zero_plane is None:
        assert counts.max() == D  # the full row
    else:
        assert not bool((C.r_ids == zero_plane).any())
    if C.r_lanes > 1:
        assert C.r_lanes == dia.ROW_LANES[-1]
        assert counts.sum() > dia.ROWS_PER_LANE * len(slots)
    else:
        assert counts.sum() <= dia.ROWS_PER_LANE * max(len(slots), 1)
    xt = torch.from_numpy(x)
    y = rows_plain(C, C.offsets, xt)
    assert torch.equal(y, dia.dia_spmv_plain(M.dvals, M.offsets, xt,
                                             M.margin))
    assert torch.equal(rows_plain(C, offs, xt),
                       dia.dia_spmv_static_plain(M.dvals, offs, xt))
    assert not bool(y[torch.from_numpy(counts == 0)].any())


@pytest.mark.parametrize("lens, lanes", [
    ((1, 4), 1),      # P-like rows: one thread a row
    ((12, 12), 1),    # a mean of ROWS_PER_LANE still takes one thread
    ((10, 43), 4),    # P^T-like rows: a lane group a listed row
    ((60, 64), 4),    # longer rows keep the 4 lanes
])
def test_lanes_follow_the_mean_length_of_the_non_empty_rows(lens, lanes):
    rng = np.random.default_rng(lens[0])
    D, n = 64, 3001
    dv = np.zeros((D, n))
    rows = np.sort(rng.choice(n, n // 10, replace=False))
    count = rng.integers(lens[0], lens[1] + 1, rows.shape[0])
    rank = rng.random((rows.shape[0], D)).argsort(1).argsort(1)
    dv[:, rows] = np.where(rank < count[:, None],
                           rng.uniform(1, 2, rank.shape), 0.0).T
    M = dia.DiaMatrix(dvals=torch.from_numpy(dv),
                      offsets=tuple(range(-32, 32)), n_cols=n)
    old = dia.ROWS_MAX_SHARE
    dia.ROWS_MAX_SHARE = float("inf")  # the layout whatever the density
    try:
        C = dia.compact_dia(M)
    finally:
        dia.ROWS_MAX_SHARE = old
    assert C.r_lanes == lanes
    # a tenth of the rows listed: the list is the smaller layout
    assert np.array_equal(C.r_rows.numpy(), rows)


def test_more_than_255_diagonals_raise():
    M = dia.DiaMatrix(dvals=torch.zeros(256, 300), offsets=tuple(range(256)),
                      n_cols=300)
    with pytest.raises(ValueError, match="255"):
        dia.compact_dia(M)


@pytest.fixture(scope="module")
def hier16():
    """The port's device setup of the 16^3 7-pt Laplacian with the stencil
    level's interpolation as a TransferDia (D = 64)."""
    A = H.laplacian_3d_7pt(16, 16, 16, dtype=torch.float64, device="cpu")
    return A, H.setup_hierarchy_device(A, device="cpu", **SETUP)


def test_compaction_rule_keeps_the_stencil_dense_and_compacts_transfers(
        hier16):
    A, hier = hier16
    A7 = dia.try_dia(A)
    assert A7.D == 7 and dia.compact_dia(A7) is A7  # every slot a nonzero
    for spec in (False, True):
        fast = H.optimize_hierarchy(hier, specialize=spec, device="cpu")
        lev = fast.levels[0]
        assert isinstance(lev.A, H.DiaMatrix) and lev.A.r_ptr is None
        T = lev.P
        assert isinstance(T, H.TransferDia) and T.P_dia.D == 64
        for M in (T.P_dia, T.Pt_dia):
            assert M.r_ptr is not None
            n_list = M.n_rows if M.r_rows is None else M.r_rows.numel()
            assert dia.row_list_bytes(M.r_vals.numel(), M.n_rows, n_list,
                                      8) <= \
                dia.ROWS_MAX_SHARE * M.dvals.numel() * 8
            assert (M.offsets_static is not None) == spec
        # P: a few entries in every row, listed implicitly; P^T: long rows
        # on the C points, listed
        assert T.P_dia.r_lanes == 1 and T.P_dia.r_rows is None
        assert T.Pt_dia.r_lanes > 1
        assert T.Pt_dia.r_rows.numel() == hier.n_level_true[1]


def test_compaction_rule_compacts_a_semi_structured_u():
    from hypre_tpu_torch.drivers import sstruct

    case = sstruct.prepare("-solver 11 -n 64".split(), device="cpu",
                           dtype=torch.float64)
    A = case.A
    U = A.U_op
    assert isinstance(U, H.DiaMatrix) and U.D == 2
    assert U.r_ptr is not None and U.r_lanes == 1
    nnz = int((U.dvals != 0).sum())
    assert U.r_vals.numel() == nnz and U.r_rows.numel() <= nnz
    assert dia.row_list_bytes(nnz, U.n_rows, U.r_rows.numel(), 8) <= \
        dia.ROWS_MAX_SHARE * U.dvals.numel() * 8
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(U.n_cols))
    assert torch.equal(rows_plain(U, U.offsets, x),
                       dia.dia_spmv_plain(U.dvals, U.offsets, x, U.margin))
