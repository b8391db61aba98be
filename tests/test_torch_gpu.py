"""Card-only tests of hypre_tpu_torch: each hand-written CUDA kernel
against its plain PyTorch version, and the card against the CPU.

This file imports neither JAX nor hypre_tpu, so it also runs where only
the port is installed; there, skip the JAX-based conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Without a card every test skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

import hypre_tpu_torch as H
from hypre_tpu_torch import kernels
from hypre_tpu_torch.convert import ell_from_numpy
from hypre_tpu_torch.problems.laplacian import laplacian_3d_7pt
from hypre_tpu_torch.seq import dia, fastmv

SETUP = dict(setup_backend="jax", coarsen="pmis", interp="ext+i",
             p_max_elmts=4, relax="chebyshev", max_coarse_size=64)


def close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max(initial=0.0) <= rtol * max(np.abs(b).max(), 1e-300)


def banded_matrix(rng, n, m, k, band):
    centre = (np.arange(n) * m // n)[:, None]
    cols = np.clip(centre + rng.integers(-band, band + 1, (n, k)), 0, m - 1)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    pad = rng.random((n, k)) < 0.25
    cols = np.where(pad, -1, cols).astype(np.int32)
    vals[pad] = 0
    return vals, cols


@pytest.mark.gpu
def test_dia_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(6)
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        A = laplacian_3d_7pt(20, 21, 22, dtype=dtype, device="cuda")
        D = dia.try_dia(A)
        x = torch.from_numpy(rng.standard_normal(A.n_rows)).to("cuda", dtype)
        offs = tuple(D.offsets.tolist())
        ref = dia.dia_spmv_plain(D.dvals, D.offsets, x, D.margin)
        before = dict(kernels.LAUNCHES)
        y_dyn = dia.dia_spmv(D.dvals, D.offsets, x, D.n_cols, D.margin)
        y_st = dia.dia_spmv_static(D.dvals, offs, x, D.n_cols)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["dia_spmv"] == before["dia_spmv"] + 1
        assert kernels.LAUNCHES["dia_spmv_static"] == \
            before["dia_spmv_static"] + 1
        for y in (y_dyn, y_st):
            assert close(y.cpu(), ref.cpu(), tol)


@pytest.mark.gpu
def test_banded_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(10)
    vals, cols = banded_matrix(rng, 50000, 16000, 12, 900)
    tb = fastmv.try_banded(ell_from_numpy(vals, cols, 16000, device="cuda"))
    x = torch.from_numpy(rng.standard_normal(16000).astype(np.float32)).cuda()
    r = torch.from_numpy(rng.standard_normal(50000).astype(np.float32)).cuda()
    y = fastmv.banded_spmv(tb, x)
    ref = fastmv.banded_spmv_plain(tb.vals_t, tb.lcols_t, tb.starts, x,
                                   tb.n_rows, tb.B)
    assert torch.equal(y, ref)  # same order, no fused multiply-add
    with pytest.raises(ValueError, match="with_transpose_schedule"):
        fastmv.banded_spmv_t(tb, r)  # never a silent build, never atomics
    tb = fastmv.with_transpose_schedule(tb)
    before = kernels.LAUNCHES["banded_spmv_t"]
    yt = fastmv.banded_spmv_t(tb, r)
    yt2 = fastmv.banded_spmv_t(tb, r)
    assert kernels.LAUNCHES["banded_spmv_t"] == before + 2
    ref_t = fastmv.banded_spmv_t_plain(tb.t_vals, tb.t_rows, tb.t_colptr, r)
    # both sum every segment in a fixed order, but not in the same one: a
    # few float32 roundings apart
    assert float((yt - ref_t).abs().max()) <= 1e-6 * float(ref_t.abs().max())
    assert torch.equal(yt, yt2)  # fixed order: the same bits every run
    # the schedule is the same on the card and on the CPU
    on_cpu = fastmv.with_transpose_schedule(fastmv.try_banded(
        ell_from_numpy(vals, cols, 16000, device="cpu")))
    for name in ("t_vals", "t_rows", "t_colptr", "t_chunks"):
        assert torch.equal(getattr(tb, name).cpu(), getattr(on_cpu, name))
    with pytest.raises(ValueError):
        fastmv.banded_spmv(tb, x.double())


@pytest.mark.gpu
@pytest.mark.parametrize("cap,k,m,long_col", [
    (2048, 4, 16000, None),   # segments of ~9: one thread per column
    (2048, 40, 3000, None),   # segments of ~400: 16 lanes per column
    (512, 40, 300, None),     # segments of ~4000, longer than a chunk
    (2048, 4, 16000, 30000),  # one dense column: the block-wide sum
    (8, 3, 50000, None),      # the smallest chunks
])
def test_transpose_kernel_segment_paths_on_card(cap, k, m, long_col):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(cap + k)
    n = 50000
    vals, cols = banded_matrix(rng, n, m, k, max(m // 20, 4))
    if long_col:
        rows = rng.choice(n, long_col, replace=False)
        cols[rows, 0] = m // 2
        vals[rows, 0] = rng.standard_normal(long_col).astype(np.float32)
    tb = fastmv.with_transpose_schedule(
        fastmv.try_banded(ell_from_numpy(vals, cols, m, device="cuda"),
                          max_window=1 << 30), cap=cap)
    r = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    yt, yt2 = fastmv.banded_spmv_t(tb, r), fastmv.banded_spmv_t(tb, r)
    torch.cuda.synchronize()
    assert torch.equal(yt, yt2)
    # against float64: the plain version adds long segments left to right
    # in float32 and is the less exact of the two there
    prod = tb.t_vals.double() * r.double()[tb.t_rows.long()]
    ref = torch.zeros(m, dtype=torch.float64, device="cuda").index_add_(
        0, torch.repeat_interleave(
            torch.arange(m, device="cuda"),
            (tb.t_colptr[1:] - tb.t_colptr[:-1]).long()),
        prod[:int(tb.t_colptr[-1])])
    assert float((yt.double() - ref).abs().max()) <= \
        2e-6 * float(ref.abs().max())


@pytest.mark.gpu
def test_card_and_cpu_build_the_same_hierarchy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sizes, iters = {}, {}
    for device in ("cuda", "cpu"):
        A = H.laplacian_3d_7pt(20, 20, 20, dtype=torch.float64, device=device)
        hier = H.setup_hierarchy(A, device=device, **SETUP)
        fast = H.optimize_hierarchy(hier, device=device)
        sm = H.make_smoother("chebyshev", 1.0, 2, 0.3)
        _, info = H.pcg(fast.levels[0].A.mv,
                        torch.ones(A.n_rows, dtype=torch.float64),
                        M=lambda r: H.amg_cycle(fast, r, smoother=sm),
                        rtol=1e-8, device=device)
        sizes[device] = [lv.A.n_rows for lv in hier.levels]
        iters[device] = int(info.iterations)
    assert sizes["cuda"] == sizes["cpu"]
    assert iters["cuda"] == iters["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [56, 64, 80, 96])
def test_static_dia_kernel_on_the_transfer_ladder_on_card(D):
    """The static kernel's instantiations above try_dia's 48: the widths a
    TransferDia pads its diagonal count to. Same order of rounded
    operations as the plain version, so the results are bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(D)
    n = 60000
    offs = tuple(sorted(int(o) for o in
                        rng.choice(np.arange(-3000, 3000), D, replace=False)))
    for dtype in (torch.float32, torch.float64):
        dvals = torch.from_numpy(rng.standard_normal((D, n))).to("cuda", dtype)
        x = torch.from_numpy(rng.standard_normal(n)).to("cuda", dtype)
        before = kernels.LAUNCHES["dia_spmv_static"]
        y = dia.dia_spmv_static(dvals, offs, x, n)
        assert kernels.LAUNCHES["dia_spmv_static"] == before + 1
        assert torch.equal(y, dia.dia_spmv_static_plain(dvals, offs, x))
        offs_t = torch.tensor(offs, dtype=torch.int32, device="cuda")
        y_dyn = dia.dia_spmv(dvals, offs_t, x, n, 4096)
        assert torch.equal(y_dyn, y)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [49, 57, 97])
def test_static_dia_kernel_raises_off_the_ladder_on_card(D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dvals = torch.zeros((D, 128), device="cuda")
    x = torch.zeros(128, device="cuda")
    before = kernels.LAUNCHES["dia_spmv_static"]
    with pytest.raises(ValueError, match="static DIA kernel"):
        dia.dia_spmv_static(dvals, tuple(range(D)), x, 128)
    assert kernels.LAUNCHES["dia_spmv_static"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8192, 2048])
def test_selection_kernels_match_plain_on_card(B):
    """Kernel 3 on the k = 1 selections of a TransferDia: the expansion of
    a coarse vector to the C-point rows (blocks of 8192) and its inverse
    (blocks of 2048)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hypre_tpu_torch.seq.transfer_dia import build_transfer_dia

    rng = np.random.default_rng(B)
    n, nc = 70000, 9000
    c_rows = np.sort(rng.choice(n, nc, replace=False))
    cf = -np.ones(n, np.int32)
    cf[c_rows] = 1
    # P: identity on the C rows, one neighbouring C point for the others
    nearest = np.searchsorted(c_rows, np.arange(n)).clip(0, nc - 1)
    P = ell_from_numpy(np.ones((n, 1), np.float32),
                       nearest[:, None].astype(np.int32), nc, device="cuda")
    T = build_transfer_dia(P, torch.from_numpy(cf).cuda(), tuple(
        int(o) for o in np.unique(c_rows[nearest] - np.arange(n))[:96]))
    sel = T.expand if B == 8192 else T.compress
    assert sel.B == B and sel.vals_t.shape[0] == 1
    x = torch.from_numpy(rng.standard_normal(sel.n_cols)
                         .astype(np.float32)).cuda()
    before = kernels.LAUNCHES["banded_spmv"]
    y = fastmv.banded_spmv(sel, x)
    assert kernels.LAUNCHES["banded_spmv"] == before + 1
    ref = fastmv.banded_spmv_plain(sel.vals_t, sel.lcols_t, sel.starts, x,
                                   sel.n_rows, sel.B)
    assert torch.equal(y, ref)
    if B == 8192:
        assert torch.equal(y[torch.from_numpy(c_rows).cuda()], x)
    else:
        assert torch.equal(y, x[torch.from_numpy(c_rows).cuda()])


@pytest.mark.gpu
def test_device_setup_is_the_same_on_card_and_cpu_and_twice_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kw = dict(max_coarse_size=100, relax="chebyshev", agg_num_levels=1,
              coarse_drop_tol=0.02, transfer_dia=True)
    built = {}
    for tag, device in (("card", "cuda"), ("again", "cuda"), ("cpu", "cpu")):
        A = H.laplacian_3d_7pt(20, 20, 20, dtype=torch.float32, device=device)
        built[tag] = H.setup_hierarchy_device(A, device=device, **kw)
    a, b, c = built["card"], built["again"], built["cpu"]
    assert a.n_level_true == b.n_level_true == c.n_level_true
    for la, lb, lc in zip(a.levels, b.levels, c.levels):
        assert torch.equal(la.cf, lb.cf) and torch.equal(la.cf.cpu(), lc.cf)
        assert torch.equal(la.A.vals, lb.A.vals)
        assert torch.equal(la.A.cols.cpu(), lc.A.cols)
    assert torch.equal(a.levels[0].P.P_dia.dvals, b.levels[0].P.P_dia.dvals)
    assert torch.equal(a.coarse_inv, b.coarse_inv)


def row_planes(rng, D, n, kind):
    """Mostly-zero planes shaped like a TransferDia's: "P" rows hold 1-4
    entries, "Pt" rows are empty but for ~6 % that hold 10-43 each; "U"
    (D = 2) like a semi-structured coupling view: ~300 rows around the
    middle hold one or two entries."""
    dvals = np.zeros((D, n))
    if kind == "U":
        rows = np.sort(rng.choice(np.arange(n // 2 - 400, n // 2 + 400), 300,
                                  replace=False))
        lens = np.where(np.arange(300) % 7 == 0, 2, 1)
    elif kind == "P":
        rows = np.arange(n)
        lens = rng.integers(1, 5, n)
    else:
        rows = np.sort(rng.choice(n, n * 6 // 100, replace=False))
        lens = rng.integers(10, 44, rows.shape[0])
    # the lens[j] planes of smallest random rank in row j
    rank = rng.random((rows.shape[0], D)).argsort(1).argsort(1)
    hit = rank < lens[:, None]
    dvals[:, rows] = np.where(hit, rng.standard_normal(hit.shape), 0.0).T
    return dvals


def rows_args(C):
    return C.r_ptr, C.r_ids, C.r_vals


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["P", "Pt", "U"])
def test_row_list_kernels_match_plain_and_dense_on_card(kind):
    """The row-list kernel against its plain version and against the dense
    kernels on the same planes: the same sum in the same order, so the
    same bits; two runs give the same bits; the static offsets take the
    same kernel. P lists every row (implicitly), P^T and U list theirs and
    get the other rows' zeros from the bitmask pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng({"P": 64, "Pt": 65, "U": 66}[kind])
    n = 100003
    if kind == "U":
        D, offs = 2, (-(n // 2), n // 2)
    else:
        D = 64
        offs = tuple(sorted(int(o) for o in rng.choice(
            np.arange(-4095, 4096), D, replace=False)))
    dv = row_planes(rng, D, n, kind)
    for dtype in (torch.float32, torch.float64):
        M = dia.DiaMatrix(dvals=torch.from_numpy(dv).to("cuda", dtype),
                          offsets=offs, n_cols=n)
        C = dia.compact_dia(M)
        assert C.r_ptr is not None
        assert (C.r_lanes == 1) == (kind != "Pt")
        assert (C.r_rows is None) == (kind == "P")
        x = torch.from_numpy(rng.standard_normal(n)).to("cuda", dtype)
        plain = dia.dia_rows_plain(*rows_args(C), C.offsets, x, n, n,
                                   C.r_rows)
        dense = dia.dia_spmv(M.dvals, M.offsets, x, n, M.margin)
        before = dict(kernels.LAUNCHES)
        tail = (C.r_rows, C.r_mask, C.r_lanes)
        y = dia.dia_rows(*rows_args(C), C.offsets, x, n, n, *tail)
        y2 = dia.dia_rows(*rows_args(C), C.offsets, x, n, n, *tail)
        y_st = dia.dia_rows(*rows_args(C), offs, x, n, n, *tail)
        y_mv = dataclasses.replace(C, offsets_static=offs).mv(x)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["dia_rows"] == before["dia_rows"] + 4
        assert kernels.LAUNCHES["dia_spmv"] == before["dia_spmv"]
        assert kernels.LAUNCHES["dia_spmv_static"] == \
            before["dia_spmv_static"]
        for got in (y, y2, y_st, y_mv):
            assert torch.equal(got, plain)
            assert torch.equal(got, dense)


@pytest.mark.gpu
@pytest.mark.parametrize("listing", ["implicit", "listed"])
@pytest.mark.parametrize("lanes", dia.ROW_LANES)
def test_row_list_kernel_every_lane_count_on_card(lanes, listing,
                                                  monkeypatch):
    """Each schedule of the row-list kernel, forced on one layout (by the
    mean-length threshold): rows of 0 to D entries, offsets at +-margin, n
    not a multiple of 32; every row listed, or a list of a fifth of the
    rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(lanes)
    D, n = 96, 20011
    offs = tuple(sorted(set(int(o) for o in
                            rng.choice(np.arange(-1023, 1024), D - 2,
                                       replace=False)) | {-1024, 1024}))
    dv = rng.standard_normal((D, n)) * (rng.random((D, n)) < 0.1)
    if listing == "listed":
        dv[:, rng.random(n) < 0.8] = 0.0
    dv[:, 5] = rng.standard_normal(D)  # a full row
    dv[:, n - 1] = 0.0  # an empty row
    M = dia.DiaMatrix(dvals=torch.from_numpy(dv).to("cuda", torch.float32),
                      offsets=offs, n_cols=n)
    monkeypatch.setattr(dia, "ROWS_PER_LANE",
                        float("inf") if lanes == 1 else 0)
    C = dia.compact_dia(M)
    assert C.r_lanes == lanes
    assert (C.r_rows is None) == (listing == "implicit")
    x = torch.from_numpy(rng.standard_normal(n)).to("cuda", torch.float32)
    ref = dia.dia_spmv_static_plain(M.dvals, offs, x)
    tail = (C.r_rows, C.r_mask, lanes)
    for o in (C.offsets, offs):
        y = dia.dia_rows(*rows_args(C), o, x, n, n, *tail)
        assert torch.equal(y, ref)
        assert torch.equal(dia.dia_rows(*rows_args(C), o, x, n, n, *tail), y)


@pytest.mark.gpu
def test_row_list_wrapper_raises_on_bad_operands_on_card():
    """Wrong dtype, shape or device of the layout raises before any launch;
    nothing falls back to the dense kernel or a plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    D, n = 64, 5000
    offs = tuple(range(-32, 32))
    M = dia.DiaMatrix(dvals=torch.from_numpy(row_planes(rng, D, n, "Pt"))
                      .to("cuda", torch.float32), offsets=offs, n_cols=n)
    C = dia.compact_dia(M)
    assert C.r_rows is not None
    x = torch.ones(n, device="cuda")
    good = dict(r_ptr=C.r_ptr, r_ids=C.r_ids, r_vals=C.r_vals)
    bad = [
        dict(good, r_ptr=C.r_ptr.long()),
        dict(good, r_ptr=C.r_ptr.cpu()),
        dict(good, r_ptr=C.r_ptr[:, None]),
        dict(good, r_ids=C.r_ids.to(torch.int64)),
        dict(good, r_ids=C.r_ids[1:]),
        dict(good, r_ids=C.r_ids.cpu()),
        dict(good, r_vals=C.r_vals.double()),
        dict(good, r_vals=C.r_vals.cpu()),
        dict(good, r_vals=C.r_vals[:, None]),
    ]
    before = dict(kernels.LAUNCHES)
    for ops in bad:
        for o in (C.offsets, offs):
            with pytest.raises(ValueError):
                dia.dia_rows(ops["r_ptr"], ops["r_ids"], ops["r_vals"], o, x,
                             n, n, C.r_rows, C.r_mask, C.r_lanes)
    with pytest.raises(ValueError, match="together"):
        dia.dia_rows(*good.values(), C.offsets, x, n, n, C.r_rows, None,
                     C.r_lanes)
    with pytest.raises(ValueError, match="r_mask"):
        dia.dia_rows(*good.values(), C.offsets, x, n, n, C.r_rows,
                     C.r_mask[1:], C.r_lanes)
    with pytest.raises(ValueError, match="r_ptr"):
        dia.dia_rows(*good.values(), C.offsets, x, n, n, None, None,
                     C.r_lanes)
    with pytest.raises(ValueError, match="lanes"):
        dia.dia_rows(*good.values(), C.offsets, x, n, n, C.r_rows, C.r_mask,
                     3)
    assert kernels.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("knobs,solve", [
    (dict(), "pcg"),
    (dict(coarsen_type="ruge", interp="classical"), "pcg"),
    (dict(relax="two-stage-gs", num_sweeps=2), "gmres"),
    (dict(relax="sym-two-stage-gs"), "pcg"),
    (dict(relax="kaczmarz", relax_weight=0.5, num_sweeps=2), "gmres"),
    (dict(relax="jacobi", relax_weight=0.8), "solveT"),
])
def test_facade_on_card_equals_cpu(knobs, solve):
    """The facade at 40^3 float32 with the kernel formats on both devices
    (the CPU runs their plain versions): same levels, C points, formats
    and iterations. The banded coarse levels keep no ELL payload, so the
    Gauss-Seidel, Kaczmarz and transpose paths read the banded payload
    and schedules."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = {}
    for device in ("cuda", "cpu"):
        A = laplacian_3d_7pt(40, 40, 40, dtype=torch.float32, device=device)
        amg = H.BoomerAMG(max_coarse_size=200, **knobs).setup(
            A, optimize=True, device=device)
        hier = amg.hierarchy
        b = torch.ones(A.n_rows, dtype=torch.float32, device=device)
        before = dict(kernels.LAUNCHES)
        if solve == "solveT":
            x, info = amg.solveT(b, rtol=1e-4, maxiter=100)
        else:
            fn = H.pcg if solve == "pcg" else H.gmres
            x, info = fn(hier.levels[0].A.mv, b, M=amg.precond(), rtol=1e-6,
                         maxiter=100, device=device)
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        banded = [M for lv in hier.levels for M in (lv.A, lv.P)
                  if isinstance(M, fastmv.BandedEll)]
        assert banded and all(M.ell is None for M in banded)
        out[device] = ([lv.A.n_rows for lv in hier.levels],
                       [int((lv.cf == 1).sum()) for lv in hier.levels],
                       [(type(lv.A).__name__, type(lv.P).__name__)
                        for lv in hier.levels],
                       int(info.iterations), bool(info.converged))
        if device == "cuda":
            # the transpose cycle's level-0 product is DiaMatrix.mv_t,
            # plain tensor code; its banded levels run kernels 3 and 4
            want = (("banded_spmv", "banded_spmv_t") if solve == "solveT"
                    else ("dia_spmv", "banded_spmv"))
            assert all(launched[k] > 0 for k in want), launched
        else:
            assert not any(launched.values())
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][4]


@pytest.mark.gpu
def test_facade_host_setup_moves_the_hierarchy_to_the_card():
    """host_setup=True sets up and optimizes on the CPU, then moves the
    hierarchy: the same levels, formats and PCG count as a setup made on
    the card, and the solve runs the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A = laplacian_3d_7pt(40, 40, 40, dtype=torch.float32, device="cuda")
    b = torch.ones(A.n_rows, dtype=torch.float32, device="cuda")
    out = []
    for host_setup in (False, True):
        amg = H.BoomerAMG(max_coarse_size=200).setup(A, host_setup=host_setup)
        hier = amg.hierarchy
        assert hier.device.type == "cuda"
        before = kernels.LAUNCHES["banded_spmv"]
        _, info = H.pcg(hier.levels[0].A.mv, b, M=amg.precond(), rtol=1e-6)
        assert kernels.LAUNCHES["banded_spmv"] > before
        out.append(([lv.A.n_rows for lv in hier.levels],
                    [(type(lv.A).__name__, type(lv.P).__name__)
                     for lv in hier.levels], int(info.iterations)))
    assert out[0] == out[1]


@pytest.mark.gpu
def test_dia_kernels_at_d27_match_plain_on_card():
    """The 27-pt Laplacian's operator (D = 27): both DIA kernels give the
    plain version's bits, as at D = 7."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(27)
    for dtype in (torch.float32, torch.float64):
        A = H.laplacian_3d_27pt(20, 21, 22, dtype=dtype, device="cuda")
        D = dia.try_dia(A)
        assert D is not None and D.D == 27
        x = torch.from_numpy(rng.standard_normal(A.n_rows)).to("cuda", dtype)
        offs = tuple(D.offsets.tolist())
        ref = dia.dia_spmv_plain(D.dvals, D.offsets, x, D.margin)
        y_dyn = dia.dia_spmv(D.dvals, D.offsets, x, D.n_cols, D.margin)
        y_st = dia.dia_spmv_static(D.dvals, offs, x, D.n_cols)
        assert torch.equal(y_dyn, ref) and torch.equal(y_st, ref)
        assert close(y_dyn.cpu(), (A.vals * x[A.cols.clamp(min=0).long()])
                     .sum(dim=1).cpu(), 1e-5 if dtype == torch.float32
                     else 1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("name,args", [
    ("laplacian_1d", (300,)), ("laplacian_2d_9pt", (30, 31)),
    ("laplacian_3d_27pt", (10, 11, 12)), ("difconv_3d_7pt", (10, 11, 12)),
    ("rotated_anisotropy_2d", (30, 31)), ("elasticity_2d", (24, 25)),
    ("vardifconv_3d", (12, 13, 14))])
def test_generators_on_card_equal_cpu(name, args):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dtype in (torch.float32, torch.float64):
        A = getattr(H, name)(*args, dtype=dtype, device="cuda")
        B = getattr(H, name)(*args, dtype=dtype, device="cpu")
        assert A.vals.is_cuda and A.shifts == B.shifts
        assert torch.equal(A.vals.cpu(), B.vals)
        assert torch.equal(A.cols.cpu(), B.cols)


@pytest.mark.gpu
def test_twofloat_residual_on_card_is_the_cpu_bits():
    """No fused multiply-add on the card either: the two-float residual
    and the refiner's first pass give the CPU's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hypre_tpu_torch.seq.twofloat import dia_residual_2f, two_prod

    rng = np.random.default_rng(2)
    A = H.laplacian_3d_7pt(12, 12, 12, dtype=torch.float32, device="cpu")
    D = dia.try_dia(A)
    vecs = [torch.from_numpy(rng.standard_normal(A.n_rows).astype(np.float32))
            for _ in range(3)]
    vecs[2] = vecs[2] * 1e-8
    cpu = dia_residual_2f(D, *vecs)
    card = dia_residual_2f(D.to("cuda"), *(v.cuda() for v in vecs))
    for c, g in zip(cpu, card):
        assert torch.equal(c, g.cpu())
    p, e = two_prod(vecs[0].cuda() * 1e3, vecs[1].cuda())
    exact = (vecs[0].double() * 1e3).float().double() * vecs[1].double()
    assert close((p.double() + e.double()).cpu(), exact, 1e-14)


@pytest.mark.gpu
def test_ij_refine_hybrid_mgr_block_tridiag_on_card_equal_cpu():
    """One new module of each kind, card against CPU (plain versions):
    the IJ-assembled 16^3 Laplacian under refine_solve, HybridSolver,
    MGR and BlockTridiag; the same iteration counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = {}
    for device in ("cuda", "cpu"):
        n = 16
        lap = H.laplacian_3d_7pt(n, n, n, dtype=torch.float64, device="cpu")
        from hypre_tpu_torch.seq.ell import ell_to_csr

        csr = ell_to_csr(lap)
        rows = np.repeat(np.arange(n ** 3), csr.row_nnz())
        A = H.IJMatrix(n ** 3, n ** 3).set_values(
            rows, csr.indices, csr.data).assemble().get_object(
            dtype=torch.float32, device=device)
        b = H.IJVector(n ** 3).set_values(np.arange(n ** 3), 1.0) \
            .get_object(device=device)
        amg = H.BoomerAMG(max_coarse_size=50).setup(A, optimize=True,
                                                    device=device)

        def solve_f32(r):
            return H.pcg(A.mv, r, M=amg.precond(), rtol=1e-6, device=device)

        x, rel, inner = H.refine_solve(A, solve_f32, b, rtol=1e-8)
        assert x.device.type == device and rel <= 1e-8
        hy = H.HybridSolver(cf_tol=0.5, amg=H.BoomerAMG(max_coarse_size=50)) \
            .setup(A, optimize=True, device=device)
        _, hi = hy.solve(b, rtol=1e-6)
        m = 16
        cpts = np.nonzero((np.arange(m * m) // m + np.arange(m * m) % m) % 2
                          == 0)[0]
        L = H.laplacian_2d_5pt(m, m, dtype=torch.float32, device=device)
        mgr = H.MGR().setup(L, [cpts], optimize=True, device=device)
        _, mi = mgr.solve(torch.ones(m * m, device=device), rtol=1e-4)
        E = H.elasticity_2d(12, 12, dtype=torch.float32, device=device)
        bt = H.BlockTridiag(amg_knobs=dict(max_coarse_size=16)).setup(
            E, np.arange(0, E.n_rows, 2), optimize=True, device=device)
        _, bi = H.flexgmres(E.mv, torch.ones(E.n_rows, device=device),
                            M=bt.precond(), rtol=1e-5, device=device)
        out[device] = (inner, hy.dscg_iterations, hy.amg_iterations,
                       int(mi.iterations), int(bi.iterations),
                       bool(hi.converged), bool(mi.converged),
                       bool(bi.converged))
    assert out["cuda"] == out["cpu"]
    assert all(out["cuda"][5:])


@pytest.mark.gpu
def test_sa_gsmg_block_amg_ams_on_card_equal_cpu():
    """The rest of amg/ card against CPU (plain versions), float32:
    SmoothedAggAMG and GSMG on the 24^3 Laplacian with the kernel formats,
    BlockAMG on elasticity_2d(24, 24), AMS on the curl-curl problem of the
    6^3 hex complex: the same levels (aggregate and C-point counts),
    formats and iterations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hypre_tpu_torch.amg.ams import AMS
    from hypre_tpu_torch.amg.block_amg import BlockAMG
    from hypre_tpu_torch.amg.gsmg import GSMG
    from hypre_tpu_torch.problems import maxwell
    from hypre_tpu_torch.seq.bsr import ell_to_bsr

    def levels(hier):
        return ([lv.A.n_rows for lv in hier.levels]
                + [hier.coarse_inv.shape[0]],
                [(type(lv.A).__name__, type(lv.P).__name__)
                 for lv in hier.levels])

    out = {}
    for device in ("cuda", "cpu"):
        rec = []
        A = laplacian_3d_7pt(24, 24, 24, dtype=torch.float32, device=device)
        b = torch.ones(A.n_rows, dtype=torch.float32, device=device)
        for cls in (H.SmoothedAggAMG, GSMG):
            amg = cls(max_coarse_size=200).setup(A, optimize=True,
                                                 device=device)
            _, info = H.pcg(amg.hierarchy.levels[0].A.mv, b,
                            M=amg.precond(), rtol=1e-6, maxiter=200,
                            device=device)
            rec.append((levels(amg.hierarchy), int(info.iterations),
                        bool(info.converged)))
        E = H.elasticity_2d(24, 24, dtype=torch.float32, device=device)
        bam = BlockAMG().setup(ell_to_bsr(E, 2), device=device)
        _, info = H.pcg(E.mv, torch.ones(E.n_rows, device=device),
                        M=bam.precond(), rtol=1e-6, maxiter=200,
                        device=device)
        rec.append(([lv.A.n_rows for lv in bam.levels],
                    int(info.iterations), bool(info.converged)))
        Ac, G, xyz = maxwell.curl_curl_3d(6, dtype=torch.float32,
                                         device=device)
        ams = AMS().setup(Ac, G, xyz, device=device, optimize=True)
        _, info = H.pcg(Ac.mv, torch.ones(Ac.n_rows, device=device),
                        M=ams.precond(), rtol=1e-6, maxiter=200,
                        device=device)
        rec.append(([levels(B.hierarchy) for B in [ams.B_G] + ams.B_Pi],
                    int(info.iterations), bool(info.converged)))
        out[device] = rec
    assert out["cuda"] == out["cpu"]
    assert all(r[-1] for r in out["cuda"])


PRECOND_CLASSES = [
    ("ILU", {}), ("ILU", dict(fill_level=1)), ("ILUT", {}), ("Euclid", {}),
    ("PILUT", {}), ("IC", {}), ("DDICT", {}), ("DDILUT", {}), ("FSAI", {}),
    ("FSAI", dict(algo_type="adaptive")), ("ParaSails", {}),
    ("Schwarz", {}), ("Schwarz", dict(overlap=2, weighting="ras")),
    ("PolyPrecond", {}), ("ILUSchurNSH", dict(nparts=2, nsh_iters=12)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw", PRECOND_CLASSES,
                         ids=[n + "".join(f",{k}={v}" for k, v in kw.items())
                              for n, kw in PRECOND_CLASSES])
def test_preconditioner_on_card_equals_cpu(name, kw):
    """Each preconditioner at 16^3 float32 on the card and on the CPU:
    its factors to 1e-5 relative, and one application to 1e-5; the
    polynomial's products on the card run the DIA kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hypre_tpu_torch import precond as P
    from hypre_tpu_torch.seq.ell import ell_to_csr

    r = np.random.default_rng(3).standard_normal(16 ** 3).astype(np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        A = laplacian_3d_7pt(16, 16, 16, dtype=torch.float32, device=device)
        before = dict(kernels.LAUNCHES)
        obj = getattr(P, name)(**kw).setup(A, device=device)
        z = obj.precond()(torch.from_numpy(r).to(device))
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        parts = {}
        inner = getattr(obj, "_ilut", None) or obj
        for key in ("L", "U", "G", "M", "Lt"):
            M = getattr(inner, key, None)
            if M is not None:
                parts[key] = ell_to_csr(M).to_dense()
        for key in ("dinv", "inv_blocks", "X"):
            t = getattr(obj, key, None)
            if isinstance(t, torch.Tensor):
                parts[key] = t.cpu().numpy()
        parts["z"] = z.cpu().numpy()
        out[device] = parts
        if device == "cuda" and name == "PolyPrecond":
            assert launched["dia_spmv"] > 0
    assert out["cuda"].keys() == out["cpu"].keys()
    for key in out["cpu"]:
        assert close(out["cuda"][key], out["cpu"][key], 1e-5), key


@pytest.mark.gpu
@pytest.mark.parametrize("flags,dtype", [
    ("-solver 31 -recompute 0", torch.float32),
    ("-solver 8 -recompute 0", torch.float32),
    ("-solver 12 -recompute 0", torch.float32),
    ("-solver 43 -recompute 0", torch.float32),
    ("-solver 80", torch.float64), ("-solver 81", torch.float64),
    ("-solver 7", torch.float64),
    ("-solver 1 -rlx 18 -smtype 4 -smlv 2 -recompute 0", torch.float32),
    ("-solver 1 -rlx 18 -smtype 5 -smlv 2 -recompute 0", torch.float32),
    ("-solver 1 -rlx 18 -smtype 6 -smlv 2 -recompute 0", torch.float32),
])
def test_ij_driver_on_card_equals_cpu(flags, dtype):
    """The ij driver's preconditioner ids at 20^3, rtol 1e-5, on the card
    and on the CPU: the same iterations; on the card the outer A runs the
    DIA kernel. The left-preconditioned GMRES ids run in float64, as in
    chip_smoke.py phase 13 (their float32 restarts floor near rtol)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import contextlib
    import io

    from hypre_tpu_torch.drivers import ij

    its = {}
    for device in ("cuda", "cpu"):
        before = dict(kernels.LAUNCHES)
        with contextlib.redirect_stdout(io.StringIO()):
            its[device] = ij.run(f"{flags} -n 20 20 20 -tol 1e-5".split(),
                                 device=device, dtype=dtype)[0]
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        assert (launched["dia_spmv"] > 0) == (device == "cuda")
    assert its["cuda"] == its["cpu"]


STRUCT_VIEWS = [
    ("constant 5-pt", dict(shape=(64, 48))),
    ("variable 7-pt", dict(shape=(20, 21, 22), constant=False,
                           weights=(1.0, 0.5, 2.0))),
    ("periodic x", dict(shape=(64, 48), periodic=(True, False))),
    ("periodic y z", dict(shape=(12, 14, 16), periodic=(False, True, True))),
]


@pytest.mark.gpu
@pytest.mark.parametrize("label,kw", STRUCT_VIEWS,
                         ids=[v[0] for v in STRUCT_VIEWS])
def test_struct_dia_view_matches_plain_on_card(label, kw):
    """A StructMatrix's DIA view on the card (static and dynamic kernel)
    against the plain DIA version and the CPU's shift-and-add, bit for
    bit; struct_matvec refuses a CUDA tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hypre_tpu_torch.problems.struct_problems import struct_laplacian
    from hypre_tpu_torch.struct import matrix

    rng = np.random.default_rng(12)
    for dtype in (torch.float32, torch.float64):
        A = struct_laplacian(dtype=dtype, device="cuda", **kw)
        x = torch.from_numpy(rng.standard_normal(A.shape)).to("cuda", dtype)
        cpu = matrix.struct_matvec(A.to("cpu"), x.cpu())
        for view, kernel in ((A.dia, "dia_spmv_static"),
                             (matrix.dia_view(A, specialize=False),
                              "dia_spmv")):
            before = kernels.LAUNCHES[kernel]
            y = view.mv(x.reshape(-1))
            torch.cuda.synchronize()
            assert kernels.LAUNCHES[kernel] == before + 1
            plain = dia.dia_spmv_plain(view.dvals, view.offsets,
                                       x.reshape(-1), view.margin)
            assert torch.equal(y, plain)
            assert torch.equal(y.cpu().reshape(A.shape), cpu)
        before = kernels.LAUNCHES["dia_spmv_static"]
        assert torch.equal(A.mv(x), A.dia.mv(x.reshape(-1)).reshape(A.shape))
        assert kernels.LAUNCHES["dia_spmv_static"] == before + 2
        with pytest.raises(ValueError, match="CPU tensors"):
            matrix.struct_matvec(A, x)


@pytest.mark.gpu
def test_struct_solvers_on_card_equal_cpu():
    """PFMG-PCG and SMG-PCG through the struct driver: the card's
    iterations and cdir sequence are the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import contextlib
    import io as _io

    from hypre_tpu_torch.drivers import struct as drv
    from hypre_tpu_torch.problems.struct_problems import struct_laplacian
    from hypre_tpu_torch.struct import PFMG

    for flags in ("-solver 11 -n 32 32 1 -tol 1e-6",
                  "-solver 10 -n 12 12 12 -tol 1e-6"):
        got = {}
        for dev in ("cuda", "cpu"):
            with contextlib.redirect_stdout(_io.StringIO()):
                got[dev] = drv.run(flags.split(), device=dev,
                                   dtype=torch.float32)[0]
        assert got["cuda"] == got["cpu"], flags
    cd = {dev: PFMG().setup(struct_laplacian(
        (40, 24, 16), dtype=torch.float32, device=dev)).hierarchy.cdirs
        for dev in ("cuda", "cpu")}
    assert cd["cuda"] == cd["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("nvars,shape", [(2, (64, 48)), (3, (20, 21, 22))])
def test_sys_dia_view_matches_plain_on_card(nvars, shape):
    """A SysStructMatrix's flat DIA view (random coefficients in every
    block, a box stencil) on the card against the plain DIA version and
    the CPU's shifted products, bit for bit against the plain version;
    sys_matvec refuses a CUDA tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import itertools

    from hypre_tpu_torch.convert import sys_struct_from_numpy
    from hypre_tpu_torch.sstruct import syspfmg

    rng = np.random.default_rng(nvars)
    offsets = list(itertools.product(*[(-1, 0, 1)] * len(shape)))
    if len(shape) == 3:  # the 7-pt star: 5 * 7 = 35 planes
        offsets = [o for o in offsets if sum(map(abs, o)) <= 1]
    coeffs = rng.standard_normal((nvars, nvars, len(offsets)) + shape)
    for dtype in (torch.float32, torch.float64):
        A = sys_struct_from_numpy(coeffs, offsets, shape, device="cuda")
        A = syspfmg.SysStructMatrix(coeffs=A.coeffs.to(dtype),
                                    stencil=A.stencil, shape=A.shape)
        view = A.dia
        assert view.D == (2 * nvars - 1) * len(offsets)
        kernel = ("dia_spmv_static" if view.offsets_static is not None
                  else "dia_spmv")
        x = torch.from_numpy(rng.standard_normal((nvars,) + shape)).to(
            "cuda", dtype)
        before = kernels.LAUNCHES[kernel]
        y = A.mv(x)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[kernel] == before + 1
        plain = dia.dia_spmv_plain(view.dvals, view.offsets, x.reshape(-1),
                                   view.margin)
        assert torch.equal(y.reshape(-1), plain)
        cpu = syspfmg.sys_matvec(A.to("cpu"), x.cpu())
        assert close(y.cpu(), cpu, 1e-5 if dtype == torch.float32 else 1e-12)
        with pytest.raises(ValueError, match="CPU tensors"):
            syspfmg.sys_matvec(A, x)


@pytest.mark.gpu
def test_sstruct_mv_on_card_equals_cpu():
    """The two-part SStructMatrix on the card: each part's DIA kernel and
    U's DIA view, the bits of the CPU's plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hypre_tpu_torch.drivers import sstruct as drv
    from hypre_tpu_torch.seq.dia import DiaMatrix

    for dtype in (torch.float32, torch.float64):
        got = {}
        for dev in ("cuda", "cpu"):
            _, A = drv.two_part_problem(96, dtype=dtype, device=dev)
            x = torch.from_numpy(np.random.default_rng(3).standard_normal(
                A.n_rows)).to(dev, dtype)
            before = dict(kernels.LAUNCHES)
            got[dev] = A.mv(x).cpu()
            grew = {k: kernels.LAUNCHES[k] - before[k] for k in before}
            assert isinstance(A.U_op, DiaMatrix)
            if dev == "cuda":
                assert grew["dia_spmv_static"] == 2
                assert grew["dia_spmv"] + grew["dia_rows"] == 1
        assert torch.equal(got["cuda"], got["cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [
    "-solver 10 -n 12 -tol 1e-8", "-solver 11 -n 12 -tol 1e-8",
    "-solver 20 -n 12 -tol 1e-8", "-solver 3 -n 16 -tol 1e-7",
    "-solver 28 -n 12 -tol 1e-8", "-solver 120 -n 10 -tol 1e-8"])
def test_sstruct_driver_on_card_equals_cpu(flags):
    """Every sstruct driver id at its golden flags, float64: the card's
    iterations are the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import contextlib
    import io as _io

    from hypre_tpu_torch.drivers import sstruct as drv

    got = {}
    for dev in ("cuda", "cpu"):
        with contextlib.redirect_stdout(_io.StringIO()):
            got[dev] = drv.run(flags.split(), device=dev,
                               dtype=torch.float64)[0]
    assert got["cuda"] == got["cpu"]
