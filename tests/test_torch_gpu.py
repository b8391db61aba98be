"""Card-only tests of hypre_tpu_torch: each hand-written CUDA kernel
against its plain PyTorch version, and the card against the CPU.

This file imports neither JAX nor hypre_tpu, so it also runs where only
the port is installed; there, skip the JAX-based conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Without a card every test skips.
"""

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
