"""hypre_tpu_torch's seq layer against hypre_tpu's on the same inputs.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU with x64 (tests/conftest.py), the port with device="cpu",
which runs each kernel's plain PyTorch version. Float64 results agree to
1e-12 relative unless a test says why not; structure (column order per
row) must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.core.config import hash_rand01 as j_hash
from hypre_tpu.problems.laplacian import laplacian_3d_7pt as j_lap7
from hypre_tpu.seq import dia as j_dia
from hypre_tpu.seq import spgemm as j_spgemm
from hypre_tpu.seq.ell import EllMatrix as JEll, ell_from_dense as \
    j_from_dense, ell_spmv as j_spmv, ell_spmv_t as j_spmv_t

from hypre_tpu_torch import kernels
from hypre_tpu_torch.core.config import hash_rand01, resolve_device
from hypre_tpu_torch.convert import ell_from_numpy
from hypre_tpu_torch.problems.laplacian import laplacian_3d_7pt
from hypre_tpu_torch.seq import dia, spgemm
from hypre_tpu_torch.seq.ell import ell_from_dense, ell_spmv, ell_spmv_t, \
    ell_to_csr


def random_ell(rng, n, m, k, dtype=np.float64, pad_frac=0.2):
    cols = rng.integers(0, m, size=(n, k)).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(dtype)
    pad = rng.random((n, k)) < pad_frac
    cols[pad] = -1
    vals[pad] = 0
    return vals, cols


def both(vals, cols, m, shifts=None):
    return (JEll(vals=jnp.asarray(vals), cols=jnp.asarray(cols), n_cols=m,
                 shifts=shifts),
            ell_from_numpy(vals, cols, m, shifts=shifts, device="cpu"))


def close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(initial=0.0), 1e-300)
    return np.abs(a - b).max(initial=0.0) <= rtol * scale


@pytest.mark.parametrize("lo,hi", [(0, 2**21), (2**31 - 2**16, 2**31 - 1)])
def test_hash_rand01_bit_identical(lo, hi):
    idx = np.arange(lo, hi, dtype=np.int64)
    ref = np.asarray(j_hash(jnp.asarray(idx.astype(np.int32))))
    got = hash_rand01(torch.from_numpy(idx)).numpy()
    assert ref.dtype == got.dtype == np.float32
    assert np.array_equal(ref.view(np.uint32), got.view(np.uint32))


def test_ell_spmv_and_transpose_match_reference():
    rng = np.random.default_rng(0)
    vals, cols = random_ell(rng, 300, 120, 6)
    jA, tA = both(vals, cols, 120)
    x = rng.standard_normal(120)
    r = rng.standard_normal(300)
    assert close(ell_spmv(tA, torch.from_numpy(x)),
                 j_spmv(jA, jnp.asarray(x)))
    assert close(ell_spmv_t(tA, torch.from_numpy(r)),
                 j_spmv_t(jA, jnp.asarray(r)))
    with pytest.raises(ValueError):
        ell_spmv(tA, torch.zeros(7, dtype=torch.float64))


def test_dense_csr_ell_round_trip_matches_reference():
    rng = np.random.default_rng(13)
    M = rng.standard_normal((40, 30)) * (rng.random((40, 30)) < 0.15)
    tA = ell_from_dense(M, device="cpu")
    jA = j_from_dense(M)
    assert np.array_equal(tA.cols.numpy(), np.asarray(jA.cols))
    assert np.array_equal(tA.vals.numpy(), np.asarray(jA.vals))
    assert np.array_equal(ell_to_csr(tA).to_dense(), M)


@pytest.mark.parametrize("specialize", [False, True])
def test_dia_mv_matches_reference_jnp_paths(specialize):
    rng = np.random.default_rng(1)
    jA = j_lap7(6, 7, 8)
    tA = laplacian_3d_7pt(6, 7, 8, dtype=torch.float64, device="cpu")
    jD = j_dia.try_dia(jA, specialize=specialize)
    tD = dia.try_dia(tA, specialize=specialize)
    assert tD.margin == jD.margin
    assert tD.offsets.tolist() == np.asarray(jD.offsets).tolist()
    assert tD.offsets_static == jD.offsets_static
    assert np.array_equal(tD.dvals.numpy(), np.asarray(jD.dvals))
    x = rng.standard_normal(tA.n_rows)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    launches = dict(kernels.LAUNCHES)
    assert close(tD.mv(xt), jD.mv(xj))
    assert close(tD.mv_t(xt), jD.mv_t(xj))
    assert close(tD.lower_apply(xt), jD.lower_apply(xj))
    assert close(tD.upper_apply(xt), jD.upper_apply(xj))
    # a CPU tensor takes the plain version and launches nothing
    assert kernels.LAUNCHES == launches
    assert close(tD.mv(xt), ell_spmv(tA, xt))


def test_dia_plain_versions_agree_and_non_stencil_try_dia():
    rng = np.random.default_rng(2)
    vals, cols = random_ell(rng, 50, 50, 5)
    rows = np.arange(50)[:, None]
    cols = np.where(cols >= 0, np.clip(rows + (cols % 7) - 3, 0, 49), -1) \
        .astype(np.int32)
    jA, tA = both(vals, cols, 50)
    jD, tD = j_dia.try_dia(jA), dia.try_dia(tA)
    assert tD.offsets.tolist() == np.asarray(jD.offsets).tolist()
    assert np.array_equal(tD.dvals.numpy(), np.asarray(jD.dvals))
    x = torch.from_numpy(rng.standard_normal(50))
    offs = tuple(tD.offsets.tolist())
    y_dyn = dia.dia_spmv_plain(tD.dvals, tD.offsets, x, tD.margin)
    y_st = dia.dia_spmv_static_plain(tD.dvals, offs, x)
    assert torch.equal(y_dyn, y_st)
    assert close(y_dyn, ell_spmv(tA, x))
    assert dia.try_dia(ell_from_numpy(vals, cols, 50, device="cpu"),
                       max_offsets=2) is None


def _same_ell(t, j, rtol=1e-12):
    assert t.k == j.k and t.n_cols == j.n_cols
    assert np.array_equal(t.cols.numpy(), np.asarray(j.cols))
    assert close(t.vals, j.vals, rtol)


@pytest.mark.parametrize("route", ["one_shot", "chunked"])
def test_ell_spgemm_matches_reference(route, monkeypatch):
    rng = np.random.default_rng(3)
    va, ca = random_ell(rng, 400, 400, 7)
    vb, cb = random_ell(rng, 400, 90, 4)
    jA, tA = both(va, ca, 400)
    jB, tB = both(vb, cb, 90)
    if route == "chunked":
        # force the row-chunked route with many small chunks
        monkeypatch.setattr(spgemm, "_BIG_SPGEMM_ELEMENTS", 100)
        monkeypatch.setattr(spgemm, "_SPGEMM_CHUNK_ELEMENTS", 7 * 4 * 37)
    _same_ell(spgemm.ell_spgemm(tA, tB), j_spgemm.ell_spgemm(jA, jB))
    # a capacity below the true width is retried to the true width
    _same_ell(spgemm.ell_spgemm(tA, tB, out_k=3),
              j_spgemm.ell_spgemm(jA, jB, out_k=3))


def test_ell_transpose_and_stencil_products_match_reference():
    rng = np.random.default_rng(4)
    vals, cols = random_ell(rng, 300, 80, 5)
    jA, tA = both(vals, cols, 80)
    _same_ell(spgemm.ell_transpose(tA), j_spgemm.ell_transpose(jA))
    _same_ell(spgemm.ell_transpose(tA, out_k=2),
              j_spgemm.ell_transpose(jA, out_k=2))
    jL = j_lap7(5, 6, 7)
    tL = laplacian_3d_7pt(5, 6, 7, dtype=torch.float64, device="cpu")
    tS = spgemm.ell_spgemm(tL, tL)
    jS = j_spgemm.ell_spgemm(jL, jL)
    assert tS.shifts == jS.shifts
    _same_ell(tS, jS)
    tT = spgemm.ell_transpose(tL)
    assert tT.shifts == j_spgemm.ell_transpose(jL).shifts
    _same_ell(tT, j_spgemm.ell_transpose(jL))


def test_ell_filter_and_remap_match_reference():
    rng = np.random.default_rng(5)
    vals, cols = random_ell(rng, 100, 60, 6)
    jA, tA = both(vals, cols, 60)
    keep = rng.random((100, 6)) < 0.5
    _same_ell(spgemm.ell_filter(tA, torch.from_numpy(keep), out_k=4),
              j_spgemm.ell_filter(jA, jnp.asarray(keep), out_k=4))
    cmap = np.where(rng.random(60) < 0.6, rng.integers(0, 30, 60), -1) \
        .astype(np.int32)
    _same_ell(spgemm.ell_remap_cols(tA, torch.from_numpy(cmap), 30),
              j_spgemm.ell_remap_cols(jA, jnp.asarray(cmap), 30))


def test_entry_points_need_a_device_without_a_card():
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda")
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        laplacian_3d_7pt(4, 4, 4)
    with pytest.raises(RuntimeError):
        ell_from_numpy(np.zeros((2, 1)), np.zeros((2, 1), np.int32), 2)
