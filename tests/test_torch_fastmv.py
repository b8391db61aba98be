"""hypre_tpu_torch's banded (BandedEll) format against hypre_tpu's.

The schedule and payload must equal the reference's ``try_banded`` on the
same float32 matrix. The plain gather and scatter-transpose versions are
held against the reference's ``ell_spmv``/``ell_spmv_t`` (the exact
product; the reference's bf16 gather modes are a TPU device choice), at
float32 tolerance: the sums run in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    launches = dict(kernels.LAUNCHES)
    y = tb.drop_ell().mv(torch.from_numpy(x)).numpy()
    yt = tb.drop_ell().mv_t(torch.from_numpy(r)).numpy()
    assert kernels.LAUNCHES == launches  # CPU tensors: plain versions only
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
