"""hypre_tpu_torch.seq.transfer_dia against hypre_tpu.seq.transfer_dia.

The interpolation of an aggressive stencil level, built by the reference on
the CPU in float64, goes through both packages' TransferDia constructors:
offsets, diagonal planes, selections and window buckets must be equal
(integers exactly, values to 1e-12), both products must equal the ELL
products of P, and a cycle over a reference hierarchy carried across by
``convert.hierarchy_from_numpy`` must equal the reference's cycle to 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.amg import device_setup as JD
from hypre_tpu.amg import hierarchy as j_hier
from hypre_tpu.amg.coarsen import coarse_map as j_coarse_map, pmis as j_pmis
from hypre_tpu.amg.strength import strength_mask as j_strength
from hypre_tpu.problems.laplacian import laplacian_3d_7pt as j_lap7
from hypre_tpu.seq import transfer_dia as JT
from hypre_tpu.seq.ell import EllMatrix as JEll, ell_spmv as j_spmv, \
    ell_spmv_t as j_spmv_t

import hypre_tpu_torch as H
from hypre_tpu_torch import kernels
from hypre_tpu_torch.amg import device_setup as TD
from hypre_tpu_torch.convert import ell_from_numpy
from hypre_tpu_torch.seq import dia as TDIA
from hypre_tpu_torch.seq import transfer_dia as TT
from hypre_tpu_torch.seq.ell import ell_spmv, ell_spmv_t
from torch_one_thread import one_torch_thread  # noqa: F401


RTOL = 1e-12
SETUP = dict(max_coarse_size=100, relax="chebyshev", agg_num_levels=1,
             coarse_drop_tol=0.02, transfer_dia=True)


@pytest.fixture(scope="module", autouse=True)
def reference_setup_env(tmp_path_factory):
    """Keep the reference's setup registry in a temporary directory and
    its replay off."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HYPRE_TPU_SHAPE_REGISTRY",
              str(tmp_path_factory.mktemp("reg") / "reg.json"))
    mp.setenv("HYPRE_TPU_NO_FAST_SETUP", "1")
    yield
    mp.undo()


def tt(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def close(got, ref, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max(initial=0.0) <= rtol * max(
        np.abs(ref).max(initial=0.0), 1e-300)


@pytest.fixture(scope="module")
def interp():
    """Multipass interpolation of the 10x9x8 7-pt Laplacian after the
    second PMIS pass, from the reference; coarse columns padded to the row
    bucket as the setup does."""
    jA = j_lap7(10, 9, 8)
    S = j_strength(jA, 0.25)
    cf1 = j_pmis(jA, S)
    scols = jnp.where(S, jA.cols, -1)
    svals = jnp.where(S, jA.vals, 0.0)
    cf = JD.second_pass_pmis(scols, cf1, jA.n_rows, s2_cap=32,
                             shifts=jA.shifts)
    cmap, n_c = j_coarse_map(cf)
    pc, pv, _, _ = JD.multipass_interp_device(jA, scols, svals, cf, cmap, 4,
                                              shifts=jA.shifts)
    n_c = int(n_c)
    nc_b = JD._row_bucket(n_c)
    assert nc_b > n_c  # the padded coarse rows are part of the test
    return dict(n=jA.n_rows, n_c=n_c, nc_b=nc_b, cf=np.asarray(cf),
                pc=np.asarray(pc), pv=np.asarray(pv))


def same_dia(t, j):
    assert tuple(t.offsets.tolist()) == tuple(np.asarray(j.offsets).tolist())
    assert (t.n_cols, t.margin, t.D) == (j.n_cols, j.margin, j.D)
    assert close(t.dvals, j.dvals)


def same_banded(t, j):
    assert (t.W, t.B, t.n_xpad, t.n_rows, t.n_cols) == \
        (j.W, j.B, j.n_xpad, j.n_rows, j.n_cols)
    assert np.array_equal(t.lcols_t.numpy(), np.asarray(j.lcols_t))
    assert np.array_equal(t.starts.numpy(), np.asarray(j.starts))
    assert np.array_equal(t.vals_t.numpy(), np.asarray(j.vals_t))
    assert np.array_equal(t.ell.cols.numpy(), np.asarray(j.ell.cols))
    assert np.array_equal(t.ell.vals.numpy(), np.asarray(j.ell.vals))


def test_probe_transfer_offsets_matches_reference(interp):
    ref = JT.probe_transfer_offsets(jnp.asarray(interp["pc"]),
                                    jnp.asarray(interp["cf"]),
                                    interp["nc_b"])
    got = TT.probe_transfer_offsets(tt(interp["pc"]), tt(interp["cf"]),
                                    interp["nc_b"])
    assert isinstance(got, tuple) and got == ref
    assert 4 < len(got) <= 96 and list(got) == sorted(got)


def test_more_than_max_offsets_gives_none(interp):
    pc, cf = tt(interp["pc"]), tt(interp["cf"])
    n_off = len(TT.probe_transfer_offsets(pc, cf, interp["nc_b"]))
    assert TT.probe_transfer_offsets(pc, cf, interp["nc_b"],
                                     max_offsets=n_off - 1) is None
    assert JT.probe_transfer_offsets(
        jnp.asarray(interp["pc"]), jnp.asarray(interp["cf"]),
        interp["nc_b"], max_offsets=n_off - 1) is None
    assert TT.probe_transfer_offsets(pc, cf, interp["nc_b"],
                                     max_offsets=n_off) is not None
    P = ell_from_numpy(interp["pv"].astype(np.float32), interp["pc"],
                       interp["n_c"], device="cpu")
    c2f = torch.nonzero(cf == 1)[:, 0]
    assert TT.try_transfer_dia(P, c2f, max_offsets=n_off - 1) is None
    assert TT.build_transfer_dia(P, cf, None) is None


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_build_transfer_dia_matches_reference(interp, dtype):
    n, nc_b = interp["n"], interp["nc_b"]
    pv = interp["pv"].astype(dtype)
    jP = JEll(vals=jnp.asarray(pv), cols=jnp.asarray(interp["pc"]),
              n_cols=nc_b)
    tP = ell_from_numpy(pv, interp["pc"], nc_b, device="cpu")
    offs = TT.probe_transfer_offsets(tP.cols, tt(interp["cf"]), nc_b)
    jT = JT.build_transfer_dia(jP, jnp.asarray(interp["cf"]), offs)
    tT = TT.build_transfer_dia(tP, tt(interp["cf"]), offs)
    assert tT.shape == jT.shape == (n, nc_b) and tT.dtype == tP.dtype
    assert tT.P_dia.D == TD._bucket(len(offs)) >= len(offs)
    same_dia(tT.P_dia, jT.P_dia)
    same_dia(tT.Pt_dia, jT.Pt_dia)
    same_banded(tT.expand, jT.expand)
    same_banded(tT.compress, jT.compress)
    assert (tT.expand.B, tT.compress.B) == (8192, 2048)

    rng = np.random.default_rng(0)
    ec = rng.standard_normal(nc_b).astype(dtype)
    r = rng.standard_normal(n).astype(dtype)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    launches = dict(kernels.LAUNCHES)
    up, down = tT.mv(tt(ec)), tT.mv_t(tt(r))
    assert kernels.LAUNCHES == launches  # CPU tensors: the plain versions
    assert close(up, ell_spmv(tP, tt(ec)).numpy(), tol)
    assert close(down, ell_spmv_t(tP, tt(r)).numpy(), tol)
    assert close(up, jT.mv(jnp.asarray(ec)), tol)
    assert close(down, jT.mv_t(jnp.asarray(r)), tol)
    assert close(up, j_spmv(jP, jnp.asarray(ec)), tol)
    assert close(down, j_spmv_t(jP, jnp.asarray(r)), tol)
    # the padded coarse rows select nothing
    assert float(down[interp["n_c"]:].abs().max()) == 0.0


def test_try_transfer_dia_matches_reference(interp):
    n, n_c = interp["n"], interp["n_c"]
    pv = interp["pv"].astype(np.float32)  # the banded selections are f32
    jP = JEll(vals=jnp.asarray(pv), cols=jnp.asarray(interp["pc"]),
              n_cols=n_c)
    tP = ell_from_numpy(pv, interp["pc"], n_c, device="cpu")
    c2f = np.nonzero(interp["cf"] == 1)[0].astype(np.int32)
    jT = JT.try_transfer_dia(jP, jnp.asarray(c2f), exact=2)
    tT = TT.try_transfer_dia(tP, tt(c2f), exact=2)
    assert jT is not None and tT is not None
    assert tuple(tT.P_dia.offsets.tolist()) == \
        tuple(np.asarray(jT.P_dia.offsets).tolist())
    assert close(tT.P_dia.dvals, jT.P_dia.dvals, 1e-6)
    assert close(tT.Pt_dia.dvals, jT.Pt_dia.dvals, 1e-6)
    assert (tT.expand.W, tT.expand.B, tT.compress.W, tT.compress.B) == \
        (jT.expand.W, jT.expand.B, jT.compress.W, jT.compress.B)
    rng = np.random.default_rng(1)
    ec = rng.standard_normal(n_c).astype(np.float32)
    r = rng.standard_normal(n).astype(np.float32)
    assert close(tT.mv(tt(ec)), ell_spmv(tP, tt(ec)).numpy(), 1e-5)
    assert close(tT.mv_t(tt(r)), ell_spmv_t(tP, tt(r)).numpy(), 1e-5)
    assert close(tT.mv(tt(ec)), j_spmv(jP, jnp.asarray(ec)), 1e-5)
    assert close(tT.mv_t(tt(r)), j_spmv_t(jP, jnp.asarray(r)), 1e-5)
    # float64 has no banded selection: no TransferDia, as try_banded says
    assert TT.try_transfer_dia(
        ell_from_numpy(interp["pv"], interp["pc"], n_c, device="cpu"),
        tt(c2f)) is None


# ---------------------------------------------------------------------------
# whole hierarchies
# ---------------------------------------------------------------------------


def flatten(jh) -> dict:
    """A reference AMGHierarchy, TransferDia levels included, as the dict
    of numpy arrays ``hierarchy_from_numpy`` takes."""
    def ell(M):
        return {"vals": np.asarray(M.vals), "cols": np.asarray(M.cols),
                "n_cols": M.n_cols, "shifts": M.shifts}

    def dia(M):
        return {"dvals": np.asarray(M.dvals),
                "offsets": np.asarray(M.offsets), "n_cols": M.n_cols}

    def banded(M):
        return {"ell": ell(M.ell), "vals_t": np.asarray(M.vals_t),
                "lcols_t": np.asarray(M.lcols_t),
                "starts": np.asarray(M.starts), "W": M.W, "B": M.B,
                "n_xpad": M.n_xpad, "exact": M.exact}

    def mat(M):
        if M is None:
            return None
        if isinstance(M, JT.TransferDia):
            return {"P_dia": dia(M.P_dia), "Pt_dia": dia(M.Pt_dia),
                    "expand": banded(M.expand),
                    "compress": banded(M.compress), "n_coarse": M.n_cols}
        return ell(M)

    return {
        "levels": [{"A": mat(lv.A), "P": mat(lv.P), "Pt": mat(lv.Pt),
                    "dinv": np.asarray(lv.dinv),
                    "l1inv": np.asarray(lv.l1inv),
                    "lmax": np.asarray(lv.lmax), "cf": np.asarray(lv.cf)}
                   for lv in jh.levels],
        "coarse_inv": np.asarray(jh.coarse_inv), "galerkin": jh.galerkin,
        "n_fine": jh.n_fine, "n_level_true": jh.n_level_true,
    }


@pytest.fixture(scope="module")
def hierarchies():
    """(jax A, port A, jax hierarchy, port hierarchy) of the 11^3 7-pt
    Laplacian (1331 rows, padded to 1536) with the stencil level's
    interpolation stored as a TransferDia."""
    jA = j_lap7(11, 11, 11)
    tA = H.laplacian_3d_7pt(11, 11, 11, dtype=torch.float64, device="cpu")
    return (jA, tA, JD.setup_hierarchy_device(jA, **SETUP),
            H.setup_hierarchy_device(tA, device="cpu", **SETUP))


def test_device_setup_stores_the_reference_transfer_dia(hierarchies):
    jA, tA, jh, th = hierarchies
    assert th.n_fine == jh.n_fine == 1331
    assert th.n_level_true == tuple(jh.n_level_true)
    jT, tT = jh.levels[0].P, th.levels[0].P
    assert isinstance(jT, JT.TransferDia) and isinstance(tT, H.TransferDia)
    assert th.levels[0].Pt is None and jh.levels[0].Pt is None
    same_dia(tT.P_dia, jT.P_dia)
    same_dia(tT.Pt_dia, jT.Pt_dia)
    same_banded(tT.expand, jT.expand)
    same_banded(tT.compress, jT.compress)
    assert tT.shape == jT.shape and tT.vec_len_cols == jT.vec_len_cols
    for jl, tl in list(zip(jh.levels, th.levels))[1:]:
        assert np.array_equal(tl.P.cols.numpy(), np.asarray(jl.P.cols))
        assert close(tl.A.vals, jl.A.vals) and close(tl.P.vals, jl.P.vals)
    assert close(th.coarse_inv, jh.coarse_inv, 1e-8)
    # the same setup without transfer_dia computes the same P
    plain = H.setup_hierarchy_device(tA, device="cpu",
                                     **dict(SETUP, transfer_dia=False))
    P = plain.levels[0].P
    ec = torch.from_numpy(np.random.default_rng(2).standard_normal(P.n_cols))
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(P.n_rows))
    assert close(tT.mv(ec), ell_spmv(P, ec).numpy())
    assert close(tT.mv_t(r), ell_spmv_t(P, r).numpy())
    with pytest.raises(ValueError, match="transfer_dia"):
        H.unpad_hierarchy(th)


def test_optimize_hierarchy_passes_transfer_dia_through(hierarchies):
    _, _, _, th = hierarchies
    for spec in (False, True):
        fast = H.optimize_hierarchy(th, gather_precision=0, specialize=spec,
                                    device="cpu")
        lev = fast.levels[0]
        assert isinstance(lev.P, H.TransferDia) and lev.Pt is None
        assert isinstance(lev.A, H.DiaMatrix)
        assert fast.n_fine == th.n_fine
        assert fast.n_level_true == th.n_level_true
        for D in (lev.P.P_dia, lev.P.Pt_dia, lev.A):
            if spec:
                assert D.offsets_static == tuple(D.offsets.tolist())
            else:
                assert D.offsets_static is None
        assert lev.P.P_dia.pack_blocked() is lev.P.P_dia
        assert torch.equal(lev.P.P_dia.dvals, th.levels[0].P.P_dia.dvals)


@pytest.mark.parametrize("fmt", ["as-built", "optimized", "specialized"])
def test_cycle_on_converted_reference_hierarchy_matches(hierarchies, fmt):
    jA, _, jh, _ = hierarchies
    th = H.hierarchy_from_numpy(flatten(jh), device="cpu")
    assert isinstance(th.levels[0].P, H.TransferDia)
    assert th.n_fine == jA.n_rows and th.n_level_true == jh.n_level_true
    if fmt != "as-built":
        th = H.optimize_hierarchy(th, specialize=fmt == "specialized",
                                  device="cpu")
    rng = np.random.default_rng(11)
    f = rng.standard_normal(jA.n_rows)  # true size: the cycle pads itself
    u0 = rng.standard_normal(jA.n_rows)
    j_sm = j_hier.make_smoother("chebyshev", 1.0, 2, 0.3)
    t_sm = H.make_smoother("chebyshev", 1.0, 2, 0.3)
    ref = np.asarray(j_hier.amg_cycle(jh, jnp.asarray(f), jnp.asarray(u0),
                                      smoother=j_sm))
    got = H.amg_cycle(th, torch.from_numpy(f), torch.from_numpy(u0),
                      smoother=t_sm)
    assert got.shape == (jA.n_rows,)
    assert close(got, ref, 1e-10)


def test_amg_pcg_with_transfer_dia_takes_the_reference_iterations(
        hierarchies, monkeypatch):
    """The optimized hierarchy (its TransferDia members compacted to row
    lists) takes the reference's PCG iteration count, once with the dense
    plain products (what mv runs on the CPU) and once with every compacted
    operator summed from its row list: the two give the same bits."""
    from hypre_tpu.krylov import pcg as j_pcg

    jA, tA, jh, th = hierarchies
    b = np.ones(jA.n_rows)
    j_sm = j_hier.make_smoother("chebyshev", 1.0, 2, 0.3)
    t_sm = H.make_smoother("chebyshev", 1.0, 2, 0.3)
    _, jinfo = j_pcg(jA.mv, jnp.asarray(b),
                     M=lambda r: j_hier.amg_cycle(jh, r, smoother=j_sm),
                     rtol=1e-8, maxiter=60)
    fast = H.optimize_hierarchy(th, specialize=True, device="cpu")
    T = fast.levels[0].P
    assert T.P_dia.r_ptr is not None and T.Pt_dia.r_ptr is not None

    def solve():
        return H.pcg(tA.mv, torch.from_numpy(b),
                     M=lambda r: H.amg_cycle(fast, r, smoother=t_sm),
                     rtol=1e-8, maxiter=60, device="cpu")

    x_dense, tinfo = solve()
    dense_mv = TDIA.DiaMatrix.mv
    used = []

    def rows_mv(self, x):
        if self.r_ptr is None:
            return dense_mv(self, x)
        used.append(self.D)
        return TDIA.dia_rows_plain(self.r_ptr, self.r_ids, self.r_vals,
                                   self.offsets_static, x, self.n_rows,
                                   self.n_cols, self.r_rows)

    monkeypatch.setattr(TDIA.DiaMatrix, "mv", rows_mv)
    x_rows, rinfo = solve()
    assert used and set(used) == {T.P_dia.D}
    assert bool(tinfo.converged) and bool(jinfo.converged)
    assert int(tinfo.iterations) == int(jinfo.iterations) <= 20
    assert int(rinfo.iterations) == int(tinfo.iterations)
    assert torch.equal(x_rows, x_dense)
