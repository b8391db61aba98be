"""Distributed AMG hierarchy setup: strength, PMIS, ext+i and RAP on
row-sharded operators, without assembling the global matrix.

Counterpart of ``hypre_tpu/parallel/par_setup.py``: the BoomerAMG setup
pipeline (``parcsr_ls/par_amg_setup.c:28``) on a ParEllMatrix that is
already split across the mesh.

- **Extended local matrix** (the ``hypre_ParCSRMatrixExtractBExt``
  idea): each shard's diag and offd blocks concatenate into one local ELL
  whose columns are [0, n_local) ∪ halo positions. Data living on
  neighbor shards (strength counts, measures, CF marks, ext+i payloads,
  P rows) comes over by one forward halo exchange per quantity, after
  which the slab helpers of ``amg/device_setup.py`` run unchanged.
- **One launch for all shards.** The reference runs each phase as a
  ``shard_map`` body; here the shards this process holds are a batch
  axis. Their extended column spaces are stacked (shard p's local column
  c at p * n_local + c, its halo position h at S * n_local + p * M + h),
  so the slab helpers see one matrix whose rows keep their diagonals and
  each gather reads its own shard.
- **Boundary-correct PMIS** (``par_coarsen.c:2813``): each round exchanges
  the measure, returns the column-side maxima to their owners (max
  combined at the source) and exchanges the fresh CF marks, so the split
  is exactly the single-device PMIS (the same hash tie-breaks on global
  row ids). One host read of the round's flag, as the device setup does.
- **Distributed RAP** (``par_csr_triplemat.c:196``): AP is local (with
  P's halo rows), and each owned coarse row is one product of its P^T row
  with the AP rows it names, the halo's fetched over P^T's schedule
  (``hypre_ParCSRMatrixExtractBExt``). The reference ships partial coarse
  rows to their owners instead (``par_rap_communication.c``).
- **The single-device sums.** Every row's slots are kept in global column
  order, as the single-device setup keeps them, so each sum adds the same
  terms in the same order: the distributed hierarchy is the device
  setup's (``setup_hierarchy_device``), bit for bit. Near-ties in the
  truncation and the strength cap make any other order drift from it on
  large grids.

The per-level CommPkg construction (diag/offd split and halo schedules of
P and A_c) is host numpy over the shards' blocks, the setup-phase work
hypre does in ``new_commpkg.c``.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from hypre_tpu_torch.amg.device_setup import (
    _nchunks, ext_plus_i_device, extpi_pack_sources, spgemm_slab,
    strength_and_cap,
)
from hypre_tpu_torch.amg.hierarchy import AMGHierarchy, Level
from hypre_tpu_torch import native
from hypre_tpu_torch.core.config import PAD_COL, fold_sum, hash_rand01
from hypre_tpu_torch.core.partition import RowPartition
from hypre_tpu_torch.parallel.comm import host_blocks
from hypre_tpu_torch.parallel.mesh import Mesh
from hypre_tpu_torch.parallel.par_amg import pad_coarse_inverse
from hypre_tpu_torch.parallel.par_ell import (
    ParEllMatrix, assemble_par, exchange, exchange_rev, split_global,
)
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.slabops import _BIG, sort_slab

C_PT = 1
F_PT = -1


# ---------------------------------------------------------------------------
# The stacked extended column space and the halo moves
# ---------------------------------------------------------------------------


def _stacked(cols: torch.Tensor, n_local: int, m: int) -> torch.Tensor:
    """Per-shard extended columns (S, n, k) ([0, n_local) local, then
    halo positions) -> stacked columns: shard p's local c at
    p * n_local + c, its halo h at S * n_local + p * m + h."""
    S = cols.shape[0]
    p = torch.arange(S, device=cols.device).view(S, *([1] * (cols.dim() - 1)))
    out = torch.where(cols < n_local, cols + p * n_local,
                      S * n_local + p * m + (cols - n_local))
    return torch.where(cols >= 0, out, torch.full_like(out, PAD_COL))


def _stack(local: torch.Tensor, halo: torch.Tensor) -> torch.Tensor:
    """(S, n_local, ...) and (S, M, ...) -> the stacked (S*(n_local + M),
    ...) array over the extended column space."""
    return torch.cat([local.reshape((-1,) + tuple(local.shape[2:])),
                      halo.reshape((-1,) + tuple(halo.shape[2:]))])


def _ext_matrix(A: ParEllMatrix):
    """The extended local ELL of every shard: diag ⊕ offd, offd columns
    past the local ones (S, n_local, kd + ko), in each shard's extended
    numbering."""
    ocols = torch.where(A.offd_cols >= 0, A.offd_cols + A.n_col_local,
                        torch.full_like(A.offd_cols, PAD_COL))
    return (torch.cat([A.diag_vals, A.offd_vals], dim=2),
            torch.cat([A.diag_cols, ocols], dim=2))


def _sorted_ext(A: ParEllMatrix):
    """Every shard's extended rows with the slots in GLOBAL column order,
    padding last: (vals, extended columns, global columns), each (S,
    n_local, kd + ko). The single-device setup keeps its rows in column
    order and its sums run in slot order; the same order here makes the
    distributed setup's sums the same adds."""
    vals, cols = _ext_matrix(A)
    gcols = _global_cols(A)
    S, n, k = cols.shape
    key = torch.where(gcols >= 0, gcols, torch.full_like(gcols, _BIG))
    _, v, c, g = sort_slab(key.reshape(S * n, k), vals.reshape(S * n, k),
                           cols.reshape(S * n, k), gcols.reshape(S * n, k))
    return v.reshape(S, n, k), c.reshape(S, n, k), g.reshape(S, n, k)


def _ext_ell(A: ParEllMatrix):
    """``_sorted_ext`` in the stacked numbering, as one EllMatrix, and its
    global columns (flat)."""
    vals, cols, gcols = _sorted_ext(A)
    S, n, k = cols.shape
    sc = _stacked(cols, A.n_col_local, A.recv_size)
    return (EllMatrix(vals=vals.reshape(S * n, k), cols=sc.reshape(S * n, k),
                      n_cols=S * (A.n_col_local + A.recv_size)),
            gcols.reshape(S * n, k))


def _fetch(A: ParEllMatrix, payload: torch.Tensor) -> torch.Tensor:
    """Forward halo fetch of per-row payloads (S, n_col_local, ...) ->
    (S, M, ...). Padding pack slots ship row 0's data; nobody reads them.
    An empty schedule (one shard) gives an all-zero halo of width M."""
    S, M = A.local_shards, A.recv_size
    rest = tuple(payload.shape[2:])
    if not A.sizes:
        return payload.new_zeros((S, M) + rest)
    flat = payload.reshape((-1,) + rest)
    return exchange(A.mesh, flat[A.send_index], A.offsets, A.sizes)


def _return(A: ParEllMatrix, local: torch.Tensor, tail: torch.Tensor,
            combine: str) -> torch.Tensor:
    """Reverse exchange of the halo tail (S, M), combined into the local
    rows (S, n_col_local) at the pack positions (hypre's reverse-comm
    accumulate, "add" or "max"). Padding slots land past the end and are
    dropped."""
    if not A.sizes:
        return local
    S, ncl = local.shape
    back = exchange_rev(A.mesh, tail, A.offsets, A.sizes).reshape(-1)
    dst = torch.where(A.send_idx >= 0, A.send_index,
                      torch.full_like(A.send_index, S * ncl)).reshape(-1)
    ext = torch.cat([local.reshape(-1), local.new_zeros(1)])
    if combine == "add":
        ext = ext.index_add_(0, dst, back)
    else:
        ext = ext.scatter_reduce_(0, dst, back, "amax", include_self=True)
    return ext[:-1].reshape(S, ncl)


def _split_ext(A: ParEllMatrix, v: torch.Tensor):
    """A stacked extended-space vector -> (local (S, n_col_local), tail
    (S, M))."""
    S, ncl = A.local_shards, A.n_col_local
    return v[: S * ncl].reshape(S, ncl), v[S * ncl:].reshape(S, A.recv_size)


def _global_cols(A: ParEllMatrix) -> torch.Tensor:
    """Every slot's GLOBAL column, (S, n_local, kd + ko): the diag columns
    plus the shard's column base, the offd ones through the owners' ids
    fetched over the halo."""
    ncl = A.n_col_local
    base = A.mesh.comm.shard_ids(A.device)[:, None] * ncl
    gids = (torch.arange(ncl, device=A.device)[None, :] + base).to(
        torch.int32)
    halo = _fetch(A, gids)
    pad = torch.full_like(A.offd_cols, PAD_COL)
    return torch.cat([
        torch.where(A.diag_cols >= 0, A.diag_cols + base[:, :, None].to(
            torch.int32), torch.full_like(A.diag_cols, PAD_COL)),
        torch.where(A.offd_cols >= 0, halo.reshape(-1)[A.offd_index], pad),
    ], dim=2)


# ---------------------------------------------------------------------------
# The phases
# ---------------------------------------------------------------------------


def hmis_interior_seeds(A: ParEllMatrix, theta: float) -> torch.Tensor:
    """Per-shard Ruge-Stüben first pass on the processor-interior graph
    (the diag block only), returning the C seeds for the boundary PMIS
    pass: hypre's HMIS (De Sterck/Yang/Heys; ``par_coarsen.c:2846``).
    Host C++ per shard, as in hypre (HMIS has no device path there
    either)."""
    dv = A.diag_vals.cpu().numpy()
    dc = A.diag_cols.cpu().numpy()
    seeds = np.zeros(dv.shape[:2], np.int32)
    n_l = dv.shape[1]
    for p in range(dv.shape[0]):
        valid = dc[p] >= 0
        Ap = np.zeros(n_l + 1, np.int32)
        np.cumsum(valid.sum(axis=1), out=Ap[1:])
        Aj = dc[p][valid].astype(np.int32)
        Ax = dv[p][valid].astype(np.float64)
        S = native.strength(n_l, Ap, Aj, Ax, float(theta))
        seeds[p] = (np.asarray(native.rs(n_l, Ap, Aj, S)) == 1)
    return torch.from_numpy(seeds.reshape(-1)).to(A.device)


def par_split_phase(A: ParEllMatrix, theta: float, s_cap: int,
                    seed_c: torch.Tensor | None = None):
    """Strength, boundary-correct PMIS and the global coarse numbering.

    ``seed_c`` (int32 per local row, 1 = C) fixes C points before the
    PMIS rounds: the HMIS composition (``hmis_interior_seeds`` + boundary
    PMIS).

    Returns (scols, svals, cf, cmap, n_c): the capped strong slab (S,
    n_local, ks) in the stacked extended numbering, the CF splitting and
    cmap (cmap[i] = global coarse index of local row i if C, else -1) as
    flat vectors over the local rows, and the global coarse count.
    """
    comm, dev = A.mesh.comm, A.device
    S, n_l, ncl, M = A.local_shards, A.n_row_local, A.n_col_local, \
        A.recv_size
    n_ext = S * (ncl + M)
    Aloc, gcols = _ext_ell(A)
    kcap = min(s_cap, Aloc.k)
    # global column ids break the cap's ties as the single-device path
    # does, and put the capped slab back in global column order
    _, scols, svals, _ = strength_and_cap(Aloc, float(theta), kcap,
                                          tie_cols=gcols)
    g = comm.shard_ids(dev)
    own = (torch.arange(ncl, device=dev)[None, :] + g[:, None] * ncl).to(
        torch.int32)
    gmap = _stack(own, _fetch(A, own))
    skey = torch.where(scols >= 0, gmap[scols.clamp(min=0).long()],
                       torch.full_like(scols, _BIG))
    _, scols, svals = sort_slab(skey, scols, svals)
    Sm = scols >= 0
    scols_l = scols.clamp(min=0).long()
    strong_rows, strong_slots = Sm.nonzero(as_tuple=True)
    strong_cols = scols[strong_rows, strong_slots].long()

    # S^T counts, the boundary's accumulated at the owners
    cnt = torch.bincount(strong_cols, minlength=n_ext).to(torch.int32)
    st = _return(A, *_split_ext(A, cnt), "add").reshape(-1)
    rows_global = (torch.arange(n_l, device=dev)[None, :]
                   + g[:, None] * n_l).reshape(-1)
    measure = st.to(torch.float32) + hash_rand01(rows_global)
    isolated = ~Sm.any(dim=1) & (st == 0)
    cf = torch.where(isolated, F_PT, 0).to(torch.int32)

    def ext_of(v):
        return _stack(v.reshape(S, n_l), _fetch(A, v.reshape(S, n_l)))

    def depends_on_c(cf):
        return (Sm & (ext_of(cf)[scols_l] == C_PT)).any(dim=1)

    if seed_c is not None:
        # HMIS: interior-RS C points enter fixed, and their strong
        # dependents are marked F before the first independent-set round
        cf = torch.where(seed_c.reshape(-1) == 1, C_PT, cf).to(torch.int32)
        cf = torch.where((cf == 0) & depends_on_c(cf), F_PT, cf).to(
            torch.int32)

    def any_undecided(cf):
        return bool(comm.max((cf == 0).reshape(S, n_l).any(dim=1).to(
            torch.int32)).item())

    go = any_undecided(cf)
    while go:
        prev = cf
        undecided = cf == 0
        m = torch.where(undecided, measure, torch.zeros_like(measure))
        row_nbr_max = torch.where(Sm, ext_of(m)[scols_l],
                                  torch.zeros((), device=dev)).amax(dim=1)
        colmax = torch.zeros(n_ext, dtype=m.dtype, device=dev).scatter_reduce_(
            0, strong_cols, m[strong_rows], "amax", include_self=True)
        col_nbr_max = _return(A, *_split_ext(A, colmax), "max").reshape(-1)
        nbr_max = torch.maximum(row_nbr_max, col_nbr_max)
        new_c = undecided & (m > nbr_max) & (m > 0)
        cf = torch.where(new_c, C_PT, cf).to(torch.int32)
        cf = torch.where((cf == 0) & depends_on_c(cf), F_PT, cf).to(
            torch.int32)
        cf = torch.where((cf == 0) & isolated, F_PT, cf).to(torch.int32)
        # stall guard: a round that changed nothing on any shard turns
        # every undecided point into C
        stalled = comm.min((cf == prev).reshape(S, n_l).all(dim=1).to(
            torch.int32)) > 0
        cf = torch.where(stalled & (cf == 0), C_PT, cf).to(torch.int32)
        go = any_undecided(cf)

    # global coarse numbering: exclusive scan of the per-shard counts
    is_c = (cf == C_PT).reshape(S, n_l)
    local_count = is_c.sum(dim=1, dtype=torch.int32)
    counts = comm.all_gather(local_count)
    offset = (torch.cumsum(counts, 0) - counts)[g]
    cmap = torch.where(
        is_c, offset[:, None] + torch.cumsum(is_c, 1, dtype=torch.int32) - 1,
        -1).to(torch.int32).reshape(-1)
    n_c = int(comm.sum(local_count).sum().item())
    ks = scols.shape[1]
    return (scols.reshape(S, n_l, ks), svals.reshape(S, n_l, ks), cf, cmap,
            n_c)


def par_interp_phase(A: ParEllMatrix, scols, svals, cf, cmap, out_k: int,
                     p_max_elmts: int, trunc_factor: float):
    """ext+i on the extended local matrix; P's columns come out in the
    GLOBAL coarse numbering. ``scols`` is ``par_split_phase``'s slab
    (stacked numbering). Returns (pc, pv) as (S, n_local, out_k) and the
    width the merge needed (the max over shards)."""
    S, n_l = A.local_shards, A.n_row_local
    Aloc, _ = _ext_ell(A)
    ks = scols.shape[2]
    sc = scols.reshape(S * n_l, ks)
    sv = svals.reshape(S * n_l, ks)
    diag = Aloc.diagonal()
    sgn = torch.where(diag >= 0, 1.0, -1.0).to(Aloc.dtype)

    def ext_of(v):
        return _stack(v.reshape((S, n_l) + tuple(v.shape[1:])),
                      _fetch(A, v.reshape((S, n_l) + tuple(v.shape[1:]))))

    is_c_ext = ext_of(cf == C_PT)
    cmap_ext = ext_of(cmap)
    pf_loc, pi_loc = extpi_pack_sources(sc, sv, sgn, is_c_ext, cmap_ext)
    cand1 = torch.where(sc >= 0, cmap_ext[sc.clamp(min=0).long()],
                        torch.full_like(sc, PAD_COL))
    pc, pv, req = ext_plus_i_device(
        Aloc, sc, sv, cf, out_k, p_max_elmts=p_max_elmts,
        trunc_factor=trunc_factor,
        col_sources=(is_c_ext, ext_of(pf_loc), ext_of(pi_loc), ext_of(sgn)),
        out_cols=(cand1, cmap), chunks=_nchunks(S * n_l, ks * ks + ks + 1))
    req = int(A.mesh.comm.max(req.reshape(1)).item())
    return pc.reshape(S, n_l, -1), pv.reshape(S, n_l, -1), req


def par_rap_phase(A: ParEllMatrix, Ppar: ParEllMatrix, Ptpar: ParEllMatrix,
                  out_ap: int, out_ac: int):
    """A_c = P^T (A P), distributed: AP is local, with P's rows for A's
    halo columns fetched over A's schedule; each owned coarse row is then
    one product of its P^T row with the AP rows it names, those of the
    halo fetched over P^T's schedule (hypre's
    ``hypre_ParCSRMatrixExtractBExt``). The reference instead builds
    partial coarse rows and ships them to their owners
    (``par_rap_communication.c``); fetching AP rows keeps every sum in the
    single-device setup's order, so the two setups build the same
    operators. Returns the local A_c rows (S, nc_local, out_ac) with GLOBAL
    coarse columns, and the widths the AP and RAP merges needed (max over
    shards)."""
    comm = A.mesh.comm
    S, n_l = A.local_shards, A.n_row_local
    Aloc, _ = _ext_ell(A)

    def global_max(r):
        return int(comm.max(r.reshape(1)).item())

    # P's rows in global coarse column order, with those of A's halo rows
    p_vals, _, p_gcols = _sorted_ext(Ppar)
    kp = p_gcols.shape[2]
    pg_ext = _stack(p_gcols, _fetch(A, p_gcols))
    pv_ext = _stack(p_vals, _fetch(A, p_vals))
    apc, apv, req_ap = spgemm_slab(Aloc.cols, Aloc.vals, pg_ext, pv_ext,
                                   out_ap,
                                   chunks=_nchunks(S * n_l, Aloc.k * kp))
    ra = global_max(req_ap)
    if ra <= out_ap:
        # a merge that fit is left-aligned: past its need there is only
        # padding, which the next product would carry as candidates
        apc, apv = apc[:, : max(ra, 1)], apv[:, : max(ra, 1)]
    w = apc.shape[1]
    apc, apv = apc.reshape(S, n_l, w), apv.reshape(S, n_l, w)
    t_vals, t_cols, _ = _sorted_ext(Ptpar)
    ncc, kt = Ptpar.n_row_local, t_cols.shape[2]
    tc = _stacked(t_cols, Ptpar.n_col_local, Ptpar.recv_size)
    acc, acv, req_ac = spgemm_slab(
        tc.reshape(S * ncc, kt), t_vals.reshape(S * ncc, kt),
        _stack(apc, _fetch(Ptpar, apc)), _stack(apv, _fetch(Ptpar, apv)),
        out_ac, chunks=_nchunks(S * ncc, kt * w))
    return (acc.reshape(S, ncc, -1), acv.reshape(S, ncc, -1), ra,
            global_max(req_ac))


# ---------------------------------------------------------------------------
# Host-side per-level CommPkg construction (new_commpkg.c analogue)
# ---------------------------------------------------------------------------


def _par_from_global_np(cols: np.ndarray, vals: np.ndarray, n_rows: int,
                        n_cols: int, mesh: Mesh) -> ParEllMatrix:
    """ParEllMatrix from the (n_padded, k) blocks of every shard, columns
    GLOBAL: the diag/offd split and the halo schedule, on the host."""
    row_part = RowPartition(n_rows, mesh.num_shards)
    col_part = RowPartition(n_cols, mesh.num_shards)
    parts = split_global(vals, cols, row_part, col_part)
    return assemble_par(*parts, row_part, col_part, n_rows, n_cols, mesh)


def par_from_global_cols(cols: torch.Tensor, vals: torch.Tensor,
                         n_rows: int, n_cols: int,
                         mesh: Mesh) -> ParEllMatrix:
    """A ParEllMatrix from row-sharded blocks (S, n_local, k) whose columns
    are GLOBAL indices. Per-shard numpy (diag/offd split + halo schedule),
    the CommPkg build; no global matrix is assembled on the device."""
    k = cols.shape[2]
    c = host_blocks(mesh.comm, cols.cpu().numpy()).reshape(-1, k)
    v = host_blocks(mesh.comm, vals.cpu().numpy()).reshape(-1, k)
    return _par_from_global_np(c, v, n_rows, n_cols, mesh)


def _host_global(A: ParEllMatrix):
    """Every shard's rows with GLOBAL columns, on the host: (P * n_local,
    k) columns and values."""
    gc = _global_cols(A)
    vals = torch.cat([A.diag_vals, A.offd_vals], dim=2)
    k = gc.shape[2]
    return (host_blocks(A.mesh.comm, gc.cpu().numpy()).reshape(-1, k),
            host_blocks(A.mesh.comm, vals.cpu().numpy()).reshape(-1, k))


def _transpose_sharded(Ppar: ParEllMatrix, n_coarse: int):
    """P^T (coarse rows, global fine columns) as the coarse partition's
    padded (n_padded, kT) blocks, on the host: hypre's CommPkg-class setup
    work."""
    cols, vals = _host_global(Ppar)
    keep = cols >= 0
    rows_t = cols[keep].astype(np.int64)
    cols_t = np.nonzero(keep)[0].astype(np.int64)
    vals_t = vals[keep]
    order = np.lexsort((cols_t, rows_t))
    rows_t, cols_t, vals_t = rows_t[order], cols_t[order], vals_t[order]
    n_pad = RowPartition(n_coarse, Ppar.num_shards).n_padded
    counts = np.bincount(rows_t, minlength=n_pad)
    kT = max(int(counts.max(initial=0)), 1)
    tp_c = np.full((n_pad, kT), -1, np.int32)
    tp_v = np.zeros((n_pad, kT), vals.dtype)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(len(rows_t)) - starts[rows_t]
    tp_c[rows_t, within] = cols_t
    tp_v[rows_t, within] = vals_t
    return tp_c, tp_v


def _gather_dense(A: ParEllMatrix) -> np.ndarray:
    """The (small) coarsest operator, dense, on the host."""
    cols, vals = _host_global(A)
    dense = np.zeros((A.n_rows, A.n_cols), np.float64)
    r, s = np.nonzero(cols[: A.n_rows] >= 0)
    np.add.at(dense, (r, cols[r, s]), vals[r, s])
    return dense


def _par_level_vectors(A: ParEllMatrix):
    """1/diag and 1/l1-norm of every local row (flat vectors), summed in
    global column order as the single-device setup sums them."""
    vals, _, gcols = _sorted_ext(A)
    rows = (torch.arange(A.n_row_local, device=A.device)[None, :]
            + A.mesh.comm.shard_ids(A.device)[:, None] * A.n_row_local)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    diag = fold_sum(torch.where(gcols == rows[:, :, None], vals, zero), 2)
    l1 = fold_sum(vals.abs(), 2)
    nz = diag != 0
    dinv = torch.where(nz, 1.0 / torch.where(nz, diag, 1.0), zero)
    l1inv = 1.0 / torch.where(l1 > 0, l1, 1.0)
    return dinv.reshape(-1), l1inv.reshape(-1)


# ---------------------------------------------------------------------------
# The distributed setup driver
# ---------------------------------------------------------------------------


def setup_hierarchy_par(
    A: ParEllMatrix,
    strength_threshold: float = 0.25,
    max_levels: int = 25,
    max_coarse_size: int = 64,
    p_max_elmts: int = 4,
    trunc_factor: float = 0.0,
    coarsen_rtol: float = 0.9,
    s_cap: int = 12,
    coarsen: str = "pmis",
    level_stats: list | None = None,
) -> AMGHierarchy:
    """Distributed hypre_BoomerAMGSetup on an already-split operator.

    coarsen: 'pmis' (boundary-correct distributed PMIS, the scope of
    hypre's device coarsening, ``par_coarsen_device.c``) or 'hmis'
    (per-shard interior Ruge-Stüben first pass + boundary PMIS over its
    seeds, ``par_coarsen.c:2846``).

    Every level's A, P and Pt come out as ParEllMatrix over the same mesh,
    so ``amg_cycle`` and the smoothers run the solve distributed. The
    smoother vectors are l1-Jacobi's (row-local norms); lmax is 0
    (Chebyshev's estimate would need distributed products).

    level_stats: when a list, one dict per level is appended: its rows,
    coarse rows, host seconds and the RAP widths the retry loop ended at.
    A product that overflows its width runs again at the widths the run
    reported, until every merge fits (the reference stops after three
    runs, which could keep a truncated product).
    """
    if coarsen not in ("pmis", "hmis"):
        raise ValueError(f"setup_hierarchy_par coarsens by 'pmis' or "
                         f"'hmis', not {coarsen!r}")
    mesh = A.mesh
    levels: List[Level] = []
    A_cur = A
    sync = (torch.cuda.synchronize if A.device.type == "cuda"
            else (lambda: None))

    while len(levels) < max_levels - 1 and A_cur.n_rows > max_coarse_size:
        t0 = time.perf_counter()
        seeds = (hmis_interior_seeds(A_cur, strength_threshold)
                 if coarsen == "hmis" else None)
        scols, svals, cf, cmap, n_coarse = par_split_phase(
            A_cur, strength_threshold, s_cap, seed_c=seeds)
        if n_coarse == 0 or n_coarse >= coarsen_rtol * A_cur.n_rows:
            break
        ks = scols.shape[2]
        out_k = min(max(2 * ks, 8), 64)
        pc, pv, _ = par_interp_phase(A_cur, scols, svals, cf, cmap, out_k,
                                     p_max_elmts, float(trunc_factor))
        Ppar = par_from_global_cols(pc, pv, A_cur.n_rows, n_coarse, mesh)
        # Pt as its own distributed operator: the restriction product, and
        # the rows of the Galerkin product
        tp_c, tp_v = _transpose_sharded(Ppar, n_coarse)
        Ptpar = _par_from_global_np(tp_c, tp_v, n_coarse, A_cur.n_rows, mesh)

        kA = A_cur.diag_vals.shape[2] + A_cur.offd_vals.shape[2]
        out_ap = min(kA * Ppar.diag_vals.shape[2] * 2 + 8, 96)
        out_ac = max(3 * kA, 32)
        while True:  # the widths grow to what the products report
            acc, acv, ra, rc = par_rap_phase(A_cur, Ppar, Ptpar, out_ap,
                                             out_ac)
            if ra <= out_ap and rc <= out_ac:
                break
            out_ap, out_ac = max(out_ap, ra), max(out_ac, rc)
        A_next = par_from_global_cols(acc, acv, n_coarse, n_coarse, mesh)
        dinv, l1inv = _par_level_vectors(A_cur)
        levels.append(Level(
            A=A_cur, P=Ppar, Pt=Ptpar, dinv=dinv, l1inv=l1inv,
            lmax=torch.zeros((), dtype=A_cur.dtype, device=A_cur.device)))
        if level_stats is not None:
            sync()
            level_stats.append({
                "n": A_cur.n_rows, "n_coarse": n_coarse,
                "seconds": time.perf_counter() - t0,
                "widths": {"ap": out_ap, "pt": Ptpar.diag_vals.shape[2]
                           + Ptpar.offd_vals.shape[2], "ac": out_ac}})
        A_cur = A_next

    # coarsest: gather the (small) operator and invert it, replicated, as
    # hypre's par_gauss_elim.c:84-118 gathers to a subcommunicator
    inv = np.linalg.pinv(_gather_dense(A_cur), rcond=1e-10)
    dt = A_cur.diag_vals.cpu().numpy().dtype
    return AMGHierarchy(levels=levels,
                        coarse_inv=pad_coarse_inverse(inv.astype(dt), mesh),
                        galerkin=True)
