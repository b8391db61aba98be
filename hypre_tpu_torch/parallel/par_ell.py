"""ParEllMatrix: the distributed row-sharded sparse matrix.

Counterpart of ``hypre_tpu/parallel/par_ell.py`` (``hypre_ParCSRMatrix``,
``parcsr_mv/par_csr_matrix.h:27-86``). Each shard owns a contiguous
block of rows, split into

- ``diag``: entries whose column lives on the same shard (local column
  space),
- ``offd``: entries whose column lives elsewhere; where hypre keeps
  global indices plus ``col_map_offd``, the offd columns are rewritten at
  partition time to point straight into the halo receive buffer,
- a ``HaloSchedule`` (the CommPkg analogue) run as one ring exchange per
  neighbor offset.

Every tensor has a leading shard axis (the shards this process holds,
``mesh.local_shards``). A vector is the flat view of its (local_shards,
n_local) blocks, which on a local mesh is the reference's global padded
array, so the Krylov solvers and the AMG cycle run on it unchanged
(``mv``, ``mv_t``, ``vec_len_rows``, ``vec_len_cols``). The local products
are the ELL gathers and scatters the reference writes in plain ``jnp``:
one gather (or ``index_add_``) over every shard at once.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from hypre_tpu_torch.core.config import cdiv
from hypre_tpu_torch.core.partition import RowPartition
from hypre_tpu_torch.parallel.halo import build_halo_schedule
from hypre_tpu_torch.parallel.mesh import Mesh, row_sharding


@dataclasses.dataclass(frozen=True)
class ParEllMatrix:
    """Row-sharded ELL matrix over a 1-D shard mesh."""

    diag_vals: torch.Tensor  # (S, n_local, kd); S = the shards held
    diag_cols: torch.Tensor  # (S, n_local, kd) local col indices, -1 pad
    offd_vals: torch.Tensor  # (S, n_local, ko)
    offd_cols: torch.Tensor  # (S, n_local, ko) halo-buffer indices, -1 pad
    send_idx: torch.Tensor  # (S, M) local col-space pack map, -1 pad
    n_rows: int  # global, unpadded
    n_cols: int
    # the neighbor exchange schedule: ring offsets and per-offset tile sizes
    offsets: tuple
    sizes: tuple
    mesh: Mesh

    @property
    def num_shards(self) -> int:
        return self.mesh.num_shards

    @property
    def local_shards(self) -> int:
        return self.diag_vals.shape[0]

    @property
    def halo_starts(self) -> tuple:
        out, acc = [], 0
        for m in self.sizes:
            out.append(acc)
            acc += m
        return tuple(out)

    @property
    def recv_size(self) -> int:
        return int(self.send_idx.shape[1])

    def exchange_bytes(self) -> int:
        """Bytes one matvec exchange moves across the mesh (halo volume)."""
        return self.num_shards * self.recv_size * self.dtype.itemsize

    @property
    def n_row_local(self) -> int:
        return self.diag_vals.shape[1]

    @property
    def n_col_local(self) -> int:
        return cdiv(self.n_cols, self.num_shards)

    @property
    def dtype(self):
        return self.diag_vals.dtype

    @property
    def device(self) -> torch.device:
        return self.diag_vals.device

    # -- flat gather indices, built once (each shard's own block) -----------

    def _shard_base(self, stride: int) -> torch.Tensor:
        return torch.arange(self.local_shards, device=self.device) * stride

    @cached_property
    def diag_index(self) -> torch.Tensor:
        """Flat x index of every diag slot (padding clamped to its shard's
        first column: its value is 0)."""
        base = self._shard_base(self.n_col_local)[:, None, None]
        return (self.diag_cols.clamp(min=0) + base).long()

    @cached_property
    def offd_index(self) -> torch.Tensor:
        """Flat halo index of every offd slot."""
        base = self._shard_base(self.recv_size)[:, None, None]
        return (self.offd_cols.clamp(min=0) + base).long()

    @cached_property
    def send_index(self) -> torch.Tensor:
        """Flat x index of every pack slot."""
        base = self._shard_base(self.n_col_local)[:, None]
        return (self.send_idx.clamp(min=0) + base).long()

    # -- operator protocol (see EllMatrix) ----------------------------------

    @property
    def vec_len_rows(self) -> int:
        return self.local_shards * self.n_row_local

    @property
    def vec_len_cols(self) -> int:
        return self.local_shards * self.n_col_local

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return par_spmv(self, x)

    def mv_t(self, x: torch.Tensor) -> torch.Tensor:
        return par_spmv_t(self, x)


def exchange(mesh: Mesh, send: torch.Tensor, offsets, sizes) -> torch.Tensor:
    """Forward halo exchange: one ring shift per offset. ``send`` (S, M,
    ...) is the packed buffer grouped by offset; returns the (S, M, ...)
    halo buffer."""
    parts, start = [], 0
    for o, m in zip(offsets, sizes):
        parts.append(mesh.comm.shift(send[:, start: start + m], o))
        start += m
    return torch.cat(parts, dim=1) if parts else send[:, :0]


def exchange_rev(mesh: Mesh, contrib: torch.Tensor, offsets,
                 sizes) -> torch.Tensor:
    """Reverse (transpose, accumulate) exchange: each offset block goes
    back to its source, hypre's reverse-comm job (CommHandle job=2)."""
    parts, start = [], 0
    for o, m in zip(offsets, sizes):
        parts.append(mesh.comm.shift(contrib[:, start: start + m], -o))
        start += m
    return torch.cat(parts, dim=1) if parts else contrib[:, :0]


def _check_len(x: torch.Tensor, n: int, what: str) -> None:
    if x.shape[0] != n:
        raise ValueError(f"{what}: x has {x.shape[0]} rows, the shards held "
                         f"take {n}")


def par_spmv(A: ParEllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with x split by A's column partition: the diag product,
    the pack gather, the ring exchange and the offd product on the halo."""
    _check_len(x, A.vec_len_cols, "par_spmv")
    y = (A.diag_vals * x[A.diag_index]).sum(dim=-1)
    if A.sizes:  # a halo exists (more than one shard, coupled blocks)
        halo = exchange(A.mesh, x[A.send_index], A.offsets, A.sizes)
        y = y + (A.offd_vals * halo.reshape(-1)[A.offd_index]).sum(dim=-1)
    return y.reshape(-1)


def _scatter_t(vals, cols, index, xs, n_out: int) -> torch.Tensor:
    contrib = torch.where(cols >= 0, vals * xs[:, :, None],
                          torch.zeros_like(vals))
    y = torch.zeros(n_out, dtype=contrib.dtype, device=contrib.device)
    return y.index_add_(0, index.reshape(-1), contrib.reshape(-1))


def par_spmv_t(A: ParEllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A.T @ x: the local transposes, and the offd contributions sent
    back to their columns' owners by the reverse exchange and added there
    (hypre's MatvecT reverse comm, ``par_csr_matvec.c:412``)."""
    _check_len(x, A.vec_len_rows, "par_spmv_t")
    S, ncl, M = A.local_shards, A.n_col_local, A.recv_size
    xs = x.reshape(S, A.n_row_local)
    y = _scatter_t(A.diag_vals, A.diag_cols, A.diag_index, xs, S * ncl)
    if not A.sizes:
        return y
    contrib = _scatter_t(A.offd_vals, A.offd_cols, A.offd_index, xs, S * M)
    back = exchange_rev(A.mesh, contrib.reshape(S, M), A.offsets, A.sizes)
    # padding slots land on one extra slot past the end, which is dropped
    dst = torch.where(A.send_idx >= 0, A.send_index,
                      torch.full_like(A.send_index, S * ncl))
    y = torch.cat([y, y.new_zeros(1)])
    return y.index_add_(0, dst.reshape(-1), back.reshape(-1))[:-1]


# ---------------------------------------------------------------------------
# Partitioning (host-side setup, numpy)
# ---------------------------------------------------------------------------


def _compact_rows_np(vals: np.ndarray, cols: np.ndarray, keep: np.ndarray):
    """Left-compact kept entries per row, in slot order; shrink to the
    widest row. The kept entries in row-major order are already in that
    order; each goes to its row's start plus its rank, so no sort is
    needed."""
    n = keep.shape[0]
    counts = keep.sum(axis=1)
    width = max(int(counts.max(initial=0)), 1)
    first = np.cumsum(counts) - counts  # each row's first kept entry
    dest = np.arange(int(counts.sum())) + np.repeat(
        np.arange(n) * width - first, counts)
    cols_s = np.full(n * width, -1, cols.dtype)
    vals_s = np.zeros(n * width, vals.dtype)
    cols_s[dest] = cols[keep]
    vals_s[dest] = vals[keep]
    return vals_s.reshape(n, width), cols_s.reshape(n, width)


def rewrite_offd(offd_cols_g: np.ndarray, recv_pos: list,
                 n_local: int) -> np.ndarray:
    """Global offd columns -> positions in each shard's receive buffer."""
    out = np.full(offd_cols_g.shape, -1, dtype=np.int32)
    for p, pos in enumerate(recv_pos):
        if not pos:
            continue
        sl = slice(p * n_local, (p + 1) * n_local)
        block = offd_cols_g[sl]
        keys = np.fromiter(pos.keys(), dtype=np.int64, count=len(pos))
        where = np.fromiter(pos.values(), dtype=np.int32, count=len(pos))
        order = np.argsort(keys)
        keys, where = keys[order], where[order]
        idx = np.searchsorted(keys, np.maximum(block, 0))
        out[sl] = np.where(block >= 0,
                           where[np.clip(idx, 0, len(keys) - 1)], -1)
    return out


def assemble_par(diag_vals, diag_cols, offd_vals, offd_cols_g, row_part,
                 col_part, n_rows: int, n_cols: int,
                 mesh: Mesh) -> ParEllMatrix:
    """The halo schedule, the offd rewrite and the placement of the
    (n_padded, k) global diag/offd blocks (offd in global columns)."""
    nl = row_part.n_local
    offd_sets = []
    for p in range(mesh.num_shards):
        block = offd_cols_g[p * nl: (p + 1) * nl]
        offd_sets.append(np.unique(block[block >= 0]))
    sched = build_halo_schedule(offd_sets, col_part)
    offd_cols = rewrite_offd(offd_cols_g, sched.recv_pos, nl)
    rows = row_sharding(mesh)
    return ParEllMatrix(
        diag_vals=rows.put(diag_vals),
        diag_cols=rows.put(diag_cols.astype(np.int32)),
        offd_vals=rows.put(offd_vals),
        offd_cols=rows.put(offd_cols),
        send_idx=rows.put(sched.send_idx).reshape(mesh.local_shards, -1),
        n_rows=int(n_rows), n_cols=int(n_cols),
        offsets=sched.offsets, sizes=sched.sizes, mesh=mesh)


def split_global(vals: np.ndarray, cols: np.ndarray, row_part: RowPartition,
                 col_part: RowPartition):
    """(n_padded, k) global rows -> the diag block (local columns) and the
    offd block (global columns), each left-compacted to its widest row."""
    # a column is in the diag block when it lies in the row owner's column
    # range; its offset there is its local index (padding falls below)
    ncl = col_part.n_local
    lo = (np.arange(cols.shape[0]) // row_part.n_local * ncl).astype(
        cols.dtype)
    rel = cols - lo[:, None]
    is_diag = (rel >= 0) & (rel < ncl)
    diag_vals, diag_cols = _compact_rows_np(vals, rel, is_diag)
    offd_vals, offd_cols_g = _compact_rows_np(vals, cols,
                                              (cols >= 0) & ~is_diag)
    return diag_vals, diag_cols, offd_vals, offd_cols_g


def partition_ell(A, mesh: Mesh,
                  col_part: RowPartition | None = None) -> ParEllMatrix:
    """Split a global EllMatrix across a 1-D shard mesh: the diag/offd
    split, col_map_offd and the CommPkg of ``par_csr_matrix.c`` +
    ``new_commpkg.c``, in vectorized numpy on the host. Every process
    partitions the same global matrix and keeps its own shards."""
    row_part = RowPartition(A.n_rows, mesh.num_shards)
    col_part = col_part or RowPartition(A.n_cols, mesh.num_shards)
    vals = A.vals.cpu().numpy()
    cols = A.cols.cpu().numpy()
    n, k = cols.shape
    pad = row_part.n_padded - n
    if pad > 0:
        vals = np.concatenate([vals, np.zeros((pad, k), vals.dtype)])
        cols = np.concatenate([cols, np.full((pad, k), -1, cols.dtype)])
    return assemble_par(*split_global(vals, cols, row_part, col_part),
                        row_part, col_part, A.n_rows, A.n_cols, mesh)


def distribute_vector(x, mesh: Mesh, n_global: int | None = None,
                      dtype=None) -> torch.Tensor:
    """Pad a global vector (numpy or tensor) to the sharded length and
    keep this process's shards, flat, on the mesh's device."""
    n_global = n_global or x.shape[0]
    part = RowPartition(n_global, mesh.num_shards)
    pad = part.n_padded - x.shape[0]
    if isinstance(x, torch.Tensor):
        if pad > 0:
            x = torch.cat([x, x.new_zeros(pad)])
    else:
        x = np.asarray(x)
        if pad > 0:
            x = np.concatenate([x, np.zeros(pad, x.dtype)])
    return row_sharding(mesh).put(x, dtype).reshape(-1)


def collect_vector(x: torch.Tensor, n_global: int,
                   mesh: Mesh | None = None) -> np.ndarray:
    """The global vector on the host, padding dropped. On a ``dist`` mesh
    (pass it) every process gathers all shards."""
    if mesh is not None and mesh.comm.backend == "dist":
        x = mesh.comm.all_gather(x.reshape(mesh.local_shards, -1))
    return x.detach().cpu().numpy().reshape(-1)[:n_global]
