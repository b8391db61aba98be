"""Halo-exchange schedule construction: the CommPkg analogue.

Counterpart of ``hypre_tpu/parallel/halo.py``. hypre's
``hypre_ParCSRCommPkg`` (``parcsr_mv/par_csr_communication.h:51-75``) is
neighbor-only: each rank packs ``send_map_elmts`` for its actual
neighbors. Here the neighbor graph of a row-partitioned sparse matrix is
a set of ring offsets o = (dest - source) mod P; each offset becomes one
ring exchange of a per-offset tile (``comm.shift``), so the exchange
volume is O(sum of boundary sizes), not the O(P^2 * max) of a dense
all-to-all.

All irregular discovery happens on the host at setup, in numpy:

- ``send_idx (P, M)``: per source shard, the local column indices to
  pack, grouped by offset (offset r owns [starts[r], starts[r] + m[r]));
- offd column indices are rewritten at partition time to point straight
  into the (M,) receive buffer, so there is no unpack step;
- shard d's halo[starts[r] + j] is the j-th entry from source
  (d - offsets[r]) mod P. Padding slots hold -1 and are never read.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hypre_tpu_torch.core.partition import RowPartition


@dataclasses.dataclass(frozen=True)
class HaloSchedule:
    """Static neighbor exchange schedule for a (row, col) partition pair."""

    send_idx: np.ndarray  # (P, M) int32: local col-space indices to pack
    offsets: tuple  # ring offsets (dest - source) mod P, one exchange each
    sizes: tuple  # per-offset tile size m_r; M = sum(sizes)
    # per shard: offd global col -> flat recv-buffer position
    recv_pos: list

    @property
    def num_shards(self) -> int:
        return self.send_idx.shape[0]

    @property
    def recv_size(self) -> int:
        return int(self.send_idx.shape[1])

    @property
    def starts(self) -> tuple:
        out, acc = [], 0
        for m in self.sizes:
            out.append(acc)
            acc += m
        return tuple(out)

    def exchange_bytes(self, itemsize: int = 4) -> int:
        """Bytes moved per exchange across the whole mesh (one direction):
        O(sum of boundary sizes)."""
        return self.num_shards * self.recv_size * itemsize


def build_halo_schedule(offd_cols_per_shard: list,
                        col_part: RowPartition) -> HaloSchedule:
    """offd_cols_per_shard[p] = sorted unique global columns shard p needs
    from other shards (hypre's col_map_offd, par_csr_matrix.h:45)."""
    P = col_part.num_shards
    # needs[d][s] = global cols destination d needs from source s
    needs: list = []
    for d in range(P):
        cols = np.asarray(offd_cols_per_shard[d], dtype=np.int64)
        owners = col_part.owner_of(cols)
        needs.append({s: cols[owners == s] for s in range(P) if s != d})
    offsets = sorted({(d - s) % P for d in range(P)
                      for s, c in needs[d].items() if len(c)})
    if not offsets:
        offsets = [1 % max(P, 1)] if P > 1 else []
    sizes = []
    for o in offsets:
        m_o = 0
        for d in range(P):
            s = (d - o) % P
            if s != d:
                m_o = max(m_o, len(needs[d].get(s, ())))
        sizes.append(max(m_o, 1))
    M = sum(sizes) if sizes else 1
    # padding slots hold -1 (not 0, a genuine local index): forward
    # exchanges clamp and ignore them, reverse merges must skip them
    send_idx = np.full((P, M), -1, dtype=np.int32)
    recv_pos: list = []
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    for d in range(P):
        pos = {}
        for r, o in enumerate(offsets):
            s = (d - o) % P
            if s == d:
                continue
            cols = needs[d].get(s, np.zeros(0, np.int64))
            # source s packs these at its offset-r block
            send_idx[s, starts[r]: starts[r] + len(cols)] = \
                col_part.local_index(cols)
            pos.update(zip(cols.tolist(),
                           range(int(starts[r]), int(starts[r]) + len(cols))))
        recv_pos.append(pos)
    return HaloSchedule(send_idx=send_idx,
                        offsets=tuple(int(o) for o in offsets),
                        sizes=tuple(int(m) for m in sizes),
                        recv_pos=recv_pos)
