"""1-D block row partitioning helpers.

Counterpart of ``hypre_tpu/core/partition.py`` (hypre's
``hypre_GeneratePartitioning``, ``seq_mv/genpart.c:18``, and the assumed
partition of ``utilities/ap.c``). The global row count is padded to a
multiple of the shard count so that every shard holds the same number of
rows; owner lookup is then O(1) arithmetic, the property hypre's assumed
partition buys.
"""

from __future__ import annotations

import numpy as np
import torch

from hypre_tpu_torch.core.config import round_up


class RowPartition:
    """Equal-block 1-D partition of ``n_global`` (possibly padded) rows."""

    def __init__(self, n_global: int, num_shards: int):
        self.n_global = int(n_global)
        self.num_shards = int(num_shards)
        self.n_padded = round_up(self.n_global, self.num_shards)
        self.n_local = self.n_padded // self.num_shards

    def owner_of(self, rows):
        """The shard that owns each row (numpy array or tensor in, the
        same kind out)."""
        if isinstance(rows, torch.Tensor):
            return torch.div(rows, self.n_local, rounding_mode="floor")
        return np.asarray(rows) // self.n_local

    def local_index(self, rows):
        """Each row's index inside its owner's block."""
        if isinstance(rows, torch.Tensor):
            return torch.remainder(rows, self.n_local)
        return np.asarray(rows) % self.n_local

    def row_range(self, shard: int) -> tuple[int, int]:
        lo = shard * self.n_local
        return lo, min(lo + self.n_local, self.n_global)

    def __repr__(self) -> str:
        return (
            f"RowPartition(n_global={self.n_global}, shards={self.num_shards}, "
            f"n_local={self.n_local})"
        )
