"""The shard mesh: hypre's communicator.

Counterpart of ``hypre_tpu/parallel/mesh.py``. hypre's execution context
is an MPI communicator; the reference's is a 1-D ``jax.sharding.Mesh``
over the row axis. The port's ``Mesh`` names the number of shards, the
device their tensors live on and the communicator that joins them
(``parallel/comm.py``): ``backend="local"`` holds every shard in this
process (the shard axis is a batch axis), ``backend="dist"`` one shard
per ``torch.distributed`` process.

``row_sharding(mesh).put(a)`` places a global array (padded rows first)
as the per-shard blocks this process holds, ``replicated_sharding(mesh)
.put(a)`` as one copy, the roles of the reference's ``NamedSharding``s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.parallel.comm import DistComm, LocalComm

ROW_AXIS = "rows"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``num_shards`` row shards on ``device``, joined by ``comm``."""

    num_shards: int
    device: torch.device
    comm: object
    axis_names: tuple = (ROW_AXIS,)

    @property
    def local_shards(self) -> int:
        return self.comm.local_shards

    @property
    def first_shard(self) -> int:
        return self.comm.first_shard

    @property
    def shard_process(self) -> tuple:
        """The process that holds each shard."""
        if self.comm.backend == "dist":
            return tuple(range(self.num_shards))
        return (self.comm.process_index,) * self.num_shards


def make_mesh(num_shards: int | None = None, device=None,
              backend: str = "local") -> Mesh:
    """A 1-D row mesh of ``num_shards`` shards on ``device`` (CUDA unless
    the caller names another). ``backend="local"`` holds them all in this
    process (one shard when ``num_shards`` is None); ``"dist"`` takes one
    per process of the initialized ``torch.distributed`` group, and
    ``num_shards``, when given, must equal its size."""
    device = resolve_device(device)
    if backend == "local":
        return Mesh(int(num_shards or 1), device, LocalComm(num_shards or 1))
    if backend == "dist":
        comm = DistComm()
        if num_shards is not None and num_shards != comm.num_shards:
            raise ValueError(
                f"make_mesh({num_shards}, backend='dist') but the process "
                f"group has {comm.num_shards} processes")
        return Mesh(comm.num_shards, device, comm)
    raise ValueError(f"unknown mesh backend: {backend!r}")


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    return t.to(device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """Rows split in equal blocks over the mesh's shards."""

    mesh: Mesh

    def put(self, a, dtype=None) -> torch.Tensor:
        """(P * n_local, ...) global array -> the (local_shards, n_local,
        ...) blocks of this process, on the mesh's device."""
        m = self.mesh
        n = a.shape[0]
        if n % m.num_shards:
            raise ValueError(f"{n} rows do not split into {m.num_shards} "
                             "equal shards (pad to RowPartition.n_padded)")
        nl = n // m.num_shards
        lo = m.first_shard * nl
        block = a[lo: lo + m.local_shards * nl]
        return _as_tensor(block, m.device, dtype).reshape(
            (m.local_shards, nl) + tuple(a.shape[1:]))


@dataclasses.dataclass(frozen=True)
class ReplicatedSharding:
    """One whole copy of the array with every process."""

    mesh: Mesh

    def put(self, a, dtype=None) -> torch.Tensor:
        return _as_tensor(a, self.mesh.device, dtype)


def row_sharding(mesh: Mesh) -> RowSharding:
    return RowSharding(mesh)


def replicated_sharding(mesh: Mesh) -> ReplicatedSharding:
    return ReplicatedSharding(mesh)
