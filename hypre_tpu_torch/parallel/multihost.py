"""Multi-process execution: ``torch.distributed`` as hypre's MPI.

Counterpart of ``hypre_tpu/parallel/multihost.py``. hypre scales across
nodes with MPI: every rank calls ``MPI_Init`` and the ParCSR layer's
CommPkg routes neighbor traffic over the interconnect. Here
``init_multihost`` is ``MPI_Init`` (``torch.distributed.
init_process_group``, NCCL when the process has a card, else gloo), and
a ``dist`` mesh over the group (``make_mesh(backend="dist")``) is the
communicator: one shard per process.

``make_pod_mesh`` groups a flat row mesh as (hosts, shards per host)
with the row axis innermost, so that each host's row blocks are
contiguous, as hypre keeps each rank's rows contiguous
(``parcsr_mv/par_csr_matrix.c``): only one boundary per neighbor pair of
hosts then crosses the slower link between them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from hypre_tpu_torch.parallel.mesh import ROW_AXIS, Mesh, make_mesh

DCN_AXIS = "dcn"


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   timeout_s: float = 600.0) -> int:
    """Join (or start) the process group, the MPI_Init of the port, and
    return this process's rank.

    Pass the coordinator's ``host:port`` with the process count and this
    process's rank, the triple ``mpirun`` hands out. With no arguments a
    launcher's environment is used when it marks a multi-process job
    (``HYPRE_TPU_MULTIHOST=1``, or an MPI/Slurm world of size > 1: rank
    and size from ``RANK``/``WORLD_SIZE``, ``OMPI_COMM_WORLD_*`` or
    ``SLURM_*``, the address from ``MASTER_ADDR``/``MASTER_PORT``); a
    single process with no such environment joins nothing and is rank 0.
    Calling it again is a no-op, like hypre drivers' MPI_Initialized
    guards. ``backend`` defaults to NCCL when a card is present, else
    gloo."""
    import datetime

    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    world = _env_int("WORLD_SIZE", "OMPI_COMM_WORLD_SIZE", "SLURM_NTASKS")
    auto = (coordinator_address is None and num_processes is None and (
        os.environ.get("HYPRE_TPU_MULTIHOST") == "1" or (world or 1) > 1))
    if coordinator_address is None and num_processes is None and not auto:
        return 0
    if not dist.is_available():
        raise RuntimeError("this PyTorch build has no torch.distributed")
    if auto:
        num_processes = world
        process_id = _env_int("RANK", "OMPI_COMM_WORLD_RANK", "SLURM_PROCID")
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}"
                               f":{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None or process_id is None:
        raise ValueError("init_multihost needs num_processes and process_id "
                         "with a coordinator address")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


def shutdown_multihost() -> None:
    """Leave the process group (MPI_Finalize analogue)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


@dataclasses.dataclass(frozen=True)
class PodMesh:
    """A flat row mesh grouped as ``(hosts, shards per host)``; the shard
    order (and so every row block) is the flat mesh's."""

    mesh: Mesh
    hosts: int
    axis_names: tuple = (DCN_AXIS, ROW_AXIS)

    @property
    def shape(self) -> tuple:
        return (self.hosts, self.mesh.num_shards // self.hosts)

    @property
    def shards(self) -> np.ndarray:
        return np.arange(self.mesh.num_shards).reshape(self.shape)


def flat_row_mesh(num_shards: Optional[int] = None, device=None) -> Mesh:
    """A 1-D row mesh over every process of the group, one shard each
    (``backend="dist"``), or, in a single process, ``num_shards`` shards
    held locally. Shards are process-major either way, so each process's
    row block is contiguous (hypre's rank-contiguous row_starts)."""
    if process_count() > 1:
        return make_mesh(num_shards, device=device, backend="dist")
    return make_mesh(num_shards, device=device, backend="local")


def make_pod_mesh(mesh: Optional[Mesh] = None,
                  hosts: Optional[int] = None) -> PodMesh:
    """``mesh`` (by default ``flat_row_mesh()``) as axes ``(dcn, rows)``:
    ``rows`` innermost spans each host's shards, ``dcn`` the hosts.
    ``hosts`` defaults to the process count (1 in one process, where the
    dcn axis has size 1)."""
    mesh = mesh if mesh is not None else flat_row_mesh()
    hosts = hosts or process_count()
    if mesh.num_shards % hosts:
        raise ValueError(
            f"{mesh.num_shards} shards not divisible by {hosts} hosts")
    return PodMesh(mesh, hosts)


def host_row_ranges(n_global: int, mesh: Mesh) -> list[tuple[int, int]]:
    """Per-process [start, end) global row ranges under equal per-shard
    blocks: what each process should assemble locally (the IJ
    interface's ILower/IUpper per rank)."""
    block = -(-n_global // mesh.num_shards)
    per_proc: dict = {}
    for i, p in enumerate(mesh.shard_process):
        lo = min(i * block, n_global)
        hi = min((i + 1) * block, n_global)
        if p in per_proc:
            per_proc[p] = (min(per_proc[p][0], lo), max(per_proc[p][1], hi))
        else:
            per_proc[p] = (lo, hi)
    return [per_proc[p] for p in sorted(per_proc)]
