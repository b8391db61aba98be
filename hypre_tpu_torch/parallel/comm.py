"""The shard communicator: the collectives of the parallel layer, on two
backends.

The reference is single-controller SPMD: every per-shard program is a
``shard_map`` body over a 1-D ``("rows",)`` mesh, and its collectives
are ``lax.ppermute`` (the halo exchange), ``psum``/``pmax``/``pmin``,
``all_gather`` and ``axis_index`` (``hypre_tpu/parallel/par_ell.py``,
``par_setup.py``). The port makes the shard axis explicit: a per-shard
array is a tensor whose leading axis runs over the shards this process
holds, and the collectives act on that axis.

- ``LocalComm``: every shard in this process, on one device. A per-shard
  array is one tensor of shape ``(P, n_local, ...)``; the ring exchange
  with offset o is ``torch.roll`` by o along the shard axis, so one
  launch serves every shard. This is how several shards run on the one
  card, and how the tests run the reference's 8-shard mesh on the CPU.
- ``DistComm``: ``torch.distributed``, one shard per process (leading
  axis 1). The exchange is one ``batch_isend_irecv`` pair per ring
  offset, the reductions ``all_reduce``. The process group's backend
  must fit the tensors: gloo takes CPU tensors, NCCL CUDA ones; a
  mismatch raises instead of copying through the host.

Reductions keep the shard axis as a length-1 axis, which broadcasts
against per-shard arrays on both backends.
"""

from __future__ import annotations

import numpy as np
import torch


class LocalComm:
    """All ``num_shards`` shards in this process."""

    backend = "local"

    def __init__(self, num_shards: int):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        self.local_shards = self.num_shards
        self.first_shard = 0
        self.process_index = 0

    def shift(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        """Ring permutation: shard s's block lands on shard (s + offset)
        mod P (``lax.ppermute`` with perm [(s, (s + o) % P)])."""
        return torch.roll(x, offset, dims=0)

    def shard_ids(self, device) -> torch.Tensor:
        """The global index of each shard held (``lax.axis_index``)."""
        return torch.arange(self.num_shards, device=device)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0, keepdim=True)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=0, keepdim=True)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return x.amin(dim=0, keepdim=True)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(P, ...) from the per-shard (local_shards, ...) blocks."""
        return x

    def gather_host(self, blocks: list) -> list:
        """Every shard's host object (a list over the shards held in, a
        list over all P shards out): the host-side setup work, hypre's
        CommPkg construction, sees the whole mesh."""
        return list(blocks)


def _reduce_op(name: str):
    import torch.distributed as dist

    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN}[name]


class DistComm:
    """One shard per process of the default ``torch.distributed`` group."""

    backend = "dist"

    def __init__(self):
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "the 'dist' backend needs an initialized torch.distributed "
                "process group (parallel.multihost.init_multihost)")
        self.num_shards = dist.get_world_size()
        self.first_shard = dist.get_rank()
        self.process_index = self.first_shard
        self.local_shards = 1
        self.group_backend = str(dist.get_backend())

    def _check(self, x: torch.Tensor) -> None:
        on_card = x.device.type == "cuda"
        if on_card and self.group_backend != "nccl":
            raise RuntimeError(
                f"CUDA tensors need a NCCL process group; this one is "
                f"{self.group_backend!r} (the dist backend does not copy "
                "through the host)")
        if not on_card and self.group_backend == "nccl":
            raise RuntimeError(
                "a NCCL process group exchanges CUDA tensors only; got a "
                f"{x.device.type} tensor")

    def shift(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        import torch.distributed as dist

        self._check(x)
        P, rank = self.num_shards, self.first_shard
        o = offset % P
        if o == 0:
            return x.clone()
        send = x.contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (rank + o) % P),
               dist.P2POp(dist.irecv, recv, (rank - o) % P)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def shard_ids(self, device) -> torch.Tensor:
        return torch.tensor([self.first_shard], device=device)

    def _all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        import torch.distributed as dist

        self._check(x)
        out = x.clone()
        dist.all_reduce(out, op=_reduce_op(op))
        return out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, "sum")

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, "max")

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, "min")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        self._check(x)
        parts = [torch.empty_like(x) for _ in range(self.num_shards)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, dim=0)

    def gather_host(self, blocks: list) -> list:
        import torch.distributed as dist

        out = [None] * self.num_shards
        dist.all_gather_object(out, blocks[0])
        return out


def host_blocks(comm, arr) -> np.ndarray:
    """A per-shard host array (local_shards, ...) -> all shards' blocks
    stacked (P, ...)."""
    arr = np.asarray(arr)
    return np.stack(comm.gather_host(list(arr)))
