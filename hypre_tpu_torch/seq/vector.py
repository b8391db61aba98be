"""Dense vector kernels (hypre seq_mv/vector.c analogue).

Counterpart of ``hypre_tpu/seq/vector.py``: named one-liners so the Krylov
layer binds to a stable vocabulary (hypre's ``hypre_SeqVectorInnerProd`` /
``Axpy`` / ``Scale``), with the reduction precision policy in one place:
inner products accumulate in at least float32.

A vector split over the processes of a ``dist`` mesh
(``parallel/mesh.py``) holds only this process's rows; ``mesh=`` makes
the reductions global: the local partial sum, then ``mesh.comm.sum``
(hypre's ``hypre_ParVectorInnerProd``: ``MPI_Allreduce`` of the local
inner product). With ``mesh=None`` or a ``local`` mesh, whose vectors
hold every shard, nothing changes.
"""

from __future__ import annotations

import torch


def is_dist(mesh) -> bool:
    """Whether ``mesh`` splits a vector over processes."""
    return mesh is not None and mesh.comm.backend == "dist"


def global_sum(partial: torch.Tensor, mesh=None) -> torch.Tensor:
    """Partial sums of this process's rows -> the sums over the mesh."""
    if not is_dist(mesh):
        return partial
    return mesh.comm.sum(partial.reshape((1,) + tuple(partial.shape))
                         ).reshape(partial.shape)


def dot(x: torch.Tensor, y: torch.Tensor, mesh=None) -> torch.Tensor:
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    s = (x.to(acc_dtype) * y.to(acc_dtype)).sum()
    return global_sum(s, mesh).to(x.dtype)


def norm2(x: torch.Tensor, mesh=None) -> torch.Tensor:
    return torch.sqrt(dot(x, x, mesh))


def axpy(alpha, x, y):
    return alpha * x + y


def scale(alpha, x):
    return alpha * x
