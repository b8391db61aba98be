"""Distributed AMG: partition a hierarchy across a shard mesh.

Counterpart of ``hypre_tpu/parallel/par_amg.py``. The setup runs on the
global operator, and the finished hierarchy is partitioned so that the
solve (hypre's ``par_cycle.c``, the part run every iteration) is fully
distributed: halo-exchange products for A, P and Pt, and a replicated
dense coarse solve (hypre gathers the coarse system the same way,
``par_gauss_elim.c:84-118``). Level and AMGHierarchy only ask their
operators for ``mv``/``mv_t`` and vector lengths, so ``amg_cycle`` and
every smoother run unchanged on the partitioned hierarchy. The
hierarchy keeps its mesh, so that on a ``dist`` mesh the coarse solve
gathers its right-hand side (``amg.hierarchy.coarse_solve``).
"""

from __future__ import annotations

import numpy as np

from hypre_tpu_torch.amg.hierarchy import (
    AMGHierarchy, Level, unpad_hierarchy,
)
from hypre_tpu_torch.core.partition import RowPartition
from hypre_tpu_torch.parallel.mesh import Mesh, replicated_sharding
from hypre_tpu_torch.parallel.par_ell import distribute_vector, partition_ell
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.spgemm import ell_transpose


def pad_coarse_inverse(inv: np.ndarray, mesh: Mesh):
    """The (nc, nc) coarse inverse padded to the coarse partition's
    padded size (zero rows and columns) and replicated on the mesh."""
    nc = inv.shape[0]
    n_pad = RowPartition(nc, mesh.num_shards).n_padded
    out = np.zeros((n_pad, n_pad), inv.dtype)
    out[:nc, :nc] = inv
    return replicated_sharding(mesh).put(out)


def partition_hierarchy(hier: AMGHierarchy, mesh: Mesh) -> AMGHierarchy:
    """Every level's A, P and Pt as ParEllMatrix over ``mesh`` (P with
    the coarse partition's columns, Pt with the fine one's), the smoother
    vectors split by rows, the coarse inverse padded and replicated. The
    level operators must be ELL (a facade's ``ell_hierarchy``, not the
    kernel formats ``optimize_hierarchy`` swaps in); a row-padded
    hierarchy is partitioned at its true sizes."""
    hier = unpad_hierarchy(hier)
    levels = []
    for lev in hier.levels:
        if not isinstance(lev.A, EllMatrix) or not isinstance(lev.P,
                                                              EllMatrix):
            raise TypeError(
                "partition_hierarchy takes ELL levels (got "
                f"{type(lev.A).__name__}, {type(lev.P).__name__}); pass the "
                "facade's ell_hierarchy")
        Pt = lev.Pt if lev.Pt is not None else ell_transpose(lev.P)
        n_fine, n_coarse = lev.A.n_rows, lev.P.n_cols
        levels.append(Level(
            A=partition_ell(lev.A, mesh),
            P=partition_ell(lev.P, mesh,
                            col_part=RowPartition(n_coarse, mesh.num_shards)),
            Pt=partition_ell(Pt, mesh,
                             col_part=RowPartition(n_fine, mesh.num_shards)),
            dinv=distribute_vector(lev.dinv, mesh, n_fine),
            l1inv=distribute_vector(lev.l1inv, mesh, n_fine),
            lmax=lev.lmax.to(mesh.device),
        ))
    return AMGHierarchy(
        levels=levels,
        coarse_inv=pad_coarse_inverse(hier.coarse_inv.cpu().numpy(), mesh),
        galerkin=hier.galerkin, mesh=mesh)
