"""The parallel layer: hypre's ParCSR matrices, halo exchange and
distributed BoomerAMG on a shard mesh (counterpart of
``hypre_tpu/parallel``)."""

from hypre_tpu_torch.parallel.par_ell import (
    ParEllMatrix, par_spmv, par_spmv_t, partition_ell,
)
from hypre_tpu_torch.parallel.mesh import (
    make_mesh, row_sharding, replicated_sharding,
)
from hypre_tpu_torch.parallel.multihost import (
    init_multihost, shutdown_multihost, make_pod_mesh, flat_row_mesh,
    host_row_ranges,
)
