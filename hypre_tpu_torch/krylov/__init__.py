from hypre_tpu_torch.krylov.pcg import pcg
from hypre_tpu_torch.krylov.gmres import gmres
from hypre_tpu_torch.krylov.bicgstab import bicgstab
from hypre_tpu_torch.krylov.flexgmres import flexgmres
from hypre_tpu_torch.krylov.lgmres import lgmres
from hypre_tpu_torch.krylov.cogmres import cogmres
from hypre_tpu_torch.krylov.cgnr import cgnr
from hypre_tpu_torch.krylov.lobpcg import lobpcg, block_op
