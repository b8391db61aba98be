"""Structured-grid layer — hypre's struct_mv + struct_ls on the card.

Counterpart of ``hypre_tpu/struct``. A grid box is a dense tensor; a
stencil matrix holds its coefficient planes and applies through its DIA
view (``matrix.py``), so every stencil matvec on the card is one launch of
the hand-written DIA kernel; Galerkin coarse operators are recovered by
probing the composed R·A·P operator with lattice indicator vectors
(``probe.py``). The solvers: PFMG, SMG, SparseMSG, Jacobi, cyclic
reduction and the Hybrid escalation. The sharded layer (``par_struct``)
waits for the parallel layer.
"""

from hypre_tpu_torch.struct.stencil import StructStencil, star_stencil, box_stencil
from hypre_tpu_torch.struct.matrix import (
    StructMatrix,
    dia_view,
    struct_matvec,
    struct_matvec_t,
    struct_from_dense_coeffs,
)
from hypre_tpu_torch.struct.probe import probe_stencil
from hypre_tpu_torch.struct.io import (
    print_struct_matrix, print_struct_vector, read_struct_matrix,
    read_struct_vector,
)
from hypre_tpu_torch.struct.pfmg import PFMG
from hypre_tpu_torch.struct.sparse_msg import SparseMSG
from hypre_tpu_torch.struct.hybrid import StructHybrid
from hypre_tpu_torch.struct.smg import SMG
from hypre_tpu_torch.struct.jacobi import StructJacobi
from hypre_tpu_torch.struct.cycred import cyclic_reduction_solve
