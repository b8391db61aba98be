"""hypre_tpu_torch — the PyTorch and CUDA port of hypre_tpu.

A second package beside ``hypre_tpu`` (the JAX reference, which it never
imports). It mirrors the reference's layout — ``core/``, ``seq/``,
``amg/``, ``krylov/``, ``precond/``, ``problems/``, ``struct/``,
``sstruct/`` and ``fei.py`` — with plain functions
on tensors and frozen dataclasses that hold tensors. The reference's TPU kernels are
hand-written CUDA kernels here (``csrc/``, built with nvcc at first use,
see ``kernels.py``); each keeps a plain PyTorch version that runs on CPU
tensors. Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from hypre_tpu_torch.amg.block_tridiag import BlockTridiag
from hypre_tpu_torch.amg.boomeramg import BoomerAMG
from hypre_tpu_torch.amg.device_setup import setup_hierarchy_device
from hypre_tpu_torch.amg.hierarchy import (
    AMGHierarchy, Level, amg_additive_cycle, amg_cycle, amg_cycle_t,
    make_smoother, optimize_hierarchy, setup_hierarchy, unpad_hierarchy,
    with_operator_transposes,
)
from hypre_tpu_torch.amg.hybrid import HybridSolver
from hypre_tpu_torch.amg.mgr import MGR
from hypre_tpu_torch.amg.smoothed_agg import SmoothedAggAMG
from hypre_tpu_torch.core.config import ConvergenceInfo, resolve_device
from hypre_tpu_torch.convert import (
    bsr_from_numpy, ell_from_numpy, hierarchy_from_numpy,
)
from hypre_tpu_torch.fei import FEISystem
from hypre_tpu_torch.ij import IJMatrix, IJVector
from hypre_tpu_torch.krylov import (
    bicgstab, block_op, cgnr, cogmres, flexgmres, gmres, lgmres, lobpcg, pcg,
)
from hypre_tpu_torch.problems.laplacian import (
    difconv_3d_7pt, elasticity_2d, laplacian_1d, laplacian_2d_5pt,
    laplacian_2d_9pt, laplacian_3d_7pt, laplacian_3d_27pt,
    rotated_anisotropy_2d, stencil_to_ell, vardifconv_3d,
)
from hypre_tpu_torch.problems.unstructured import (
    circuit_laplacian, fem_block_2d, fem_stiffness_2d,
)
from hypre_tpu_torch.refine import make_device_refiner, refine_solve
from hypre_tpu_torch.seq.dia import DiaMatrix
from hypre_tpu_torch.seq.ell import EllMatrix, csr_to_ell, ell_spmv
from hypre_tpu_torch.seq.fastmv import BandedEll
from hypre_tpu_torch.seq.transfer_dia import TransferDia
from hypre_tpu_torch.struct import (
    PFMG, SMG, SparseMSG, StructHybrid, StructJacobi, StructMatrix,
)
from hypre_tpu_torch.sstruct import (
    FAC, Maxwell, SplitSolver, SStructGrid, SStructMatrix, SysPFMG,
)
