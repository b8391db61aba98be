"""hypre_tpu_torch — the PyTorch and CUDA port of hypre_tpu.

A second package beside ``hypre_tpu`` (the JAX reference, which it never
imports). It mirrors the reference's layout — ``core/``, ``seq/``,
``amg/``, ``krylov/``, ``problems/`` — with plain functions on tensors and
frozen dataclasses that hold tensors. The reference's TPU kernels are
hand-written CUDA kernels here (``csrc/``, built with nvcc at first use,
see ``kernels.py``); each keeps a plain PyTorch version that runs on CPU
tensors. Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from hypre_tpu_torch.amg.hierarchy import (
    AMGHierarchy, Level, amg_cycle, make_smoother, optimize_hierarchy,
    setup_hierarchy,
)
from hypre_tpu_torch.core.config import ConvergenceInfo, resolve_device
from hypre_tpu_torch.convert import ell_from_numpy, hierarchy_from_numpy
from hypre_tpu_torch.krylov.pcg import pcg
from hypre_tpu_torch.problems.laplacian import (
    laplacian_2d_5pt, laplacian_3d_7pt,
)
from hypre_tpu_torch.seq.dia import DiaMatrix
from hypre_tpu_torch.seq.ell import EllMatrix, csr_to_ell, ell_spmv
from hypre_tpu_torch.seq.fastmv import BandedEll
