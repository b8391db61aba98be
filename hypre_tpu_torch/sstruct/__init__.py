"""Semi-structured layer — hypre's sstruct_mv + sstruct_ls on the card.

Counterpart of ``hypre_tpu/sstruct``. An SStruct problem is a set of
structured parts (each a box grid with stencil coupling) plus a graph of
non-stencil entries in an unstructured "U matrix"
(``sstruct_mv/_hypre_sstruct_mv.h:555-616``); the matvec is the per-part
struct matvecs plus the U matvec (``sstruct_mv/sstruct_matvec.c:262-319``).
Parts apply through their DIA views (the DIA kernels on the card), U
through the format ``optimize_operator`` picks, and an SStructVector is
the flat vector (parts are reshaped views). Solvers:

- Split (HYPRE_SStructSplit*, block-diagonal per-part struct solves),
- SysPFMG (sys_pfmg*.c, PFMG for multi-variable systems on one part, on
  one flat DIA view of the whole system),
- FAC (fac*.c, AMR composite grids with patch relaxation + Galerkin
  coarse correction; composite-Poisson assembly helpers included),
- Maxwell (maxwell_*.c, edge curl-curl systems with the discrete gradient
  derived from the grid, solved through the auxiliary space),
- FEM element assembly (``fem.py``, HYPRE_SStructMatrixAddFEMValues),
- any Krylov solver through ``as_linear_op``.
"""

from hypre_tpu_torch.sstruct.grid import SStructGrid
from hypre_tpu_torch.sstruct.matrix import SStructMatrix
from hypre_tpu_torch.sstruct.split import SplitSolver
from hypre_tpu_torch.sstruct.syspfmg import SysPFMG, SysStructMatrix
from hypre_tpu_torch.sstruct.fac import FAC
from hypre_tpu_torch.sstruct.maxwell import Maxwell, maxwell_grad
