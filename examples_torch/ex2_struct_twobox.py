"""ex2 analogue (src/examples/ex2.c): the two-processor, multi-box struct
grid from the user's-manual diagram (processor 0 owns two boxes, processor
1 one box), solved with SMG-preconditioned PCG.

The struct layer stores a box-union as its bounding grid with inactive
cells masked to identity rows, the dense-array image of hypre's BoxArray.
The port of ``examples/ex2_struct_twobox.py`` on ``device`` in ``dtype``.
"""

import numpy as np
import torch

from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.krylov import pcg
from hypre_tpu_torch.struct import SMG
from hypre_tpu_torch.struct.matrix import StructMatrix
from hypre_tpu_torch.struct.stencil import StructStencil


def main(scale=6, device=None, dtype=None):
    # boxes (from ex2.c): [-3,-1]x[1,2], [0,2]x[1,4], [3,6]x[1,4] -> shift
    # to a [0,10)x[0,4) bounding grid, unit cells
    nx, ny = 10, 4
    active = np.zeros((nx, ny), bool)
    active[0:3, 0:2] = True   # box 1 (proc 0)
    active[3:6, 0:4] = True   # box 2 (proc 0)
    active[6:10, 0:4] = True  # box 3 (proc 1)

    offsets = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
    coeffs = [np.where(active, 4.0, 1.0)]
    for off in offsets[1:]:
        nb = np.roll(active, shift=(-off[0], -off[1]), axis=(0, 1))
        # roll wraps; kill wrapped neighbors
        if off[0] == 1:
            nb[-1, :] = False
        if off[0] == -1:
            nb[0, :] = False
        if off[1] == 1:
            nb[:, -1] = False
        if off[1] == -1:
            nb[:, 0] = False
        coeffs.append(np.where(active & nb, -1.0, 0.0))
    dev = resolve_device(device)
    A = StructMatrix(
        coeffs=torch.as_tensor(np.stack(coeffs),
                               dtype=dtype or torch.float32).to(dev),
        stencil=StructStencil(offsets),
        shape=(nx, ny),
    )
    b = torch.as_tensor(np.where(active, 1.0, 0.0), dtype=A.dtype).to(dev)
    smg = SMG().setup(A)

    def op(v):
        return A.mv(v.reshape(nx, ny)).reshape(-1)

    def M(r):
        return smg.cycle(r.reshape(nx, ny)).reshape(-1)

    x, info = pcg(op, b.reshape(-1), M=M, rtol=1e-6, device=dev)
    assert bool(info.converged)
    print(f"ex2: SMG-PCG on the 3-box union grid: {int(info.iterations)} iterations")
    return info


if __name__ == "__main__":
    main()
