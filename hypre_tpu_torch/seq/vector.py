"""Dense vector kernels (hypre seq_mv/vector.c analogue).

Counterpart of ``hypre_tpu/seq/vector.py``: named one-liners so the Krylov
layer binds to a stable vocabulary (hypre's ``hypre_SeqVectorInnerProd`` /
``Axpy`` / ``Scale``), with the reduction precision policy in one place:
inner products accumulate in at least float32.
"""

from __future__ import annotations

import torch


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    return (x.to(acc_dtype) * y.to(acc_dtype)).sum().to(x.dtype)


def norm2(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(x, x))


def axpy(alpha, x, y):
    return alpha * x + y


def scale(alpha, x):
    return alpha * x
