"""Structured-grid model problems (the struct.c driver's built-in problems).

Counterpart of ``hypre_tpu/problems/struct_problems.py``: ``src/test/
struct.c``'s default Laplacian and its anisotropic ``-c cx cy cz``
weighting — a (2*ndim+1)-point star stencil with Dirichlet boundaries
eliminated (out-of-grid reads are zero) — and a random test matrix drawn
with numpy from a seed, so both packages see the same coefficients.
"""

from __future__ import annotations

import numpy as np
import torch

from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.struct.matrix import StructMatrix, struct_from_dense_coeffs
from hypre_tpu_torch.struct.stencil import box_stencil


def _numpy_dtype(dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def struct_laplacian(
    shape: tuple[int, ...],
    weights: tuple[float, ...] | None = None,
    dtype=None,
    constant: bool = True,
    periodic: tuple[bool, ...] | None = None,
    device=None,
) -> StructMatrix:
    """(2d+1)-point anisotropic Laplacian: -w_d u_xx in each dim, on
    ``device`` (CUDA unless the caller names another), float32 unless
    ``dtype``.

    weights = hypre struct.c's -c flag (cx, cy, cz), default all 1.
    periodic = per-dim wraparound (hypre struct.c's -p flag); a
    fully-periodic Laplacian is singular (constant null space).
    """
    dtype = dtype or torch.float32
    ndim = len(shape)
    weights = weights or (1.0,) * ndim
    coeff_map = {(0,) * ndim: 2.0 * float(sum(weights))}
    for d in range(ndim):
        for s in (-1, 1):
            off = [0] * ndim
            off[d] = s
            coeff_map[tuple(off)] = -float(weights[d])
    if not constant:
        coeff_map = {k: np.full(shape, v, dtype=_numpy_dtype(dtype))
                     for k, v in coeff_map.items()}
    return struct_from_dense_coeffs(coeff_map, shape, dtype=dtype,
                                    periodic=periodic, device=device)


def random_struct_matrix(
    shape: tuple[int, ...], extent: int = 1, seed: int = 0, dtype=None,
    device=None,
) -> StructMatrix:
    """Random diagonally-dominant box-stencil matrix (test oracle input),
    drawn with numpy from ``seed`` as the reference draws it; its boundary
    coefficients that point off the grid are nonzero."""
    dtype = dtype or torch.float32
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    st = box_stencil(len(shape), extent)
    coeffs = rng.standard_normal((st.size,) + tuple(shape)).astype(
        _numpy_dtype(dtype))
    # make it SPD-ish: strong positive diagonal
    ci = st.center_index()
    coeffs[ci] = np.abs(coeffs).sum(axis=0) + 1.0
    return StructMatrix(coeffs=torch.from_numpy(coeffs).to(device),
                        stencil=st, shape=tuple(shape))
