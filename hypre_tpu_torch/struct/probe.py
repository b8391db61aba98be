"""Stencil recovery by lattice probing — the struct-layer RAP engine.

Counterpart of ``hypre_tpu/struct/probe.py``. hypre computes Galerkin
coarse operators with per-stencil hand-differentiated kernels
(``struct_ls/pfmg_setup_rap*.c``, ``smg*_setup_rap.c``); the reference
replaces them with one exact, generic algorithm, kept here:

Any linear operator on a grid whose matrix is a stencil of extent ``e``
(A[i,j] = 0 unless |j-i| <= e componentwise) is fully determined by its
action on the (2e+1)^d lattice indicator vectors x_c[j] = 1 iff j === c
(mod 2e+1): within the stencil range of any row i there is exactly one
j === c, so (A x_c)[i] reads off a single coefficient. Probing the composed
``restrict ∘ A ∘ interp`` recovers the coarse stencil, boundary rows
included (graph-colouring Jacobian compression on a structured grid).

The reference vmaps the operator over the probes; here the probes are a
leading batch axis of one call. Each offset's coefficients come from one
gather on the probe class, ``Y[cls_o(i), i]`` (the reference sums
``n_probe`` masked copies per offset), and the prune flags come back in
one read per probed operator.
"""

from __future__ import annotations

import itertools
from typing import Callable

import numpy as np
import torch

from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.struct.matrix import StructMatrix
from hypre_tpu_torch.struct.stencil import StructStencil


def semi_rap_apply(xc: torch.Tensor, A: StructMatrix, P) -> torch.Tensor:
    """The composed coarse operator P^T A P — the probe target shared by
    PFMG/SMG/SparseMSG setup; xc may carry leading batch dims."""
    return P.apply_t(A.mv(P.apply(xc)))


def _lattice_class(shape, mods, shift, device) -> torch.Tensor:
    """class(i + shift) on the grid: the row-major index of
    ((i_d + shift_d) mod m_d)_d."""
    cls = torch.zeros((), dtype=torch.int64, device=device)
    for d, n in enumerate(shape):
        iota = torch.arange(n, device=device).reshape(
            [-1 if e == d else 1 for e in range(len(shape))])
        cls = cls * mods[d] + (iota + shift[d]) % mods[d]
    return cls.expand(tuple(shape))


def probe_core(apply_fn, shape, mods, offsets, dtype, operands, device):
    """Build the (prod(mods), *shape) lattice indicator probes, push them
    through ``apply_fn`` as one batch and read off every offset's
    coefficient array plus its any-nonzero prune flag (both on the
    device)."""
    ndim = len(shape)
    cls = _lattice_class(shape, mods, (0,) * ndim, device)
    n_probe = int(np.prod(mods))
    pid = torch.arange(n_probe, device=device).reshape(
        (n_probe,) + (1,) * ndim)
    probes = (cls[None] == pid).to(dtype)
    Y = apply_fn(probes, *operands).reshape(n_probe, -1)
    C = torch.stack([
        Y.gather(0, _lattice_class(shape, mods, off, device).reshape(1, -1))
        .reshape(tuple(shape)) for off in offsets])
    flags = (C.reshape(len(offsets), -1) != 0).any(dim=1)
    return C, flags


def probe_plan(shape, extent, periodic):
    """Probe lattice moduli + candidate offsets for a stencil of ``extent``
    on ``shape`` (periodic dims need a modulus dividing the grid size)."""
    ndim = len(shape)

    def pick_mod(d: int) -> int:
        need = 2 * extent[d] + 1
        if not periodic[d]:
            return need
        if shape[d] < need:
            raise NotImplementedError(
                f"periodic dim {d}: grid size {shape[d]} smaller than the "
                f"stencil span {need}; the wrapped operator is not a stencil"
            )
        for m in range(need, shape[d] + 1):
            if shape[d] % m == 0:
                return m
        return shape[d]

    mods = tuple(pick_mod(d) for d in range(ndim))
    offsets = tuple(itertools.product(*(range(-e, e + 1) for e in extent)))
    return mods, offsets


def prune_keep(offsets, flags) -> list:
    """The stencil entries a prune keeps: the centre and every offset whose
    flag (host array) is set."""
    ndim = len(offsets[0])
    return [s for s in range(len(offsets))
            if offsets[s] == (0,) * ndim or bool(flags[s])]


def probe_stencil(
    apply_fn: Callable[..., torch.Tensor],
    shape: tuple[int, ...],
    extent: tuple[int, ...],
    dtype,
    prune: bool = True,
    periodic: tuple[bool, ...] | None = None,
    operands: tuple = (),
    device=None,
) -> StructMatrix:
    """Recover the StructMatrix of a linear ``apply_fn`` on grid ``shape``
    (``apply_fn(x, *operands)`` must take a leading batch axis), on
    ``device`` (CUDA unless the caller names another).

    extent: per-dim stencil extent bound (over-estimates are safe).
    prune: drop offsets whose recovered coefficient array is identically 0
    (e.g. Galerkin RAP of a 7-pt operator is 19-pt, not the full 27 box).
    Periodic dims take the smallest divisor of ``shape[d]`` that is
    >= 2e+1 as their modulus, so the lattice classes survive the wrap.
    """
    device = resolve_device(device)
    ndim = len(shape)
    periodic = periodic or (False,) * ndim
    mods, offsets = probe_plan(shape, extent, periodic)
    C, flags = probe_core(apply_fn, tuple(shape), mods, offsets, dtype,
                          operands, device)
    if prune:
        keep = prune_keep(offsets, flags.cpu().numpy())  # the one read
        if len(keep) < len(offsets):
            offsets = tuple(offsets[s] for s in keep)
            C = C[keep]
    return StructMatrix(
        coeffs=C,
        stencil=StructStencil(tuple(offsets)),
        shape=tuple(shape),
        periodic=periodic,
    )
