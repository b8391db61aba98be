"""Stencil descriptions (hypre_StructStencil, ``struct_mv/struct_stencil.c``).

Counterpart of ``hypre_tpu/struct/stencil.py``, copied so that the port
imports nothing of the reference package. A stencil is a static tuple of
integer offsets; hypre builds stencils element by element through
``HYPRE_StructStencilSetElement``, here they are immutable values with
constructors for the standard families.
"""

from __future__ import annotations

import dataclasses
import itertools

Offset = tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class StructStencil:
    offsets: tuple[Offset, ...]

    @property
    def ndim(self) -> int:
        return len(self.offsets[0])

    @property
    def size(self) -> int:
        return len(self.offsets)

    @property
    def extent(self) -> tuple[int, ...]:
        """Per-dim max |offset| — the ghost-layer width the stencil needs."""
        return tuple(
            max(abs(o[d]) for o in self.offsets) for d in range(self.ndim)
        )

    def center_index(self) -> int:
        zero = (0,) * self.ndim
        return self.offsets.index(zero)

    def __post_init__(self):
        if len(set(self.offsets)) != len(self.offsets):
            raise ValueError("duplicate stencil offsets")


def star_stencil(ndim: int, extent: int = 1) -> StructStencil:
    """2*ndim*extent+1 point star: center + axis-aligned offsets (5pt/7pt)."""
    offsets: list[Offset] = [(0,) * ndim]
    for d in range(ndim):
        for e in range(1, extent + 1):
            for s in (-e, e):
                off = [0] * ndim
                off[d] = s
                offsets.append(tuple(off))
    return StructStencil(tuple(offsets))


def box_stencil(ndim: int, extent: int | tuple[int, ...] = 1) -> StructStencil:
    """Full (2e+1)^ndim box (9pt/27pt)."""
    if isinstance(extent, int):
        extent = (extent,) * ndim
    ranges = [range(-e, e + 1) for e in extent]
    return StructStencil(tuple(itertools.product(*ranges)))
