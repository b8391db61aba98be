"""A constant-coefficient stencil operator on a dense grid of any
dimension, applied without a matrix: y = A x with A = L + shift * I, L the
stencil with Dirichlet truncation at the boundary (rows are the grid
points in C order, the last axis fastest).

A configuration names this problem with ``"problem": "stencil"`` and
gives its ``grid`` and ``stencil``; the stencil is a data file,
``reference/stencils/<stencil>.json``, holding its ``offsets`` (one entry
per grid axis) and ``coefficients``. A new constant-coefficient stencil is
a new data file."""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

STENCIL_DIR = Path(__file__).resolve().parent.parent / "stencils"


def load_stencil(name: str) -> list[tuple[tuple[int, ...], float]]:
    """The (offset, coefficient) pairs of ``stencils/<name>.json``."""
    with open(STENCIL_DIR / f"{name}.json") as f:
        doc = json.load(f)
    offs, coefs = doc["offsets"], doc["coefficients"]
    if len(offs) != len(coefs) or len({tuple(o) for o in offs}) != len(offs):
        raise ValueError(f"stencil {name!r}: offsets and coefficients do "
                         "not pair up one to one")
    return [(tuple(int(v) for v in o), float(c)) for o, c in zip(offs, coefs)]


class Problem:
    def __init__(self, grid, stencil: str):
        self.grid = tuple(int(g) for g in grid)
        self.terms = load_stencil(stencil)
        if any(len(o) != len(self.grid) for o, _ in self.terms):
            raise ValueError(f"stencil {stencil!r} does not have the grid's "
                             f"{len(self.grid)} axes")
        self.n = math.prod(self.grid)
        self.reach = [max(abs(o[d]) for o, _ in self.terms)
                      for d in range(len(self.grid))]
        self.center = dict(self.terms).get((0,) * len(self.grid), 0.0)

    def apply(self, x: torch.Tensor, shift: float = 0.0,
              dtype=None) -> torch.Tensor:
        """(L + shift I) x on the flat vector x, in ``dtype`` (x's own
        when None). Every term is a shifted slice of the zero-padded
        grid."""
        dtype = dtype or x.dtype
        xg = x.to(dtype).reshape(self.grid)
        pad = []
        for r in reversed(self.reach):
            pad += [r, r]
        xp = torch.nn.functional.pad(xg, pad)
        y = torch.zeros_like(xg)
        for off, coef in self.terms:
            w = coef + shift if not any(off) else coef
            y += w * xp[tuple(slice(r + o, r + o + g) for r, o, g
                              in zip(self.reach, off, self.grid))]
        return y.reshape(-1)

    def diagonal(self, shift: float = 0.0, dtype=torch.float64,
                 device=None) -> torch.Tensor:
        return torch.full((self.n,), self.center + shift, dtype=dtype,
                          device=device)

    def nnz(self) -> int:
        """Stored nonzeros of the truncated operator."""
        return sum(math.prod(g - abs(o) for o, g in zip(off, self.grid))
                   for off, _ in self.terms)

    def dense(self, shift: float = 0.0) -> torch.Tensor:
        """The operator as a dense float64 matrix (tiny grids only)."""
        eye = torch.eye(self.n, dtype=torch.float64)
        return torch.stack([self.apply(eye[j], shift)
                            for j in range(self.n)], dim=1)


def make(config: dict) -> Problem:
    return Problem(config["grid"], config["stencil"])
