"""Maxwell — semi-structured edge-element solver (``sstruct_ls/maxwell_*.c``).

Counterpart of ``hypre_tpu/sstruct/maxwell.py`` (HYPRE_SStructMaxwellCreate,
``sstruct_ls/HYPRE_sstruct_ls.h:572``): the solver takes an edge curl-curl
system on a semi-structured grid and derives the discrete gradient and
the node coordinates from the grid itself (``maxwell_grad.c``
hypre_Maxwell_Grad), then preconditions PCG with the auxiliary-space
cycle (the port's ``amg/ams.py::AMS``).

Each part's shape is read as its NODE grid; edges connect adjacent nodes
per direction, ordered part-major, direction-major within a part and C
order within a direction. ``maxwell_grad`` builds that incidence with
array operations (the reference loops over every edge and node); per-part
``rfactors`` scale the node spacing (HYPRE_SStructMaxwellSetRfactors).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from hypre_tpu_torch.amg.ams import AMS
from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.seq.csr import HostCSR
from hypre_tpu_torch.seq.ell import EllMatrix, csr_to_ell
from hypre_tpu_torch.sstruct.grid import SStructGrid


def part_edge_counts(shape: Sequence[int]) -> list[int]:
    """Edges per direction for a node grid ``shape`` (d-dim box)."""
    shape = tuple(shape)
    out = []
    for d in range(len(shape)):
        dims = list(shape)
        dims[d] -= 1
        out.append(int(np.prod(dims)))
    return out


def maxwell_grad(grid: SStructGrid, rfactors: Optional[Sequence[float]] = None,
                 dtype=None, device=None) -> tuple[EllMatrix, np.ndarray]:
    """Discrete gradient G (global edges x global nodes) on ``device``
    (CUDA unless the caller names another) in ``dtype`` (float32 unless
    the caller names another), and the node coordinates: G[e, head] = +1,
    G[e, tail] = -1 for each edge between adjacent nodes
    (hypre_Maxwell_Grad). rfactors[p] scales part p's node spacing by
    1/rfactors[p]."""
    ndim = len(grid.part_shapes[0])
    rows, cols, vals, coords = [], [], [], []
    edge_off = node_off = 0
    for p, shape in enumerate(grid.part_shapes):
        h = 1.0 / float(rfactors[p]) if rfactors is not None else 1.0
        strides = np.cumprod([1] + list(shape[::-1]))[:-1][::-1]  # C order
        for d in range(ndim):
            dims = list(shape)
            dims[d] -= 1
            idx = np.indices(dims).reshape(ndim, -1)
            tail = node_off + strides @ idx
            e = edge_off + np.arange(tail.shape[0])
            rows += [e, e]
            cols += [tail + strides[d], tail]
            vals += [np.ones(e.shape[0]), -np.ones(e.shape[0])]
            edge_off += tail.shape[0]
        coords.append(h * np.indices(shape).reshape(ndim, -1).T)
        node_off += int(np.prod(shape))
    G = HostCSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                         np.concatenate(vals), (edge_off, node_off))
    return (csr_to_ell(G, dtype=dtype, device=resolve_device(device)),
            np.concatenate(coords))


@dataclasses.dataclass
class Maxwell:
    """HYPRE_SStructMaxwellCreate/Setup/Solve object protocol. ``A`` is
    the assembled edge system over the grid's global edge space, in the
    ordering ``maxwell_grad`` defines."""

    rfactors: Optional[Sequence[float]] = None
    smooth_sweeps: int = 1
    amg_knobs: Optional[dict] = None

    A: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    op: object = dataclasses.field(default=None, repr=False)
    ams: Optional[AMS] = dataclasses.field(default=None, repr=False)

    def setup(self, A: EllMatrix, grid: SStructGrid, device=None,
              optimize="auto") -> "Maxwell":
        """Set up on ``device`` (CUDA unless the caller names another).
        ``optimize``: the kernel formats for A's product and the AMS
        hierarchies ('auto': on CUDA)."""
        from hypre_tpu_torch.seq.fastmv import optimize_operator

        dev = resolve_device(device)
        if optimize == "auto":
            optimize = dev.type == "cuda"
        G, coords = maxwell_grad(grid, self.rfactors, dtype=A.dtype,
                                 device=dev)
        if A.n_rows != G.n_rows:
            raise ValueError(
                f"edge matrix has {A.n_rows} rows but the grid defines "
                f"{G.n_rows} edges")
        self.A = A.to(dev)
        self.op = (optimize_operator(self.A, prefer_pallas=True)
                   if optimize else self.A)
        self.ams = AMS(smooth_sweeps=self.smooth_sweeps,
                       amg_knobs=self.amg_knobs).setup(
            self.A, G, coords, device=dev, optimize=optimize)
        return self

    def precond(self):
        return self.ams.precond()

    def solve(self, b: torch.Tensor, x0=None, rtol: float = 1e-8,
              maxiter: int = 200):
        """PCG preconditioned by the auxiliary-space cycle (the
        reference's own usage through HYPRE_SStructPCGSetPrecond)."""
        from hypre_tpu_torch.krylov.pcg import pcg

        return pcg(self.op.mv, b, x0=x0, M=self.precond(), rtol=rtol,
                   maxiter=maxiter, device=self.A.device)
