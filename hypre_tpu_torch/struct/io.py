"""Struct object IO — per-object ASCII print/read.

Counterpart of the struct half of ``hypre_tpu/struct/io.py``: the analogue
of ``hypre_StructMatrixPrint/Read`` (``struct_mv/struct_matrix.c:1764,
1856``), ``hypre_StructVectorPrint/Read`` (``struct_vector.c``) and the
box-data scanners in ``struct_mv/struct_io.c``, in the reference's text
format (header, ConstantCoefficient flag, Grid, Stencil, Data with one
indexed value per line), so files pass between the two packages; and
the SStruct objects (``HYPRE_SStructMatrixPrint``/``VectorPrint``): a
directory with one struct file per part, the U matrix as ``U.ij`` (the
IJ-ASCII format of ``io.py``) and a JSON ``manifest``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.struct.matrix import StructMatrix
from hypre_tpu_torch.struct.stencil import StructStencil


def print_struct_matrix(path: str, A: StructMatrix) -> None:
    """hypre_StructMatrixPrint analogue (one logical box per grid)."""
    coeffs = A.coeffs.cpu().numpy()
    with open(path, "w") as f:
        f.write("StructMatrix\n")
        f.write(f"ConstantCoefficient: {1 if A.is_constant else 0}\n")
        f.write("Grid:\n")
        f.write(f"{A.ndim}\n")
        f.write(" ".join(str(s) for s in A.shape) + "\n")
        f.write(" ".join(str(int(p)) for p in A.periodic) + "\n")
        f.write("Stencil:\n")
        f.write(f"{len(A.stencil.offsets)}\n")
        for s, off in enumerate(A.stencil.offsets):
            f.write(f"{s}: " + " ".join(str(o) for o in off) + "\n")
        f.write("Data:\n")
        if A.is_constant:
            for s in range(coeffs.shape[0]):
                f.write(f"{s} {coeffs[s]:.17g}\n")
        else:
            flat = coeffs.reshape(coeffs.shape[0], -1)
            for s in range(flat.shape[0]):
                for i, v in enumerate(flat[s]):
                    if v != 0.0:
                        f.write(f"{s} {i} {v:.17g}\n")


def read_struct_matrix(path: str, dtype=torch.float32,
                       device=None) -> StructMatrix:
    """hypre_StructMatrixRead analogue, on ``device`` (CUDA unless the
    caller names another)."""
    device = resolve_device(device)
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    if lines[0] != "StructMatrix":
        raise ValueError(f"not a StructMatrix file: {path}")
    constant = lines[1].split(":")[1].strip() == "1"
    shape = tuple(int(x) for x in lines[4].split())
    periodic = tuple(bool(int(x)) for x in lines[5].split())
    S = int(lines[7])
    offsets = [tuple(int(x) for x in lines[8 + s].split(":")[1].split())
               for s in range(S)]
    di = 8 + S
    if lines[2] != "Grid:" or lines[6] != "Stencil:" or lines[di] != "Data:":
        raise ValueError(f"malformed StructMatrix file: {path}")
    n = int(np.prod(shape))
    coeffs = np.zeros(S) if constant else np.zeros((S, n))
    for ln in lines[di + 1:]:
        if not ln:
            continue
        parts = ln.split()
        if constant:
            coeffs[int(parts[0])] = float(parts[1])
        else:
            coeffs[int(parts[0]), int(parts[1])] = float(parts[2])
    if not constant:
        coeffs = coeffs.reshape((S,) + shape)
    return StructMatrix(
        coeffs=torch.from_numpy(coeffs).to(device=device, dtype=dtype),
        stencil=StructStencil(tuple(offsets)), shape=shape,
        periodic=periodic,
    )


def print_struct_vector(path: str, v) -> None:
    """hypre_StructVectorPrint analogue (grid-shaped array)."""
    arr = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    with open(path, "w") as f:
        f.write("StructVector\n")
        f.write("Grid:\n")
        f.write(f"{arr.ndim}\n")
        f.write(" ".join(str(s) for s in arr.shape) + "\n")
        f.write("Data:\n")
        for i, x in enumerate(arr.reshape(-1)):
            if x != 0.0:
                f.write(f"{i} {x:.17g}\n")


def read_struct_vector(path: str, dtype=torch.float32, device=None):
    """hypre_StructVectorRead analogue, on ``device`` (CUDA unless the
    caller names another)."""
    device = resolve_device(device)
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    if lines[0] != "StructVector" or lines[1] != "Grid:" \
            or lines[4] != "Data:":
        raise ValueError(f"not a StructVector file: {path}")
    shape = tuple(int(x) for x in lines[3].split())
    out = np.zeros(int(np.prod(shape)))
    for ln in lines[5:]:
        if not ln:
            continue
        i, v = ln.split()
        out[int(i)] = float(v)
    return torch.from_numpy(out.reshape(shape)).to(device=device, dtype=dtype)


# -- SStruct objects (one file per part + U matrix + manifest) ---------------


def print_sstruct_matrix(prefix: str, A) -> None:
    """HYPRE_SStructMatrixPrint analogue: ``prefix/`` directory with
    ``part<k>`` struct files, ``U.ij`` (when present) and ``manifest``."""
    from hypre_tpu_torch.io import write_ij_ascii

    os.makedirs(prefix, exist_ok=True)
    for k, P in enumerate(A.parts):
        print_struct_matrix(os.path.join(prefix, f"part{k}"), P)
    if A.U is not None:
        write_ij_ascii(os.path.join(prefix, "U.ij"), A.U)
    with open(os.path.join(prefix, "manifest"), "w") as f:
        json.dump({"type": "SStructMatrix", "nparts": len(A.parts),
                   "part_shapes": [list(s) for s in A.grid.part_shapes],
                   "has_U": A.U is not None}, f)


def read_sstruct_matrix(prefix: str, dtype=torch.float32, device=None):
    """HYPRE_SStructMatrixRead analogue, on ``device`` (CUDA unless the
    caller names another)."""
    from hypre_tpu_torch.io import read_ij_ascii
    from hypre_tpu_torch.seq.ell import csr_to_ell
    from hypre_tpu_torch.sstruct.grid import SStructGrid
    from hypre_tpu_torch.sstruct.matrix import SStructMatrix

    device = resolve_device(device)
    with open(os.path.join(prefix, "manifest")) as f:
        man = json.load(f)
    if man["type"] != "SStructMatrix":
        raise ValueError(f"not an SStructMatrix directory: {prefix}")
    parts = tuple(read_struct_matrix(os.path.join(prefix, f"part{k}"), dtype,
                                     device) for k in range(man["nparts"]))
    U = None
    if man["has_U"]:
        U = csr_to_ell(read_ij_ascii(os.path.join(prefix, "U.ij")),
                       dtype=dtype, device=device)
    grid = SStructGrid(tuple(tuple(s) for s in man["part_shapes"]))
    return SStructMatrix(parts=parts, U=U, grid=grid)


def print_sstruct_vector(prefix: str, grid, x) -> None:
    """HYPRE_SStructVectorPrint analogue (flat global vector + grid)."""
    os.makedirs(prefix, exist_ok=True)
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    for k, xp in enumerate(grid.split(x)):
        print_struct_vector(os.path.join(prefix, f"part{k}"), xp)
    with open(os.path.join(prefix, "manifest"), "w") as f:
        json.dump({"type": "SStructVector", "nparts": grid.nparts,
                   "part_shapes": [list(s) for s in grid.part_shapes]}, f)


def read_sstruct_vector(prefix: str, dtype=torch.float32, device=None):
    """HYPRE_SStructVectorRead analogue: the flat global vector on
    ``device`` (CUDA unless the caller names another)."""
    with open(os.path.join(prefix, "manifest")) as f:
        man = json.load(f)
    if man["type"] != "SStructVector":
        raise ValueError(f"not an SStructVector directory: {prefix}")
    return torch.cat([read_struct_vector(os.path.join(prefix, f"part{k}"),
                                         dtype, device).reshape(-1)
                      for k in range(man["nparts"])])
