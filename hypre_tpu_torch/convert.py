"""Carry matrices and hierarchies across from numpy.

The port imports nothing of the JAX package, so state built there (or
anywhere else) comes across as numpy arrays: ``ell_from_numpy`` for one
ELL matrix, ``bsr_from_numpy`` for one block matrix, and
``hierarchy_from_numpy`` for a whole AMG hierarchy that the caller
flattened into a dict of arrays (a ``TransferDia`` level and the true
sizes of a row-padded hierarchy included), ``saddle_from_numpy`` for
the blocks of a saddle-point system, and ``struct_from_numpy`` for a
StructMatrix (one operator, or each level of a struct hierarchy), and
``sys_struct_from_numpy`` for a SysPFMG system matrix (an SStructMatrix
comes across as its parts and its U, through ``struct_from_numpy`` and
``ell_from_numpy``). All
place the result on ``device`` (CUDA unless the caller names another).
"""

from __future__ import annotations

import numpy as np
import torch

from hypre_tpu_torch.amg.hierarchy import AMGHierarchy, Level
from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.seq.bsr import BsrMatrix
from hypre_tpu_torch.seq.dia import DiaMatrix
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.fastmv import BandedEll
from hypre_tpu_torch.seq.transfer_dia import TransferDia


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    return t.to(device=device, dtype=dtype)


def ell_from_numpy(vals, cols, n_cols: int, shifts=None,
                   device=None) -> EllMatrix:
    """EllMatrix from (n, k) value and column arrays (padding: col -1,
    value 0)."""
    device = resolve_device(device)
    return EllMatrix(
        vals=_tensor(vals, device),
        cols=_tensor(cols, device, torch.int32),
        n_cols=int(n_cols),
        shifts=None if shifts is None else tuple(int(s) for s in shifts),
    )


def bsr_from_numpy(bvals, bcols, n_bcols: int, device=None) -> BsrMatrix:
    """BsrMatrix from (nb, k, bs, bs) block values and (nb, k) block
    columns (padding: column -1, block 0)."""
    device = resolve_device(device)
    return BsrMatrix(bvals=_tensor(bvals, device),
                     bcols=_tensor(bcols, device, torch.int32),
                     n_bcols=int(n_bcols))


def dia_from_numpy(d: dict, device=None) -> DiaMatrix:
    """DiaMatrix from {"dvals": (D, n) array, "offsets": D ints,
    "n_cols": int}."""
    device = resolve_device(device)
    return DiaMatrix(dvals=_tensor(d["dvals"], device),
                     offsets=tuple(int(o) for o in d["offsets"]),
                     n_cols=int(d["n_cols"]))


def banded_from_numpy(d: dict, device=None) -> BandedEll:
    """BandedEll from {"ell": matrix dict, "vals_t", "lcols_t", "starts":
    arrays, "W", "B", "n_xpad", "exact": ints}."""
    device = resolve_device(device)
    ell = d["ell"]
    return BandedEll(
        ell=ell_from_numpy(ell["vals"], ell["cols"], ell["n_cols"],
                           device=device),
        vals_t=_tensor(d["vals_t"], device),
        lcols_t=_tensor(d["lcols_t"], device, torch.int32),
        starts=_tensor(d["starts"], device, torch.int32),
        W=int(d["W"]), B=int(d["B"]), n_xpad=int(d["n_xpad"]),
        exact=int(d.get("exact", 1)),
        n_rows_s=int(np.shape(ell["vals"])[0]), n_cols_s=int(ell["n_cols"]))


def transfer_dia_from_numpy(d: dict, device=None) -> TransferDia:
    """TransferDia from {"P_dia", "Pt_dia": dia dicts, "expand",
    "compress": banded dicts, "n_coarse": int}."""
    return TransferDia(
        P_dia=dia_from_numpy(d["P_dia"], device),
        Pt_dia=dia_from_numpy(d["Pt_dia"], device),
        expand=banded_from_numpy(d["expand"], device),
        compress=banded_from_numpy(d["compress"], device),
        n_coarse_s=int(d["n_coarse"]))


def hierarchy_from_numpy(d: dict, device=None) -> AMGHierarchy:
    """AMGHierarchy from a dict of numpy arrays:

        {"levels": [{"A": m, "P": m or t, "Pt": m or None, "dinv": a,
                     "l1inv": a, "lmax": a, "cf": a or None,
                     "rw": a or None}, ...],
         "coarse_inv": a, "galerkin": bool (optional),
         "n_fine": int, "n_level_true": tuple (optional: a row-padded
         hierarchy's true sizes)}

    where each matrix m is {"vals": a, "cols": a, "n_cols": int,
    "shifts": tuple or None} and t is a TransferDia dict (it has the key
    "P_dia", see ``transfer_dia_from_numpy``). A non-Galerkin hierarchy
    ("galerkin": False, AIR) carries its restriction R in each level's
    "Pt"; "rw" is a level's CG-estimated Jacobi weight. ELL operators stay
    plain; run ``optimize_hierarchy`` for the kernel formats.
    """
    device = resolve_device(device)

    def mat(m):
        if m is None:
            return None
        if "P_dia" in m:
            return transfer_dia_from_numpy(m, device)
        return ell_from_numpy(m["vals"], m["cols"], m["n_cols"],
                              m.get("shifts"), device=device)

    levels = []
    for lv in d["levels"]:
        cf, rw = lv.get("cf"), lv.get("rw")
        levels.append(Level(
            A=mat(lv["A"]), P=mat(lv["P"]), Pt=mat(lv.get("Pt")),
            dinv=_tensor(lv["dinv"], device),
            l1inv=_tensor(lv["l1inv"], device),
            lmax=_tensor(lv["lmax"], device),
            cf=None if cf is None else _tensor(cf, device, torch.int8),
            rw=None if rw is None else _tensor(rw, device),
        ))
    return AMGHierarchy(
        levels=levels, coarse_inv=_tensor(d["coarse_inv"], device),
        galerkin=bool(d.get("galerkin", True)),
        n_fine=int(d.get("n_fine", 0)),
        n_level_true=tuple(int(v) for v in d.get("n_level_true", ())))


def saddle_from_numpy(d: dict, device=None):
    """precond.saddle.SaddleSystem from {"A": m, "B": m, "Bt": m,
    "C": m or None}, each m a matrix dict as in ``hierarchy_from_numpy``."""
    from hypre_tpu_torch.precond.saddle import SaddleSystem

    device = resolve_device(device)
    blocks = {key: None if d.get(key) is None else ell_from_numpy(
        d[key]["vals"], d[key]["cols"], d[key]["n_cols"],
        d[key].get("shifts"), device=device)
        for key in ("A", "B", "Bt", "C")}
    return SaddleSystem(**blocks)


def struct_from_numpy(coeffs, offsets, shape, periodic=None, device=None):
    """struct.StructMatrix from its (S, *shape) or (S,) coefficient array,
    its S stencil offsets, the grid shape and the per-dim periodicity."""
    from hypre_tpu_torch.struct.matrix import StructMatrix
    from hypre_tpu_torch.struct.stencil import StructStencil

    device = resolve_device(device)
    return StructMatrix(
        coeffs=_tensor(coeffs, device),
        stencil=StructStencil(tuple(tuple(int(o) for o in off)
                                    for off in offsets)),
        shape=tuple(int(s) for s in shape),
        periodic=None if periodic is None else tuple(bool(p)
                                                     for p in periodic))


def sys_struct_from_numpy(coeffs, offsets, shape, device=None):
    """sstruct.SysStructMatrix from its (nvars, nvars, S, *shape)
    coefficient array, its S stencil offsets and the grid shape."""
    from hypre_tpu_torch.sstruct.syspfmg import SysStructMatrix
    from hypre_tpu_torch.struct.stencil import StructStencil

    device = resolve_device(device)
    return SysStructMatrix(
        coeffs=_tensor(coeffs, device),
        stencil=StructStencil(tuple(tuple(int(o) for o in off)
                                    for off in offsets)),
        shape=tuple(int(s) for s in shape))
