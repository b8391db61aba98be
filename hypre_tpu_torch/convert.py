"""Carry matrices and hierarchies across from numpy.

The port imports nothing of the JAX package, so state built there (or
anywhere else) comes across as numpy arrays: ``ell_from_numpy`` for one
ELL matrix and ``hierarchy_from_numpy`` for a whole AMG hierarchy that the
caller flattened into a dict of arrays. Both place the result on ``device``
(CUDA unless the caller names another).
"""

from __future__ import annotations

import numpy as np
import torch

from hypre_tpu_torch.amg.hierarchy import AMGHierarchy, Level
from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.seq.ell import EllMatrix


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


def hierarchy_from_numpy(d: dict, device=None) -> AMGHierarchy:
    """AMGHierarchy from a dict of numpy arrays:

        {"levels": [{"A": m, "P": m, "Pt": m or None, "dinv": a,
                     "l1inv": a, "lmax": a, "cf": a or None}, ...],
         "coarse_inv": a, "galerkin": bool (optional)}

    where each matrix m is {"vals": a, "cols": a, "n_cols": int,
    "shifts": tuple or None}. Levels hold plain ELL operators; run
    ``optimize_hierarchy`` for the kernel formats.
    """
    device = resolve_device(device)

    def mat(m):
        if m is None:
            return None
        return ell_from_numpy(m["vals"], m["cols"], m["n_cols"],
                              m.get("shifts"), device=device)

    levels = []
    for lv in d["levels"]:
        cf = lv.get("cf")
        levels.append(Level(
            A=mat(lv["A"]), P=mat(lv["P"]), Pt=mat(lv.get("Pt")),
            dinv=_tensor(lv["dinv"], device),
            l1inv=_tensor(lv["l1inv"], device),
            lmax=_tensor(lv["lmax"], device),
            cf=None if cf is None else _tensor(cf, device, torch.int8),
        ))
    return AMGHierarchy(levels=levels,
                        coarse_inv=_tensor(d["coarse_inv"], device),
                        galerkin=bool(d.get("galerkin", True)))
