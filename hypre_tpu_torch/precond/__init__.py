"""Algebraic preconditioners beyond AMG — hypre's parcsr_ls/distributed_ls
approximate-inverse and ILU families (counterpart of
``hypre_tpu/precond``), as batched dense sub-problems and fine-grained
fixed-point factorizations.

The names load on first use: ``amg/`` imports ``precond.common``, and the
saddle-point solvers import the BoomerAMG facade, so importing every
module here would close an import cycle.
"""

import importlib

_WHERE = {
    "FSAI": "fsai", "ParaSails": "parasails", "ILU": "ilu", "ILUT": "ilu",
    "Euclid": "euclid", "PILUT": "euclid", "Schwarz": "schwarz",
    "ILUSchurGMRES": "ilu_schur", "ILUSchurNSH": "ilu_schur",
    "PolyPrecond": "poly", "BlockPrecond": "saddle",
    "SaddleSystem": "saddle", "Uzawa": "saddle", "IC": "ic", "DDICT": "ic",
    "DDILUT": "ic", "ParILU": "par_ilu", "ParSails": "par_sails",
}

__all__ = sorted(_WHERE)


def __getattr__(name):
    if name in _WHERE:
        return getattr(importlib.import_module(
            f"hypre_tpu_torch.precond.{_WHERE[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
