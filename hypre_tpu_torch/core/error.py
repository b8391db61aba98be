"""hypre-style error flag (``utilities/error.h``, HYPRE_utilities.h:106-140).

Counterpart of ``hypre_tpu/core/error.py``. The reference keeps a
process-global bit-coded error flag that every API call ORs into
(GENERIC/MEMORY/ARG/CONV, with the offending argument's index in the high
bits) plus the ``HYPRE_GetError`` / ``HYPRE_CheckError`` /
``HYPRE_DescribeError`` / ``HYPRE_ClearAllErrors`` accessors. Python has
exceptions for hard failures, so the flag covers what exceptions do not:
conditions the reference reports without aborting, above all
``HYPRE_ERROR_CONV`` (a solver did not converge; ``krylov/pcg.c`` flags it
and goes on). The drivers record convergence failures here, and user code
polls the flag as a hypre application would.
"""

from __future__ import annotations

import threading

HYPRE_ERROR_GENERIC = 1  # generic error
HYPRE_ERROR_MEMORY = 2  # unable to allocate memory
HYPRE_ERROR_ARG = 4  # argument error
HYPRE_ERROR_CONV = 256  # method did not converge as expected

_ARG_SHIFT = 3  # hypre encodes the 1-based argument index at bits 3..5

_state = threading.local()


def _flag() -> int:
    return getattr(_state, "flag", 0)


def set_error(code: int) -> int:
    """OR a condition into the flag (hypre_error_handler)."""
    _state.flag = _flag() | int(code)
    return _state.flag


def set_error_arg(code: int, arg_index: int) -> int:
    """Argument error with the 1-based index encoded (hypre_error_in_arg)."""
    return set_error(int(code) | (int(arg_index) << _ARG_SHIFT))


def get_error() -> int:
    """HYPRE_GetError: the accumulated bit-coded flag (0 = no error)."""
    return _flag()


def check_error(ierr: int, code: int) -> bool:
    """HYPRE_CheckError: does ``ierr`` contain condition ``code``?"""
    return bool(int(ierr) & int(code))


def get_error_arg() -> int:
    """HYPRE_GetErrorArg: the encoded argument index of the last ARG error."""
    return (_flag() >> _ARG_SHIFT) & 0b111


def clear_all_errors() -> None:
    """HYPRE_ClearAllErrors."""
    _state.flag = 0


def describe_error(ierr: int) -> str:
    """HYPRE_DescribeError: a flag as text (error.c's wording)."""
    if ierr == 0:
        return "[No error] "
    parts = []
    if ierr & HYPRE_ERROR_GENERIC:
        parts.append("[Generic error] ")
    if ierr & HYPRE_ERROR_MEMORY:
        parts.append("[Memory error] ")
    if ierr & HYPRE_ERROR_ARG:
        parts.append(f"[Error in argument {(ierr >> _ARG_SHIFT) & 0b111}] ")
    if ierr & HYPRE_ERROR_CONV:
        parts.append("[Method did not converge] ")
    return "".join(parts)


def record_convergence(info) -> None:
    """Flag HYPRE_ERROR_CONV when a solve's ConvergenceInfo reports failure
    (what hypre's Krylov solvers do instead of aborting, pcg.c)."""
    if not bool(info.converged):
        set_error(HYPRE_ERROR_CONV)
