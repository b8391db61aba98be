"""Core runtime: dtype and device policy, convergence status, shared helpers.

PyTorch counterpart of ``hypre_tpu/core/config.py``. The reference follows
JAX's global x64 flag for its real type; here every constructor takes an
explicit ``dtype`` (float32 when omitted) and an explicit ``device``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no card and no device they raise instead of
carrying on on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# ---------------------------------------------------------------------------
# dtype and device policy
# ---------------------------------------------------------------------------


def default_real_dtype() -> torch.dtype:
    """hypre builds pick float/double at configure time; the port takes an
    explicit dtype argument and defaults to float32."""
    return torch.float32


def default_int_dtype() -> torch.dtype:
    """hypre_Int is 32-bit by default (``HYPRE_utilities.h:50``)."""
    return torch.int32


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another one. Raises when no device is named and there is no card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hypre_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def host_tensor(values, dtype, device) -> torch.Tensor:
    """A small host sequence as a tensor on ``device``. To a card it goes
    from pinned memory without waiting: a copy from pageable memory waits
    for all the work queued before it, a read-back in all but name."""
    t = torch.tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def tensors_to(obj, device):
    """Copy of a frozen dataclass (or list/tuple of them) with every tensor
    field moved to ``device``; non-tensor fields are kept as they are."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(tensors_to(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, (torch.Tensor, list)) or (
                dataclasses.is_dataclass(v) and not isinstance(v, type)
            ):
                changes[f.name] = tensors_to(v, device)
        return dataclasses.replace(obj, **changes)
    return obj


# Sentinel column index for padding slots in static-shape sparse formats.
# Padded slots carry value 0.0 so they are numerically inert; structural ops
# must mask with ``cols >= 0``.
PAD_COL = -1


# ---------------------------------------------------------------------------
# Convergence status (hypre's HYPRE_ERROR_CONV analogue, HYPRE_utilities.h:110)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvergenceInfo:
    """Result record returned by every iterative solver.

    iterations: int32 scalar; relative_residual: real scalar, final
    ||r|| / ||b||; converged: bool scalar. res_history holds the
    per-iteration ||r|| norms when the solver's logging > 0 (length
    maxiter+1, slot 0 = initial residual, untouched slots = -1).
    stagnated is True when the solver stopped early because the true
    residual stopped improving above the tolerance.
    """

    iterations: torch.Tensor
    relative_residual: torch.Tensor
    converged: torch.Tensor
    res_history: Optional[torch.Tensor] = None
    stagnated: Optional[torch.Tensor] = None

    def to(self, device) -> "ConvergenceInfo":
        return tensors_to(self, device)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"ConvergenceInfo(iters={int(self.iterations)}, "
            f"rel_res={float(self.relative_residual):.3e}, "
            f"converged={bool(self.converged)})"
        )


def make_convergence_info(
    iterations, relative_residual, converged, res_history=None,
    stagnated=None,
) -> ConvergenceInfo:
    def as_t(v, dtype=None):
        if isinstance(v, torch.Tensor):
            return v.to(dtype) if dtype is not None else v
        return torch.tensor(v, dtype=dtype)

    return ConvergenceInfo(
        iterations=as_t(iterations, torch.int32),
        relative_residual=as_t(relative_residual),
        converged=as_t(converged, torch.bool),
        res_history=res_history,
        stagnated=None if stagnated is None else as_t(stagnated, torch.bool),
    )


# ---------------------------------------------------------------------------
# Deterministic RNG helper (hypre's utilities/random.c LCG analogue)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mul_lo32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of x * c for 0 <= x, c < 2^32, in int64 without
    overflow: split c into 16-bit halves (the high half's product only
    matters through its low 16 bits)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def hash_rand01(indices: torch.Tensor) -> torch.Tensor:
    """Deterministic per-index uniform(0,1) float32 values from an integer
    hash, bit-identical to the reference's uint32 hash (PMIS tie-breaks on
    it). torch has no usable uint32 multiply, so the hash runs in int64
    with a 32-bit mask after every multiply and shift."""
    x = indices.to(torch.int64) & _MASK32
    x = _mul_lo32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul_lo32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x.to(torch.float32) * (1.0 / 4294967296.0)


# ---------------------------------------------------------------------------
# Small math helpers shared across layers
# ---------------------------------------------------------------------------


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def fold_sum(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Sum over a short axis (ELL slots) as a left-to-right chain of adds.

    The order of the adds is fixed, so the result is the same bit for bit
    on the CPU and on the card; the setup's tie-breaks (truncation ranks,
    strength thresholds) then make the same choices on both.
    """
    n = x.shape[dim]
    if n == 0:
        shape = list(x.shape)
        del shape[dim]
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    acc = x.select(dim, 0)
    for j in range(1, n):
        acc = acc + x.select(dim, j)
    return acc
