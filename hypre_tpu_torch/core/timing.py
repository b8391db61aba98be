"""Named timer registry, the counterpart of hypre's timing layer.

Counterpart of ``hypre_tpu/core/timing.py``. hypre keeps named timers
behind ``hypre_InitializeTiming`` / ``hypre_BeginTiming``
(``utilities/timing.h:59``) and marks regions for Caliper/NVTX
(``utilities/caliper_instrumentation.h:35-56``). Here:

- host wall timers around setup phases (``TimerRegistry``); a timer that
  wraps device work synchronizes first, so that asynchronous launches do
  not hide the cost (a no-op for CPU tensors);
- ``annotate`` marks a region for ``torch.profiler`` traces
  (``record_function``), as ``HYPRE_ANNOTATE_FUNC`` and
  ``HYPRE_ANNOTATE_MGLEVEL_BEGIN`` do. It costs a check of one flag when
  no profiler records, and it never synchronizes;
- ``device_memory_report`` reads the CUDA caching allocator's counters.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


def _synchronize(sync) -> None:
    """Wait for the device work behind ``sync``: True for the current CUDA
    device, or a tensor (list, tuple, dict) whose CUDA devices are
    synchronized. CPU tensors need no wait."""
    if sync is True:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    if isinstance(sync, dict):
        sync = list(sync.values())
    if isinstance(sync, (list, tuple)):
        for s in sync:
            _synchronize(s)
        return
    if isinstance(sync, torch.Tensor) and sync.device.type == "cuda":
        torch.cuda.synchronize(sync.device)


class TimerRegistry:
    """Accumulating named wall-clock timers (hypre_InitializeTiming
    analogue)."""

    def __init__(self) -> None:
        self._elapsed: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, sync: object = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            self._elapsed[name] += time.perf_counter() - t0
            self._count[name] += 1

    def elapsed(self, name: str) -> float:
        return self._elapsed[name]

    def report(self) -> str:
        lines = ["=" * 60]
        for name in sorted(self._elapsed):
            lines.append(
                f"{name:<40s} {self._elapsed[name]:10.4f} s  "
                f"({self._count[name]} calls)")
        lines.append("=" * 60)
        return "\n".join(lines)

    def clear(self) -> None:
        self._elapsed.clear()
        self._count.clear()


GLOBAL_TIMERS = TimerRegistry()


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name`` in the trace of a recording
    ``torch.profiler`` (HYPRE_ANNOTATE_* analogue): ``record_function``
    while a profiler records, else one shared no-op context. The port's
    spans: ``amg.setup`` and ``amg.formats`` (``BoomerAMG.setup``);
    ``setup.replay``, ``setup.slow``, ``setup.L<l>.<stage>`` and
    ``setup.coarse_inv`` (``setup_hierarchy_device``); ``amg.cycle``,
    ``amg.L<l>`` and ``amg.coarse`` (``amg_cycle``); ``pcg.solve`` and
    ``pcg.iter`` (``pcg``)."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def device_memory_report(device=None) -> str:
    """What the CUDA caching allocator holds now and at most since its
    last reset (the role of hypre's --enable-memory-tracker ledger,
    ``utilities/memory.h:139-161``: tensors are freed when unreferenced,
    so the failure mode is retention, not leaks). Without a card there is
    no device memory to report."""
    if not torch.cuda.is_available():
        return "no CUDA device: no device memory to report"
    now = torch.cuda.memory_allocated(device)
    peak = torch.cuda.max_memory_allocated(device)
    reserved = torch.cuda.memory_reserved(device)
    return (f"device memory: {now / 1e6:.1f} MB allocated, "
            f"{peak / 1e6:.1f} MB peak, {reserved / 1e6:.1f} MB reserved")
