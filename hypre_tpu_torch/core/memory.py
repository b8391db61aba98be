"""Device-memory budget and the pre-dispatch pressure guard.

Counterpart of the part of ``hypre_tpu/core/memory.py`` that the device
setup calls: the card's memory limit and free bytes from
``torch.cuda.mem_get_info``, and ``check_hbm_request``, which refuses a
planned allocation that cannot fit before any work is queued. On a CPU
device there is no budget to read and the guard passes.
"""

from __future__ import annotations

import torch


def _cuda_device(device):
    device = torch.device("cuda" if device is None else device)
    return device if device.type == "cuda" else None


def hbm_bytes_limit(device=None) -> int:
    """Total device memory in bytes (0 for a CPU device)."""
    dev = _cuda_device(device)
    if dev is None:
        return 0
    return int(torch.cuda.mem_get_info(dev)[1])


def hbm_bytes_free(device=None) -> int:
    """Free device memory in bytes (0 for a CPU device)."""
    dev = _cuda_device(device)
    if dev is None:
        return 0
    return int(torch.cuda.mem_get_info(dev)[0])


def check_hbm_request(n_bytes: int, device=None, headroom: float = 0.9):
    """Raise MemoryError if a planned allocation exceeds ``headroom`` of
    the device's memory; passes on a CPU device."""
    if _cuda_device(device) is None:
        return
    total = hbm_bytes_limit(device)
    if n_bytes > int(headroom * total):
        raise MemoryError(
            f"planned device allocation {n_bytes / 2**30:.2f} GiB exceeds "
            f"{headroom:.0%} of the {total / 2**30:.2f} GiB device memory; "
            "increase chunking/blocking (see amg/device_setup.py slab "
            "budgets)")
