"""Faults planted in the timed path underneath a built cell: the output
check's fault readings (``control.py --faults``) and its tests. Each
fault is planted in every BoomerAMG the cell sets up while it is in
place, and in the one its set-up already built; leaving the ``with``
block takes it out again.

- ``sweep_skipped``: the cycle's smoothing sweep on the way up left out
  on every level;
- ``coarsest_dropped``: the coarsest level's correction left out (its
  direct solve returns zero), as a hierarchy cut short would;
- ``cycle_bf16``: the cycle's input and output rounded to bfloat16."""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch


def sweep_skipped(amg):
    orig, seen = amg._smoother, {}

    def smoother(lev, u, f):
        seen[id(lev)] = seen.get(id(lev), 0) + 1
        return u if seen[id(lev)] % 2 == 0 else orig(lev, u, f)

    amg._smoother = smoother
    return lambda: setattr(amg, "_smoother", orig)


def coarsest_dropped(amg):
    orig = amg.hierarchy
    amg.hierarchy = dataclasses.replace(
        orig, coarse_inv=torch.zeros_like(orig.coarse_inv))
    return lambda: setattr(amg, "hierarchy", orig)


def cycle_bf16(amg):
    orig = amg.cycle

    def cycle(f, u=None):
        dt = f.dtype
        return orig(f.to(torch.bfloat16).to(dt), u).to(
            torch.bfloat16).to(dt)

    amg.cycle = cycle
    return lambda: vars(amg).pop("cycle", None)


FAULTS = {"sweep_skipped": sweep_skipped,
          "coarsest_dropped": coarsest_dropped, "cycle_bf16": cycle_bf16}


@contextmanager
def planted(bench, name: str):
    plant, sysm = FAULTS[name], bench.sysm
    orig_setup, undo = sysm.setup, None

    def setup(A):
        # a BoomerAMG set up in the block ends with it: no undo is kept,
        # which would keep every such hierarchy alive
        amg = orig_setup(A)
        plant(amg)
        return amg

    sysm.setup = setup
    if getattr(bench.job, "amg", None) is not None:
        undo = plant(bench.job.amg)
    try:
        yield
    finally:
        del sysm.setup
        if undo is not None:
            undo()
