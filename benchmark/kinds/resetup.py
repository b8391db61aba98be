"""Traffic kind ``resetup``: each call builds a new operator on the
configuration's pattern, A_t = L + sigma_t I (``shift``: each step's
sigma_t, ``harness/traffic.py``), sets BoomerAMG up on it again and
solves one new right-hand side (``rhs``: its pool) from x0 = 0."""

from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext

from harness import check, trace, traffic

KEYS = {"rhs": {"pool"}, "shift": {"h", "dt_log10", "levels", "jitter"}}


class Job:
    def __init__(self, sysm, mix, log):
        self.sysm, self.mix = sysm, mix
        self._diag = list(sysm.A.shifts).index(0)

    def shifted(self, sigma: float):
        """L + sigma I, on L's pattern (the diagonal slot moves)."""
        vals = self.sysm.A.vals.clone()
        vals[:, self._diag] += sigma
        return dataclasses.replace(self.sysm.A, vals=vals)

    def start(self, seed: int) -> None:
        """The seed's inputs. The warm-up calls take the window's first
        steps' bins."""
        self.rhs = traffic.make_rhs(self.mix["rhs"], self.sysm.n,
                                    self.sysm.dtype, self.sysm.device, seed)
        self.reservoir = traffic.Reservoir(int(self.mix["sample"]), seed)
        self.last = None

    def call(self, k: int, pos: int, keep: bool = True,
             time_setup: bool = False, spans: bool = False) -> dict:
        """Call ``k`` (its right-hand side, its shift and its place in the
        sample) at step ``pos`` of the run."""
        sysm = self.sysm
        sigma = traffic.step_shift(self.mix["shift"], k, pos)
        t0 = time.perf_counter()
        A_t = self.shifted(sigma)
        with trace.span("bench.setup") if spans else nullcontext():
            amg = sysm.setup(A_t)
        setup_ms = None
        if time_setup:
            sysm.sync()
            setup_ms = 1000.0 * (time.perf_counter() - t0)
        op = sysm.operator(A_t)
        row = traffic.pool_index(k, self.mix["rhs"])
        with trace.span("bench.solve") if spans else nullcontext():
            x, info = sysm.solve(op, amg, self.rhs[row])
        if keep:
            hier = check.hierarchy_of(amg.ell_hierarchy, k, sigma)
            self.reservoir.offer((check.Sample(k=k, x=x, rhs_row=row,
                                               sigma=sigma), hier))
            self.last = (amg, hier, row)
        return {"info": info, "setup_ms": setup_ms,
                "replayed": bool(amg.hierarchy.replayed)}

    def outputs(self) -> tuple[list, list, check.Probe]:
        """What the check judges: the sampled answers and the hierarchies
        their setups built, and the last call's preconditioner on its
        right-hand side."""
        kept = self.reservoir.sample()
        amg, hier, row = self.last
        return ([s for s, _ in kept], [h for _, h in kept],
                check.cycle_probe(amg, hier, self.rhs[row]))

    def spans(self):
        return None

    def free(self):
        self.last = None
        self.reservoir = None
