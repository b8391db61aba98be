"""Traffic kind ``solve``: one operator, set up once in set-up; each call
solves a new right-hand side from x0 = 0 (``rhs``: its pool)."""

from __future__ import annotations

import time
from contextlib import nullcontext

from harness import check, trace, traffic
from harness.spans import Spans

KEYS = {"rhs": {"pool"}}


class Job:
    def __init__(self, sysm, mix, log):
        self.sysm, self.mix = sysm, mix
        t0 = time.perf_counter()
        self.amg = sysm.setup(sysm.A)
        sysm.sync()
        log(f"set-up: {sysm.knobs['setup_backend']} setup "
            f"({self.amg.setup_path}) {time.perf_counter() - t0:.3f} s")
        self.op = sysm.operator(sysm.A)

    def start(self, seed: int) -> None:
        """The seed's inputs, made ahead on the device."""
        self.rhs = traffic.make_rhs(self.mix["rhs"], self.sysm.n,
                                    self.sysm.dtype, self.sysm.device, seed)
        self.reservoir = traffic.Reservoir(int(self.mix["sample"]), seed)

    def call(self, k: int, pos: int, keep: bool = True,
             time_setup: bool = False, spans: bool = False) -> dict:
        row = traffic.pool_index(k, self.mix["rhs"])
        with trace.span("bench.solve") if spans else nullcontext():
            x, info = self.sysm.solve(self.op, self.amg, self.rhs[row])
        if keep:
            self.reservoir.offer(check.Sample(k=k, x=x, rhs_row=row))
        return {"info": info}

    def outputs(self) -> tuple[list, list, check.Probe]:
        """What the check judges: the sampled answers, the hierarchy,
        and the preconditioner on the first right-hand side."""
        hier = check.hierarchy_of(self.amg.ell_hierarchy, 0, 0.0)
        return (self.reservoir.sample(), [hier],
                check.cycle_probe(self.amg, hier, self.rhs[0]))

    def spans(self):
        return Spans(self.sysm.A, self.amg, self.op)

    def free(self):
        del self.amg, self.op
