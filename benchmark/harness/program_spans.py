"""The program's own spans in a traced segment, from ``torch.profiler``'s
Chrome trace: what a reduction of the trace keeps beside ``trace.py``'s,
and four per-layer readings of it.

The program (``hypre_tpu_torch/core/timing.py::annotate``) opens spans
named ``amg.*``, ``setup.*`` and ``pcg.*`` while a profiler records; they
are ``user_annotation`` events in the same trace as the kernels. From them:

- the program spans inside the window (``bench.window``), on its thread,
  with their intervals;
- each device operation's chain of enclosing program spans, innermost
  first, found by its launch's correlation id and time on the launching
  thread, as ``trace.py``'s ``op_of`` finds an ``op:`` span;
- the device's idle intervals in the window.

A program that opens no span gives empty lists, and every reading None."""

from __future__ import annotations

import dataclasses
import re

from harness.trace import DEVICE_CATS, LAUNCH_CATS, NAME_CHARS, _merge, _x

PREFIXES = ("amg.", "setup.", "pcg.")
GALERKIN = re.compile(r"setup\.L\d+\.(ap|transpose|rap)$")
CYCLE_LEVEL = re.compile(r"amg\.L(\d+)$")


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    t0: float  # us, the trace's clock
    t1: float


@dataclasses.dataclass
class DeviceOp:
    name: str
    dur_s: float
    chain: tuple  # the program spans around its launch, innermost first


@dataclasses.dataclass
class Spans:
    window_s: float
    spans: list  # program spans in the window, by start
    ops: list  # device operations in the window
    idle: list  # [t0, t1] us, the window's device idle intervals


def _inside(inner: Span, outer: Span) -> bool:
    return outer.t0 <= inner.t0 and inner.t1 <= outer.t1


def _chains(spans: list, times: list) -> list:
    """For each launch time (ascending), the spans that hold it, innermost
    first. The spans of one thread nest, so one sweep with a stack does."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j].t0 <= t:
            s = spans[j]
            j += 1
            while stack and stack[-1].t1 < s.t0:
                stack.pop()
            stack.append(s)
        while stack and stack[-1].t1 < t:
            stack.pop()
        out.append(tuple(s for s in reversed(stack) if s.t0 <= t <= s.t1))
    return out


def reduce(events: list) -> Spans:
    wins = [e for e in _x(events, ("user_annotation",))
            if e["name"] == "bench.window"]
    if not wins:
        raise ValueError("the trace has no bench.window span")
    win = wins[0]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    spans = sorted((Span(e["name"], e["ts"], e["ts"] + e.get("dur", 0))
                    for e in _x(events, ("user_annotation",))
                    if e["name"].startswith(PREFIXES)
                    and e["tid"] == win["tid"]
                    and w0 <= e["ts"] and e["ts"] + e.get("dur", 0) <= w1),
                   key=lambda s: (s.t0, -s.t1))
    dev = [e for e in _x(events, DEVICE_CATS)
           if e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0]
    launches = {e["args"]["correlation"]: e for e in _x(events, LAUNCH_CATS)
                if "correlation" in e.get("args", {})}

    def launch_ts(e):
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None or launch["tid"] != win["tid"]:
            return None
        return launch["ts"]

    tied = sorted((t, i) for i, t in enumerate(map(launch_ts, dev))
                  if t is not None)
    chain = dict(zip((i for _, i in tied),
                     _chains(spans, [t for t, _ in tied])))
    ops = [DeviceOp(e["name"][:NAME_CHARS], e.get("dur", 0) * 1e-6,
                    chain.get(i, ())) for i, e in enumerate(dev)]
    busy = _merge([[max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)]
                   for e in dev])
    edges = [w0] + [v for ab in busy for v in ab] + [w1]
    idle = [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return Spans(window_s=(w1 - w0) * 1e-6, spans=spans, ops=ops,
                 idle=idle)


def _count(s: Spans, name: str) -> int:
    return sum(sp.name == name for sp in s.spans)


def _ms_under(s: Spans, keep) -> float:
    """Device ms of the operations whose chain ``keep`` accepts."""
    return 1e3 * sum(op.dur_s for op in s.ops if keep(op.chain))


def rejected_replay_ms(s: Spans):
    """Device ms a setup of the operations launched inside a
    ``setup.replay`` whose ``amg.setup`` then ran ``setup.slow``; 0 where
    no attempt was rejected. None where the segment has no setup."""
    setups = [sp for sp in s.spans if sp.name == "amg.setup"]
    if not setups:
        return None
    slow = [sp for sp in s.spans if sp.name == "setup.slow"]
    rejected = {r for r in s.spans if r.name == "setup.replay"
                and any(_inside(r, a) and any(_inside(w, a) for w in slow)
                        for a in setups)}
    return _ms_under(s, lambda c: any(sp in rejected for sp in c)) \
        / len(setups)


def galerkin_ms(s: Spans):
    """Device ms a setup of the operations whose innermost span is a
    level's ``ap``, ``transpose`` or ``rap`` stage, on either path."""
    steps = _count(s, "amg.setup")
    if not steps:
        return None
    return _ms_under(s, lambda c: bool(c) and bool(
        GALERKIN.match(c[0].name))) / steps


def _cycle_span(chain):
    """The innermost level span of a cycle in ``chain``, or None."""
    for sp in chain:
        if sp.name == "amg.coarse" or CYCLE_LEVEL.match(sp.name):
            return sp
    return None


def coarse_levels_ms(s: Spans):
    """Device ms a PCG iteration of the operations whose innermost cycle
    span is ``amg.L<l>`` with l >= 1 or ``amg.coarse``."""
    iters = _count(s, "pcg.iter")
    if not iters:
        return None

    def coarse(chain):
        sp = _cycle_span(chain)
        return sp is not None and (sp.name == "amg.coarse"
                                   or CYCLE_LEVEL.match(sp.name)[1] != "0")

    return _ms_under(s, coarse) / iters


def cycle_idle_share(s: Spans):
    """Share of the window, in %, in which the device is idle while the
    host is inside ``amg.cycle``."""
    cycles = _merge([[sp.t0, sp.t1] for sp in s.spans
                     if sp.name == "amg.cycle"])
    if not cycles or s.window_s <= 0:
        return None
    both, i = 0.0, 0
    for a, b in s.idle:  # both lists are sorted and disjoint
        while i < len(cycles) and cycles[i][1] <= a:
            i += 1
        k = i
        while k < len(cycles) and cycles[k][0] < b:
            both += min(b, cycles[k][1]) - max(a, cycles[k][0])
            k += 1
    return 100.0 * both * 1e-6 / s.window_s


def top_spans(s: Spans, n: int = 10) -> list:
    """The ``n`` innermost program spans by the device seconds of the
    operations launched directly under them: [[name, seconds]]."""
    by: dict = {}
    for op in s.ops:
        if op.chain:
            by[op.chain[0].name] = by.get(op.chain[0].name, 0.0) + op.dur_s
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


READINGS = {
    "rejected_replay_ms.resetup": rejected_replay_ms,
    "galerkin_ms.resetup": galerkin_ms,
    "coarse_levels_ms.solve": coarse_levels_ms,
    "cycle_idle_share.solve": cycle_idle_share,
}
