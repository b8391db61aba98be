"""Arithmetic the metric readers share. Every reader returns None where
its run has nothing for it to read; which cells report a metric is
``BENCHMARK.json``'s to say, not the reader's."""

from __future__ import annotations

import statistics

from harness.roofline import bound_s


def values_of(run, key: str) -> list:
    """The window's calls' readings of ``key``, where they have one."""
    return [c[key] for c in run.calls if c.get(key) is not None]


def mean_of(run, key: str):
    v = values_of(run, key)
    return statistics.fmean(v) if v else None


def p95_ms(run):
    ms = values_of(run, "ms")
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]


def share_of(run, key: str):
    v = values_of(run, key)
    return 100.0 * sum(map(bool, v)) / len(v) if v else None


def idle_share(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def launches_per_iter(run):
    if run.trace is None or run.trace_iterations <= 0:
        return None
    return len(run.trace.kernels) / run.trace_iterations


def roofline_share(run, op_kind: str, name_part: str):
    """Share of the roofline of the kernels whose name holds
    ``name_part``: the least time of the functions they applied over
    their device time, in %. None where no such kernel ran, or where one
    of them cannot be tied to an operator whose bytes are known."""
    if run.trace is None:
        return None
    ks = [k for k in run.trace.kernels if name_part in k.name]
    if not ks:
        return None
    least = 0.0
    for k in ks:
        op = run.operators.get(k.op)
        if op is None or op["kind"] != op_kind:
            return None
        b = bound_s(op["bytes"], op["flops"], run.dtype, run.device_kind)
        if b is None:
            return None
        least += b
    spent = sum(k.dur_s for k in ks)
    return 100.0 * least / spent if spent > 0 else None
