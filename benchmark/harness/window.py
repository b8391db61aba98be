"""The timed window: a closed loop with one caller. Each call is sent when
the previous one has completed (its results synchronized); the window
closes at the end of the call in flight once ``seconds`` have passed, and
its measured length is what divides. Python's garbage collector is held
off while it runs."""

from __future__ import annotations

import gc
import time


def run_window(call, seconds: float, sync, clock=time.perf_counter):
    """Run ``call(i)`` for i = 0, 1, ... until ``seconds`` have passed.
    Returns (start, [(end_time, record), ...])."""
    gc.collect()
    sync()
    gc.disable()
    out = []
    try:
        t0 = clock()
        i = 0
        while True:
            rec = call(i)
            sync()
            t = clock()
            out.append((t, rec))
            i += 1
            if t - t0 >= seconds:
                break
    finally:
        gc.enable()
    return t0, out


def per_call_ms(t0: float, out: list) -> float:
    """All the window's time over the calls completed in it, in ms."""
    return 1000.0 * (out[-1][0] - t0) / len(out)


def call_ms(t0: float, out: list) -> list[float]:
    """Each call's own time, end to end, in ms."""
    ends = [t0] + [t for t, _ in out]
    return [1000.0 * (b - a) for a, b in zip(ends, ends[1:])]
