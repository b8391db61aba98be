"""The traced segment of a ``--trace 1`` run and the reduction of its
device trace (``torch.profiler``'s Chrome trace) to numbers:

- the window: the host span ``bench.window``, which ends after a
  synchronize;
- device activity: kernels, copies and sets clipped to the window; busy
  seconds are their union;
- each kernel's operator: the innermost ``op:<name>`` span around the
  host call that launched it (matched by the launch's correlation id);
- the top device operations by time, and the longest idle gaps named by
  what the host was doing (``<bench span>/<innermost host event>``)."""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
from contextlib import contextmanager

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
NAME_CHARS = 96


@dataclasses.dataclass
class Kernel:
    name: str
    dur_s: float
    op: str  # the op:<name> span that launched it, or ""


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list
    device_ops: list  # [[name, seconds]] top 10
    idle_gaps: list  # [[name, seconds]] top 10


@contextmanager
def span(name: str):
    """A host span in the trace (a no-op cost when no profiler runs)."""
    import torch

    with torch.profiler.record_function(name):
        yield


def _x(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(evs, t):
    """The shortest event of ``evs`` whose interval holds t."""
    best = None
    for e in evs:
        if e["ts"] <= t <= e["ts"] + e.get("dur", 0) and (
                best is None or e.get("dur", 0) < best.get("dur", 0)):
            best = e
    return best


def reduce(events: list) -> Trace:
    wins = [e for e in _x(events, ("user_annotation",))
            if e["name"] == "bench.window"]
    if not wins:
        raise ValueError("the trace has no bench.window span")
    win = wins[0]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = [e for e in _x(events, DEVICE_CATS)
           if e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0]
    merged = _merge([[max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)]
                     for e in dev])
    busy_us = sum(b - a for a, b in merged)

    # the op:<name> span around each kernel's launch
    launches = {e["args"]["correlation"]: e for e in _x(events, LAUNCH_CATS)
                if "correlation" in e.get("args", {})}
    ops = sorted((e for e in _x(events, ("user_annotation",))
                  if e["name"].startswith("op:")), key=lambda e: e["ts"])
    starts = [e["ts"] for e in ops]

    def op_of(kernel):
        launch = launches.get(kernel.get("args", {}).get("correlation"))
        if launch is None:
            return ""
        t = launch["ts"]
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or ops[i]["ts"] + ops[i]["dur"] < t \
                or ops[i]["tid"] != launch["tid"]:
            return ""
        return ops[i]["name"][3:]

    kernels = [Kernel(e["name"], e.get("dur", 0) * 1e-6, op_of(e))
               for e in dev if e["cat"] == "kernel"]
    by_name: dict = {}
    for e in dev:
        key = e["name"][:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + e.get("dur", 0) * 1e-6
    device_ops = sorted(([k, v] for k, v in by_name.items()),
                        key=lambda kv: -kv[1])[:10]

    edges = [w0] + [v for ab in merged for v in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    host = [e for e in _x(events, HOST_CATS) if e["tid"] == win["tid"]
            and e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0
            and e is not win]
    bench_spans = [e for e in host if e["name"].startswith("bench.")]
    others = [e for e in host if not e["name"].startswith(("bench.", "op:"))]
    idle_gaps = []
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        outer = _innermost(bench_spans, mid)
        inner = _innermost(others, mid)
        name = (f"{outer['name'][6:] if outer else 'window'}/"
                f"{inner['name'][:NAME_CHARS] if inner else 'idle'}")
        idle_gaps.append([name, length * 1e-6])
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                 kernels=kernels, device_ops=device_ops,
                 idle_gaps=idle_gaps)


def profile(fn, path: str, sync) -> Trace:
    """Run ``fn`` under ``torch.profiler`` inside the span
    ``bench.window`` (ended by ``sync``), write the Chrome trace to
    ``path``, reduce it and delete the file."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with span("bench.window"):
            fn()
            sync()
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events)
