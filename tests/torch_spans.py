"""The port's program spans (``core/timing.py::annotate``) of a call, read
from ``torch.profiler`` on the CPU: each span as its path of enclosing
program spans, outermost first, in the order the spans started."""

from torch.profiler import ProfilerActivity, profile

PREFIXES = ("amg.", "setup.", "pcg.")


def span_paths(fn):
    """``fn()``'s result and the paths of the program spans it opened,
    e.g. ``("amg.setup", "setup.slow", "setup.L0.split")``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    paths = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith(PREFIXES):
            continue
        path, p = [e.name], e.cpu_parent
        while p is not None:
            if p.name.startswith(PREFIXES):
                path.append(p.name)
            p = p.cpu_parent
        paths.append(tuple(reversed(path)))
    return out, paths
