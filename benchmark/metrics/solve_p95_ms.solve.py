"""The 95th percentile of single solves' times as the caller sees them
(host clock, each solve's end synchronized), over the window's solves."""

from harness.readers import p95_ms


def read(run):
    return p95_ms(run)
