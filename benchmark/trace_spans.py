"""``run.py --trace 1`` that also reads the program's own spans:

    python3 benchmark/trace_spans.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout. The run is ``run.py``'s; its traced
segment's Chrome trace is also reduced by ``harness/program_spans.py``.
The result's last line gains ``program_spans``, the readings of
``program_spans.READINGS`` named for the cell's kind of traffic (the
suffix after the last dot) where the trace has something for them, and
``breakdown.spans``. A program without spans gives ``{}`` and ``[]``.
Once ``trace.reduce`` and ``run.measure`` keep the spans themselves, this
file goes."""

from __future__ import annotations

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent)]

import run  # noqa: E402  (sets the harness's paths and its start time)
from harness import program_spans, trace  # noqa: E402

_measure, _reduce = run.measure, trace.reduce


def measure(bench, seed: int, seconds: float, per_layer=True, **kw) -> dict:
    """``run.measure`` with the traced segment, and ``program_spans``."""
    kept = []

    def reduce(events):
        kept.append(program_spans.reduce(events))
        return _reduce(events)

    trace.reduce = reduce
    try:
        result = _measure(bench, seed, seconds, True, **kw)
    finally:
        trace.reduce = _reduce
    kind = bench.cell.traffic["kind"]
    result["program_spans"] = {
        name: value for name, fn in program_spans.READINGS.items()
        if name.rsplit(".", 1)[1] == kind
        and (value := fn(kept[-1])) is not None}
    result["breakdown"]["spans"] = program_spans.top_spans(kept[-1])
    return result


if __name__ == "__main__":
    run.measure = measure
    sys.exit(run.main(sys.argv[1:] + ["--trace", "1"]))
