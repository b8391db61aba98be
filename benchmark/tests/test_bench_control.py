"""The output check's control, at a size a test run holds: the
configuration computed in the precision below its own comes out not
correct (float32 cells: the plain reference in bfloat16 in the program's
place; the float64 cell: the program's own float32 path), on its answers
and on its cycle."""

import control
import pytest
import small
from harness import spec

SEEDS = [2 ** 33 + 5]


@pytest.mark.parametrize("workload", ["ij7_solve", "ij27_solve",
                                      "ij7_resetup"])
def test_the_control_is_not_correct(workload):
    cell = spec.load_cell(workload)
    # the 27-pt f64 cell's control is float32: its floor shows from a
    # few thousand rows on
    grid = (24, 24, 16) if cell.config["dtype"] == "float64" else (24, 24, 12)
    lines = list(control.control_readings(
        workload, SEEDS, 0.3, device="cpu",
        config_patch=small.patch(cell.config, grid)))
    assert lines and all(not line["correct"] for line in lines)
    for line in lines:
        for number in ("residual", "cycle_gap"):
            r = line["checks"][number]
            assert r["value"] > r["limit"], number
