"""One short run of each cell on the card (marked gpu; skips without a
card): the whole path, kernels and trace included, comes out correct."""

import pytest
import run
import torch


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["ij7_solve", "ij27_solve",
                                      "ij7_resetup"])
def test_a_short_run_on_the_card_is_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = run.measure(run.build(workload), 2 ** 35 + 3, 2.0, True)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
