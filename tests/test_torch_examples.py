"""The tutorial examples' ports (``examples_torch/``) against the
reference's (``examples/``), both run live.

Each case runs the reference example at its default size under the
tests' x64 and the port's in float64 on the CPU. The port passes its own
asserts, takes the reference's iteration count and stops at the
reference's relative residual (RESIDUAL_RTOL, RESIDUAL_ATOL); ex11's
eigenvalues agree with the reference's to EX11_RTOL. The counts and
eigenvalues that ``chip_smoke.py`` holds the card to (it cannot run the
reference) must be the ones the reference gives here.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import EX11_EIGENVALUES, EX11_RTOL, EXAMPLE_ITERATIONS
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p.stem for p in (ROOT / "examples").glob("ex*.py"))
# The same iterations in another summation order end at the reference's
# relative residual to ~2e-6 (ex16, 35 iterations); ex14 converges in one
# iteration to rounding level (7e-15 against 5e-15).
RESIDUAL_RTOL = 1e-5
RESIDUAL_ATOL = 1e-13


def load(directory: str, name: str):
    """An example module by file, under a name of its own (the two
    directories hold modules of the same names)."""
    path = ROOT / directory / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{directory}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_examples_are_the_references():
    port = sorted(p.stem for p in (ROOT / "examples_torch").glob("ex*.py"))
    assert port == EXAMPLES
    assert sorted(load("examples_torch", "run_all").EXAMPLES) == port
    assert sorted([*EXAMPLE_ITERATIONS, "ex11_lobpcg"]) == port


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_takes_the_reference_count(name, monkeypatch, tmp_path):
    monkeypatch.setenv("HYPRE_TPU_TORCH_SHAPE_REGISTRY",
                       str(tmp_path / "port_shapes.json"))
    monkeypatch.setenv("HYPRE_TPU_SHAPE_REGISTRY",
                       str(tmp_path / "reference_shapes.json"))
    want = load("examples", name).main()
    got = load("examples_torch", name).main(device="cpu",
                                            dtype=torch.float64)
    if name == "ex11_lobpcg":
        want = np.sort(np.asarray(want))
        np.testing.assert_allclose(np.sort(got.numpy()), want,
                                   rtol=EX11_RTOL)
        np.testing.assert_allclose(EX11_EIGENVALUES, want, rtol=EX11_RTOL)
        return
    assert bool(got.converged)
    assert int(got.iterations) == int(want.iterations)
    assert EXAMPLE_ITERATIONS[name] == int(want.iterations)
    np.testing.assert_allclose(float(got.relative_residual),
                               float(want.relative_residual),
                               rtol=RESIDUAL_RTOL, atol=RESIDUAL_ATOL)
