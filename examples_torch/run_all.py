"""Run the tutorial examples end to end (the TEST_examples analogue), the
ports of ``examples/``:

    python3 examples_torch/run_all.py                  # on the card, float32
    python3 examples_torch/run_all.py --device cpu --dtype float64

Each example's ``main`` runs with its default sizes and its own asserts.
On the card the examples in ``FLOAT64`` run in float64 whatever ``--dtype``
says: their asserts ask for more than float32 gives (see the reasons).
"""

import argparse
import importlib
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

EXAMPLES = (
    "ex1_struct_smg",
    "ex2_struct_twobox",
    "ex3_struct_pfmg_pcg",
    "ex4_struct_varcoef",
    "ex5_ij_amg_pcg",
    "ex6_sstruct_twobox",
    "ex7_sstruct_convection",
    "ex8_sstruct_multipart",
    "ex9_sstruct_split",
    "ex10_fei_fem",
    "ex11_lobpcg",
    "ex12_sstruct_nodal",
    "ex13_star_domain",
    "ex14_sstruct_fem_star",
    "ex15_ams",
    "ex16_q3_fem",
    "ex17_ndim_laplacian",
    "ex18_sstruct_ndim",
)

# example -> why its own asserts need float64
FLOAT64 = {
    "ex1_struct_smg": (
        "standalone SMG at rtol 1e-6 stagnates near a relative residual of "
        "6e-5 in float32 on the 64^2 Laplacian (b = ones, x ~ 1e2): its "
        "assert wants convergence and a true residual below 1e-5"),
}


def load(name: str):
    """The example module ``name`` (the repository root and this directory
    put on the import path)."""
    for path in (os.path.dirname(HERE), HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    return importlib.import_module(name)


def run(device=None, dtype=None, names=EXAMPLES) -> dict:
    """Run each example; returns {name: (result of main, dtype, seconds)}.
    ``dtype`` None is each example's default (float32) except the FLOAT64
    ones, which then run in float64."""
    import torch

    out = {}
    for name in names:
        dt = dtype
        if dt is None and name in FLOAT64:
            dt = torch.float64
        t0 = time.perf_counter()
        res = load(name).main(device=device, dtype=dt)
        if device is None or str(device).startswith("cuda"):
            torch.cuda.synchronize()
        out[name] = (res, dt or torch.float32, time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--dtype", default=None, choices=("float32", "float64"))
    args = ap.parse_args(argv)
    dtype = None if args.dtype is None else getattr(torch, args.dtype)
    run(args.device, dtype)
    print("all examples passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
