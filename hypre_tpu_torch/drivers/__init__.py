"""Command-line drivers mirroring hypre's test surface.

Counterpart of ``hypre_tpu/drivers``. hypre's de-facto CLI is its test
drivers (``src/test/ij.c``): the regression suite runs them with flag
combinations and diffs iteration counts and final residual norms against
golden files (``test/runtest.sh``, ``TEST_ij/solvers.saved``). The port
has the ``ij`` driver, with the same flags and output:

    python -m hypre_tpu_torch.drivers.ij -solver 31 -n 128 128 128 -tol 1e-6

It runs on the CUDA card; ``ij.run(argv, device="cpu")`` runs it on the
CPU. The struct and sstruct drivers wait for their layers (ROADMAP.md
Queue 1 items 13 and 14).
"""
