"""Command-line drivers mirroring hypre's test surface.

Counterpart of ``hypre_tpu/drivers``. hypre's de-facto CLI is its test
drivers (``src/test/ij.c``): the regression suite runs them with flag
combinations and diffs iteration counts and final residual norms against
golden files (``test/runtest.sh``, ``TEST_ij/solvers.saved``). The port
has the ``ij``, ``struct`` and ``sstruct`` drivers, with the same flags
and output:

    python -m hypre_tpu_torch.drivers.ij -solver 31 -n 128 128 128 -tol 1e-6
    python -m hypre_tpu_torch.drivers.struct -solver 11 -n 64 64 1
    python -m hypre_tpu_torch.drivers.sstruct -solver 11 -n 64

They run on the CUDA card; ``run(argv, device="cpu")`` runs them on the
CPU.
"""
