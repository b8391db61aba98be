"""Algebraic multigrid: strength, coarsening, interpolation, smoothers,
hierarchy, and the BoomerAMG facade."""
from hypre_tpu_torch.amg.boomeramg import BoomerAMG
from hypre_tpu_torch.amg.smoothed_agg import SmoothedAggAMG
