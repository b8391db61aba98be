"""The program under test, built from a configuration file. The solver
knobs go through the ``ij`` driver's flag table
(``hypre_tpu_torch.drivers.ij.parse_args``) and on to the objects the
driver builds: the problem on the device (``ij.build_problem``, whatever
problem the flags name), ``optimize_operator(A).mv`` as the outer
operator on the card, ``BoomerAMG(<knobs>).setup(A)`` and
``pcg(op, b, M=amg.precond(), ...)``."""

from __future__ import annotations

import torch


def _ij():
    from hypre_tpu_torch.drivers import ij

    return ij


class System:
    def __init__(self, config: dict, device, dtype: str | None = None):
        ij = _ij()
        self.config = config
        self.device = torch.device(device)
        self.dtype_name = dtype or config["dtype"]
        self.dtype = getattr(torch, self.dtype_name)
        a = ij.parse_args(list(config["ij_flags"]))
        self.knobs = dict(
            coarsen_type=a["coarsen"], interp=a["interp"], relax=a["relax"],
            strength_threshold=a["theta"], agg_num_levels=a["agg_nl"],
            max_row_sum=a["max_row_sum"], smooth_type=a["smooth_type"],
            smooth_num_levels=a["smooth_num_levels"],
            smooth_weight=a["smooth_weight"], p_max_elmts=a["pmx"],
            num_sweeps=a["ns"], additive=a["additive"],
            additive_variant=a["add_variant"], relax_weight=a["rlx_wt"],
            cheby_eig_est=a["cheby_eig_est"], relax_order=a["relax_order"],
            setup_backend=config["setup_backend"])
        self.pcg_kw = dict(
            rtol=a["tol"], maxiter=a["max_iter"],
            recompute_residual=bool(a["recompute_res"]),
            recompute_residual_p=a["recompute_res_p"], device=self.device)
        self.A = ij.build_problem(a, self.dtype, self.device)
        self.n = self.A.n_rows

    def setup(self, A):
        from hypre_tpu_torch.amg.boomeramg import BoomerAMG

        return BoomerAMG(**self.knobs).setup(A, device=self.device)

    def operator(self, A):
        """The outer operator the ij driver applies (its ``mv``): the
        kernel format on the card, A itself elsewhere."""
        from hypre_tpu_torch.seq.fastmv import optimize_operator

        return optimize_operator(A) if self.device.type == "cuda" else A

    def solve(self, op, amg, b):
        from hypre_tpu_torch.krylov import pcg

        return pcg(op.mv, b, M=amg.precond(), **self.pcg_kw)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
