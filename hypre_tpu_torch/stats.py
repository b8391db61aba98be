"""Solver statistics and per-iteration logs in hypre's print format.

Counterpart of ``hypre_tpu/stats.py``, the two outputs the ``ij`` driver
prints under ``-poutdat``:

- the Krylov per-iteration residual table (``krylov/pcg.c:607-655``, the
  print_level block): a header and ``% 5d    %e    %f    %e`` rows
  (iteration, ||r||, convergence rate, ||r||/||b||), from the
  ``res_history`` the solvers record under ``logging > 0``;
- the BoomerAMG setup report (``parcsr_ls/par_stats.c``): each level's
  operator matrix information and the grid and operator complexities.
"""

from __future__ import annotations

import numpy as np


def format_iteration_log(info, b_norm: float, two_norm: bool = True) -> str:
    """info.res_history in hypre's PCG/GMRES print_level > 1 format."""
    norms = np.asarray(info.res_history.cpu())
    lines = []
    if two_norm:
        lines.append("Iters       ||r||_2     conv.rate  ||r||_2/||b||_2")
        lines.append("-----    ------------   ---------  ------------ ")
    else:
        lines.append("Iters       ||r||_C     conv.rate  ||r||_C/||b||_C")
        lines.append("-----    ------------    ---------  ------------ ")
    bn = float(b_norm)
    for i in range(1, len(norms)):
        if norms[i] < 0:
            break
        prev = norms[i - 1] if norms[i - 1] > 0 else 1.0
        rel = norms[i] / bn if bn > 0 else 0.0
        lines.append(
            "% 5d    %e    %f    %e" % (i, norms[i], norms[i] / prev, rel))
    return "\n".join(lines)


def _host_ell(A):
    """(cols, vals) of an EllMatrix as host arrays."""
    return A.cols.cpu().numpy(), A.vals.cpu().numpy()


def _level_matrix_rows(levels_A):
    rows = []
    for i, A in enumerate(levels_A):
        cols, vals = _host_ell(A)
        valid = cols >= 0
        per_row = valid.sum(axis=1)
        nnz = int(per_row.sum())
        n = A.n_rows
        row_sums = np.where(valid, vals, 0).sum(axis=1)
        rows.append(dict(
            lev=i, rows=n, entries=nnz, sparse=nnz / (n * max(A.n_cols, 1)),
            minr=int(per_row.min(initial=0)),
            maxr=int(per_row.max(initial=0)),
            avgr=nnz / max(n, 1),
            min_rs=float(row_sums.min(initial=0)),
            max_rs=float(row_sums.max(initial=0))))
    return rows


def amg_setup_report(
    hier,
    strength_threshold: float = 0.25,
    trunc_factor: float = 0.0,
    coarsen: str = "pmis",
    interp: str = "ext+i",
    max_levels: int = 25,
) -> str:
    """The par_stats.c setup report of an AMGHierarchy whose level
    operators are EllMatrix (the facade keeps that form of its hierarchy
    as ``ell_hierarchy`` when it swaps in the kernel formats).

    The layout follows hypre_BoomerAMGSetupStats: the parameters, each
    level's operator matrix information, the interpolation information,
    and the grid and operator complexities, with hypre's labels.
    """
    coarsen_names = {
        "cljp": "Cleary-Luby-Jones-Plassman", "ruge": "Ruge",
        "falgout": "Falgout-CLJP", "pmis": "PMIS", "hmis": "HMIS",
        "cgc": "CGC", "cr": "CR",
    }
    interp_names = {
        "classical": "modified classical interpolation",
        "direct": "direct interpolation",
        "multipass": "multipass interpolation",
        "ext+i": "extended+i interpolation",
    }
    levels_A = [lev.A for lev in hier.levels]
    # the coarsest operator lives only as its dense inverse; report its size
    nc = hier.coarse_inv.shape[0]
    out = ["\nBoomerAMG SETUP PARAMETERS:\n",
           f" Max levels = {max_levels}",
           f" Num levels = {len(levels_A) + 1}\n",
           f" Strength Threshold = {strength_threshold:f}",
           f" Interpolation Truncation Factor = {trunc_factor:f}\n",
           f" Coarsening Type = {coarsen_names.get(coarsen, coarsen)} ",
           f" Interpolation = {interp_names.get(interp, interp)}",
           "\nOperator Matrix Information:\n",
           "            nonzero            entries/row          row sums",
           "lev    rows  entries  sparse  min  max     avg        min"
           "         max",
           "=" * 75]
    rows = _level_matrix_rows(levels_A)
    tot_rows = sum(r["rows"] for r in rows) + nc
    tot_nnz = sum(r["entries"] for r in rows)
    for r in rows:
        out.append(
            "%3d %7d %8d  %0.3f %4d %4d  %6.1f  %10.3e  %10.3e"
            % (r["lev"], r["rows"], r["entries"], r["sparse"], r["minr"],
               r["maxr"], r["avgr"], r["min_rs"], r["max_rs"]))
    out.append("%3d %7d %8s  %s" % (len(rows), nc, "dense", "(direct solve)"))
    out.append("\n\nInterpolation Matrix Information:")
    out.append("lev    rows x cols    entries/row    min        max     ")
    out.append("=" * 60)
    for i, lev in enumerate(hier.levels):
        P = lev.P
        pcols, pvals = _host_ell(P)
        valid = pcols >= 0
        per_row = valid.sum(axis=1)
        wmin = float(np.where(valid, pvals, np.inf).min(initial=np.inf))
        wmax = float(np.where(valid, pvals, -np.inf).max(initial=-np.inf))
        out.append(
            "%3d %7d x %-7d  %2d  %2d   %10.3e %10.3e"
            % (i, P.n_rows, P.n_cols, int(per_row.min(initial=0)),
               int(per_row.max(initial=0)), wmin, wmax))
    if rows:
        grid_c = tot_rows / max(rows[0]["rows"], 1)
        # the operator complexity counts the dense coarse block, as hypre
        # counts its coarsest CSR
        op_c = (tot_nnz + nc * nc) / max(rows[0]["entries"], 1)
    else:
        grid_c = op_c = 1.0
    out.append("\n\n     Complexity:    grid = %f" % grid_c)
    out.append("                operator = %f" % op_c)
    out.append("\n")
    return "\n".join(out)
