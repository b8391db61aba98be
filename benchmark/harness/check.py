"""The output check. What the timed window produced is judged by the plain
reference (``reference/``), which builds its own operator from the
configuration and reads the program's outputs only to judge them. The
numbers a cell compares are the keys of ``limits/<workload>.json``, each
read by ``checks/<number>.py`` from a ``Judged``; the run is correct when
every number is within its limit.

The program's outputs judged: the answers of the sampled calls (a
reservoir of the window's calls drawn from the seed, plus the last
call), every call's convergence record, the hierarchies that the sampled
calls' setups built (their level operators and transfers, as plain
arrays), and the program's preconditioner applied to one vector once the
window has closed, with the hierarchy it ran on."""

from __future__ import annotations

import dataclasses

import torch

from harness import spec


@dataclasses.dataclass
class Sample:
    """One call of the window, kept for the check: its index, the answer,
    the rhs row and the shift."""

    k: int
    x: torch.Tensor
    rhs_row: int
    sigma: float = 0.0


@dataclasses.dataclass
class Hierarchy:
    """A hierarchy a setup built, for call ``k`` at shift ``sigma``:
    ``levels`` [(A, P)], each (vals, cols, n_cols) at its true size, and
    the coarsest level's (pseudo-)inverse."""

    k: int
    sigma: float
    levels: list
    coarse_inv: torch.Tensor


@dataclasses.dataclass
class Probe:
    """The program's preconditioner z = M f on a hierarchy."""

    hierarchy: Hierarchy
    f: torch.Tensor
    z: torch.Tensor


@dataclasses.dataclass
class Judged:
    samples: list
    hierarchies: list
    probe: Probe | None
    calls: list  # {"iterations", "converged"} of every call of the window
    rhs: torch.Tensor
    problem: object  # the reference's operator
    config: dict
    seed: int


def hierarchy_of(ell_hier, k: int, sigma: float) -> Hierarchy:
    """A hierarchy's levels (all but the coarsest) as (vals, cols,
    n_cols) views at each level's true size, and its coarse inverse."""
    levels = ell_hier.levels
    true = ell_hier.n_level_true or tuple(
        lv.A.n_rows for lv in levels) + (ell_hier.coarse_inv.shape[0],)
    nc = int(true[-1])
    return Hierarchy(k, sigma, [
        ((lv.A.vals[:true[l]], lv.A.cols[:true[l]], int(true[l])),
         (lv.P.vals[:true[l]], lv.P.cols[:true[l]], int(true[l + 1])))
        for l, lv in enumerate(levels)], ell_hier.coarse_inv[:nc, :nc])


def cycle_probe(amg, hierarchy: Hierarchy, f: torch.Tensor) -> Probe:
    """The program's preconditioner applied to ``f``."""
    return Probe(hierarchy, f, amg.precond()(f))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def judge(j: Judged, limits: dict, bench_dir=spec.BENCH_DIR
          ) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}) of a run. A number that
    finds nothing to read reads None and fails."""
    checks = {}
    for name, limit in limits.items():
        value = spec.check_reader(name, bench_dir)(j)
        checks[name] = {"value": value, "limit": limit}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
