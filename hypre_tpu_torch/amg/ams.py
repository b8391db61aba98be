"""AMS — the auxiliary-space Maxwell solver for H(curl) problems.

Counterpart of ``hypre_tpu/amg/ams.py`` (hypre's ``parcsr_ls/ams.c``,
Hiptmair-Xu). For an edge-element curl-curl matrix A the user supplies the
discrete gradient G (edge x node) and the node coordinates. The
preconditioner combines

- l1-Jacobi smoothing on A (hypre's default A-relaxation);
- a correction in the gradient space, G B_G G^T with A_G = G^T A G;
- corrections in the vector-nodal space, Pi_d B_d Pi_d^T per dimension,
  Pi_d[e, v] = 1/2 |G[e, v]| (G coords_d)[e] (hypre_AMSComputePi);

each B a BoomerAMG V-cycle on the projected operator (the facade, set up
and optimized on the same device), combined in hypre's symmetric "01210"
order (smooth, Pi, gradient, Pi, smooth) or additively.

The reference forms the Galerkin products in float64 on the host with its
C++ CSR kernels and casts them to the operator's type; here the port's
own SpGEMM forms them in float64 on the operator's device and casts them
the same way. The products with G^T and Pi^T run on stored transposes (a
gather, not a scatter of atomics), so the card repeats the CPU's bits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from hypre_tpu_torch.amg.boomeramg import BoomerAMG
from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.spgemm import ell_spgemm, ell_transpose


def f64(M: EllMatrix) -> EllMatrix:
    """A float64 copy of M (same pattern, same device)."""
    return dataclasses.replace(M, vals=M.vals.double())


def product_f64(A: EllMatrix, B: EllMatrix, dtype=None) -> EllMatrix:
    """A B formed in float64 on A's device and cast to ``dtype`` (A's by
    default): the reference's ``_host_product``."""
    C = ell_spgemm(f64(A), f64(B))
    return dataclasses.replace(C, vals=C.vals.to(dtype or A.dtype))


def rap_f64(A: EllMatrix, P: EllMatrix) -> EllMatrix:
    """P^T A P formed in float64 on A's device and cast to A's type: the
    reference's ``_host_rap``."""
    C = ell_spgemm(ell_transpose(f64(P)), ell_spgemm(f64(A), f64(P)))
    return dataclasses.replace(C, vals=C.vals.to(A.dtype))


def coords_tensor(coords, device) -> torch.Tensor:
    """(n_nodes, dim) node coordinates as float64 on ``device``."""
    if isinstance(coords, torch.Tensor):
        return coords.to(device=device, dtype=torch.float64)
    return torch.from_numpy(np.asarray(coords, np.float64)).to(device)


def l1_inverse(A: EllMatrix) -> torch.Tensor:
    """1 / max(sum_j |a_ij|, 1e-300) in A's type (the l1-Jacobi scaling of
    the auxiliary-space smoothers)."""
    return 1.0 / torch.clamp(A.abs_row_sums(), min=1e-300)


@dataclasses.dataclass
class AMS:
    """HYPRE_AMSCreate / SetDiscreteGradient / SetCoordinateVectors."""

    smooth_sweeps: int = 1
    cycle: str = "01210"  # hypre AMS cycle_type 1 | 'additive'
    amg_knobs: Optional[dict] = None
    # HYPRE_AMSSetBetaPoissonMatrix(NULL): A has no mass term on the
    # gradients, G^T A G = 0, and the gradient correction is left out.
    # ADS sets it on its inner AMS, whose C^T A C annihilates gradients:
    # built anyway, that G^T A G is rounding noise (1e-15 of A in f64)
    # and its cycle blows up
    beta_is_zero: bool = False

    A: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    G: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    Gt: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    Pis: Optional[List[EllMatrix]] = dataclasses.field(default=None,
                                                       repr=False)
    Pits: Optional[List[EllMatrix]] = dataclasses.field(default=None,
                                                        repr=False)
    B_G: Optional[BoomerAMG] = dataclasses.field(default=None, repr=False)
    B_Pi: Optional[List[BoomerAMG]] = dataclasses.field(default=None,
                                                        repr=False)
    l1inv: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                      repr=False)

    def setup(self, A: EllMatrix, G: EllMatrix, coords, device=None,
              optimize="auto") -> "AMS":
        """Set up on ``device`` (CUDA unless the caller names another; A,
        G and the coordinates are moved there). ``optimize`` goes to the
        inner facades' setups ('auto': the kernel formats on CUDA)."""
        dev = resolve_device(device)
        A, G = A.to(dev), G.to(dev)
        self.A, self.G, self.Gt = A, G, ell_transpose(G)
        self.l1inv = l1_inverse(A)
        knobs = self.amg_knobs or dict(max_coarse_size=64)

        # gradient-space operator A_G = G^T A G
        self.B_G = None if self.beta_is_zero else BoomerAMG(**knobs).setup(
            rap_f64(A, G), device=dev, optimize=optimize)

        # Pi_d from the discrete gradient and the coordinates, on G's
        # pattern: 1/2 |G[e, v]| times the edge's tangent component
        xyz = coords_tensor(coords, dev)
        G64 = f64(G)
        valid = G.cols >= 0
        self.Pis, self.Pits, self.B_Pi = [], [], []
        for dim in range(xyz.shape[1]):
            t = G64.mv(xyz[:, dim])
            pv = torch.where(valid, 0.5 * G64.vals.abs() * t[:, None],
                             torch.zeros_like(G64.vals))
            Pi = EllMatrix(vals=pv.to(A.dtype), cols=G.cols, n_cols=G.n_cols)
            self.Pis.append(Pi)
            self.Pits.append(ell_transpose(Pi))
            self.B_Pi.append(BoomerAMG(**knobs).setup(
                rap_f64(A, Pi), device=dev, optimize=optimize))
        return self

    def precond(self):
        """One auxiliary-space cycle from a zero guess (hypre_AMSSolve's
        inner step): the ``M`` of pcg."""
        A, G, Gt, l1inv = self.A, self.G, self.Gt, self.l1inv
        pis = list(zip(self.Pis, self.Pits, self.B_Pi))
        B_G, sweeps = self.B_G, self.smooth_sweeps

        def smooth(z, r):
            for _ in range(sweeps):
                z = z + l1inv * (r - A.mv(z))
            return z

        def grad_corr(z, r):
            if B_G is None:
                return z
            return z + G.mv(B_G.cycle(Gt.mv(r - A.mv(z))))

        def pi_corr(z, r):
            res = r - A.mv(z)
            for Pi, Pit, B in pis:
                z = z + Pi.mv(B.cycle(Pit.mv(res)))
            return z

        if self.cycle == "additive":
            def M(r):
                z = smooth(torch.zeros_like(r), r)
                if B_G is not None:
                    z = z + G.mv(B_G.cycle(Gt.mv(r)))
                for Pi, Pit, B in pis:
                    z = z + Pi.mv(B.cycle(Pit.mv(r)))
                return z
        else:  # '01210', multiplicative and symmetric
            def M(r):
                z = smooth(torch.zeros_like(r), r)
                z = pi_corr(z, r)
                z = grad_corr(z, r)
                z = pi_corr(z, r)
                return smooth(z, r)
        return M
