"""ADS — the auxiliary-space solver for H(div) (face-element) problems.

Counterpart of ``hypre_tpu/amg/ads.py`` (hypre's ``parcsr_ls/ads.c``). For
a face-element div-div + mass matrix A the user supplies the discrete curl
C (face x edge), the discrete gradient G (edge x node) and the node
coordinates. The preconditioner combines

- l1-Jacobi smoothing on A;
- a correction in the curl space, C B_C C^T, where A_C = C^T A C is an
  H(curl) operator handled by one cycle of a full AMS (as hypre builds one
  inside ADS);
- corrections in the vector-nodal space, Pi_d B_d Pi_d^T, Pi_d from the
  face-node incidence and the face normals (hypre_ADSComputePi), each B_d
  a BoomerAMG cycle;

in the symmetric order smooth, Pi, curl, Pi, smooth. The products are
formed in float64 on the operator's device (``ams.rap_f64``), as the
reference forms them in float64 on the host.

The three Pi_d corrections run one after the other, each on the residual
the previous one left (x, y, z on the way down, z, y, x on the way up),
as hypre's ADS cycle applies its Pi components ("013454310",
``ads.c``). The reference adds all three to one residual; that sum is a
block-Jacobi step over the coupled nodal-vector system, which overshoots,
so its M is indefinite (eigenvalues of M A down to -1.4 on the 4^3
constant-coefficient div-div problem), and PCG stalls there from 12^3.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from hypre_tpu_torch.amg.ams import (
    AMS, coords_tensor, f64, l1_inverse, rap_f64,
)
from hypre_tpu_torch.amg.boomeramg import BoomerAMG
from hypre_tpu_torch.core.config import fold_sum, resolve_device
from hypre_tpu_torch.seq.ell import EllMatrix
from hypre_tpu_torch.seq.spgemm import ell_spgemm, ell_transpose


def face_node_pi(C: EllMatrix, G: EllMatrix, xyz: torch.Tensor):
    """The face-node incidence N = |C| |G| (each face node reached
    through two edges) in float64, its row-normalized weights, the face
    normals, and Pi_d = weight * normal_d on N's pattern, one per
    dimension. The normal of an axis-aligned face is the axis along which
    its nodes do not spread. Returns (weight ELL, normals (nf, dim),
    [Pi_d ELL in float64])."""
    absC = dataclasses.replace(f64(C), vals=C.vals.double().abs())
    absG = dataclasses.replace(f64(G), vals=G.vals.double().abs())
    FN = ell_spgemm(absC, absG)
    valid = FN.cols >= 0
    zero = torch.zeros((), dtype=torch.float64, device=FN.device)
    weight = FN.vals / torch.clamp(fold_sum(FN.vals), min=1e-300)[:, None]
    weight = torch.where(valid, weight, zero)
    node = xyz[FN.cols.clamp(min=0).long()]  # (nf, k, dim)
    cen = fold_sum(node * weight[..., None])  # (nf, dim)
    spread = torch.where(valid[..., None], (node - cen[:, None, :]).abs(),
                         zero)
    ext = spread.amax(dim=1)
    normal = (ext < 1e-12).to(torch.float64)
    normal = normal / torch.clamp(
        torch.linalg.vector_norm(normal, dim=1, keepdim=True), min=1e-300)
    W = EllMatrix(vals=weight, cols=FN.cols, n_cols=FN.n_cols)
    pis = [EllMatrix(vals=weight * normal[:, d:d + 1], cols=FN.cols,
                     n_cols=FN.n_cols) for d in range(xyz.shape[1])]
    return W, normal, pis


@dataclasses.dataclass
class ADS:
    """HYPRE_ADSCreate / SetDiscreteCurl / SetDiscreteGradient."""

    smooth_sweeps: int = 1
    amg_knobs: Optional[dict] = None

    A: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    C: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    Ct: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    ams: Optional[AMS] = dataclasses.field(default=None, repr=False)
    Pis: Optional[List[EllMatrix]] = dataclasses.field(default=None,
                                                       repr=False)
    Pits: Optional[List[EllMatrix]] = dataclasses.field(default=None,
                                                        repr=False)
    B_Pi: Optional[List[BoomerAMG]] = dataclasses.field(default=None,
                                                        repr=False)
    l1inv: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                      repr=False)

    def setup(self, A: EllMatrix, C: EllMatrix, G: EllMatrix, coords,
              device=None, optimize="auto") -> "ADS":
        """Set up on ``device`` (CUDA unless the caller names another);
        ``optimize`` goes to the inner facades, as in ``AMS.setup``."""
        dev = resolve_device(device)
        A, C, G = A.to(dev), C.to(dev), G.to(dev)
        self.A, self.C, self.Ct = A, C, ell_transpose(C)
        self.l1inv = l1_inverse(A)
        knobs = self.amg_knobs or dict(max_coarse_size=64)

        # the curl-space operator A_C = C^T A C, handled by a full AMS; C G
        # = 0, so A_C has no gradient part (hypre's ads.c gives its AMS no
        # beta Poisson matrix)
        self.ams = AMS(amg_knobs=knobs, beta_is_zero=True).setup(
            rap_f64(A, C), G, coords, device=dev, optimize=optimize)
        _, _, pis = face_node_pi(C, G, coords_tensor(coords, dev))
        self.Pis, self.Pits, self.B_Pi = [], [], []
        for Pi64 in pis:
            Pi = dataclasses.replace(Pi64, vals=Pi64.vals.to(A.dtype))
            self.Pis.append(Pi)
            self.Pits.append(ell_transpose(Pi))
            self.B_Pi.append(BoomerAMG(**knobs).setup(
                rap_f64(A, Pi), device=dev, optimize=optimize))
        return self

    def precond(self):
        """One ADS cycle from a zero guess: the ``M`` of pcg."""
        A, C, Ct, l1inv = self.A, self.C, self.Ct, self.l1inv
        pis = list(zip(self.Pis, self.Pits, self.B_Pi))
        ams_M = self.ams.precond()
        sweeps = self.smooth_sweeps

        def smooth(z, r):
            for _ in range(sweeps):
                z = z + l1inv * (r - A.mv(z))
            return z

        def curl_corr(z, r):
            return z + C.mv(ams_M(Ct.mv(r - A.mv(z))))

        def pi_corr(z, r, order):
            for Pi, Pit, B in order:
                z = z + Pi.mv(B.cycle(Pit.mv(r - A.mv(z))))
            return z

        def M(r):
            z = smooth(torch.zeros_like(r), r)
            z = pi_corr(z, r, pis)
            z = curl_corr(z, r)
            z = pi_corr(z, r, pis[::-1])
            return smooth(z, r)

        return M
