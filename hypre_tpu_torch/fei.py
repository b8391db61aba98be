"""FEI — finite-element interface (the ``FEI_mv/fei-hypre`` layer).

Counterpart of ``hypre_tpu/fei.py``. The reference's FEI 2.x
implementation (``FEI_HYPRE_Impl.cxx``) accepts element-level stiffness
contributions from a finite-element application, assembles them into a
global matrix, applies essential boundary conditions and drives a solver
selected by parameter strings (``HYPRE_LSC_aux.cxx``: ``"solver gmres"``,
``"preconditioner boomeramg"``). The same call sequence here
(initFields -> initElemBlock -> sumInElemMatrix/sumInElemRHS ->
loadNodeBCs -> loadComplete -> parameters -> solve) assembles through the
IJ layer into an ELL operator on the system's device and dispatches to
the port's Krylov solvers and preconditioners. One element per call, as
in the FEI API.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hypre_tpu_torch.core.config import resolve_device
from hypre_tpu_torch.ij import IJMatrix
from hypre_tpu_torch.seq.ell import EllMatrix, ell_spmv
from hypre_tpu_torch.sstruct.fem import eliminate_dirichlet


@dataclasses.dataclass
class FEISystem:
    """FEI 2.x call-sequence object (LinearSystemCore / FEI_HYPRE_Impl).

    Node IDs are arbitrary hashable application IDs, numbered in
    first-appearance order. ``loadComplete`` builds A and b on ``device``
    (CUDA unless the caller names another) in ``dtype`` (float32 unless
    the caller names another).
    """

    n_nodes: int = 0
    field_sizes: tuple = (1,)
    dtype: torch.dtype = torch.float32
    device: object = None
    _node_ids: Dict = dataclasses.field(default_factory=dict, repr=False)
    _elems: Dict = dataclasses.field(default_factory=dict, repr=False)
    _bc_rows: List[int] = dataclasses.field(default_factory=list, repr=False)
    _bc_vals: List[float] = dataclasses.field(default_factory=list,
                                              repr=False)
    _shared: set = dataclasses.field(default_factory=set, repr=False)
    _params: Dict[str, str] = dataclasses.field(default_factory=dict,
                                                repr=False)
    A: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    b: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)

    # -- FEI 2.x init sequence -------------------------------------------

    def initFields(self, num_fields: int = 1,
                   field_sizes: Sequence[int] = (1,)):
        """FEI::initFields — each node carries sum(field_sizes) dofs,
        numbered node-major."""
        if num_fields != len(tuple(field_sizes)):
            raise ValueError("num_fields != len(field_sizes)")
        self.field_sizes = tuple(int(f) for f in field_sizes)
        return self

    @property
    def dofs_per_node(self) -> int:
        return sum(self.field_sizes)

    @property
    def n_dofs(self) -> int:
        return self.n_nodes * self.dofs_per_node

    def _dofs(self, nid) -> list:
        base = self._node(nid) * self.dofs_per_node
        return list(range(base, base + self.dofs_per_node))

    def _node(self, nid) -> int:
        if nid not in self._node_ids:
            self._node_ids[nid] = len(self._node_ids)
            self.n_nodes = len(self._node_ids)
        return self._node_ids[nid]

    def initElemBlock(self, block_id, num_elems: int, nodes_per_elem: int):
        """FEI::initElemBlock — declares a block; connectivity and
        stiffness arrive through sumInElemMatrix."""
        self._elems[block_id] = dict(n=num_elems, npe=nodes_per_elem,
                                     conn=[], nodes=[], mats=[], rhs=[])
        return self

    def initSharedNodes(self, node_ids: Sequence,
                        remote_procs: Sequence = ()) -> "FEISystem":
        """FEI::initSharedNodes — nodes shared with other "processors"
        (other FEISystem instances); their contributions are summed in
        ``fei_assemble_shared``."""
        self._shared.update(node_ids)
        return self

    def sumInElemMatrix(self, block_id, elem_id, node_ids: Sequence,
                        stiffness) -> "FEISystem":
        """FEI::sumInElemMatrix — element stiffness, (npe*dofs_per_node)
        square with node-major dof ordering."""
        blk = self._elems[block_id]
        if len(node_ids) != blk["npe"]:
            raise ValueError("connectivity length != nodes_per_elem")
        dofs = []
        for nid in node_ids:
            dofs.extend(self._dofs(nid))
        ke = np.asarray(stiffness, float)
        if ke.shape != (len(dofs), len(dofs)):
            raise ValueError(
                f"stiffness shape {ke.shape} != ({len(dofs)}, {len(dofs)})")
        blk["conn"].append(dofs)
        blk["nodes"].append(list(node_ids))
        blk["mats"].append(ke)
        return self

    def sumInElemRHS(self, block_id, elem_id, node_ids: Sequence,
                     load) -> "FEISystem":
        blk = self._elems[block_id]
        dofs = []
        for nid in node_ids:
            dofs.extend(self._dofs(nid))
        blk["rhs"].append((dofs, np.asarray(load, float)))
        return self

    def loadNodeBCs(self, node_ids: Sequence, values: Sequence
                    ) -> "FEISystem":
        """Essential (Dirichlet) BCs: row replaced by identity, rhs pinned.
        A scalar value pins every dof of the node; a sequence per dof."""
        for nid, v in zip(node_ids, values):
            dofs = self._dofs(nid)
            vv = ([float(v)] * len(dofs) if np.ndim(v) == 0
                  else [float(t) for t in v])
            for d, t in zip(dofs, vv):
                self._bc_rows.append(d)
                self._bc_vals.append(t)
        return self

    def _element_matrix(self) -> EllMatrix:
        """The summed element matrices, without BCs."""
        n = self.n_dofs
        ij = IJMatrix(n, n)
        conns = [c for blk in self._elems.values() for c in blk["conn"]]
        if conns:
            # one staging, in the order of per-element add-to calls
            ij.add_to_values(
                np.concatenate([np.repeat(c, len(c)) for c in conns]),
                np.concatenate([np.tile(c, len(c)) for c in conns]),
                np.concatenate([ke.reshape(-1) for blk in self._elems.values()
                                for ke in blk["mats"]]))
        return ij.assemble().get_object(dtype=self.dtype,
                                        device=resolve_device(self.device))

    def loadComplete(self) -> "FEISystem":
        """Assemble the global system through the IJ layer; BC columns are
        eliminated too, their values moved to the rhs."""
        n = self.n_dofs
        A = self._element_matrix()
        dev = A.device
        rhs = np.zeros(n)
        for blk in self._elems.values():
            for conn, fe in blk["rhs"]:
                np.add.at(rhs, conn, fe)
        rhs = torch.from_numpy(rhs).to(dev, self.dtype)
        bc = dict(zip(self._bc_rows, self._bc_vals))
        if bc:
            rows = torch.tensor(sorted(bc), device=dev)
            bcvec = torch.zeros(n, dtype=self.dtype, device=dev)
            bcvec[rows] = torch.tensor([bc[int(r)] for r in sorted(bc)],
                                       dtype=self.dtype, device=dev)
            A, moved = eliminate_dirichlet(A, rows)
            rhs = rhs - ell_spmv(moved, bcvec)
            rhs[rows] = bcvec[rows]
        self.A, self.b = A, rhs
        return self

    def element_null_candidates(self, num_vectors: int = 3,
                                sweeps: int = 20, seed: int = 0):
        """Near-null-space candidates from the ELEMENT data (femli's
        ``mli_amgsa_calib.cxx`` calibration): the element matrices summed
        WITHOUT boundary conditions (the Neumann operator, whose null
        space is the rigid-body modes the elements share), and
        ``num_vectors`` random vectors (the first the constants) relaxed
        on A_n z = 0 with l1-Jacobi, normalized every sweep, then
        orthonormalized. Feed the result to
        ``SmoothedAggAMG(null_space=...)``. Returns (n_dofs,
        num_vectors) in the system's type."""
        n = self.n_dofs
        An = self._element_matrix()
        l1 = torch.sum(torch.abs(An.vals), dim=1)
        l1inv = 1.0 / torch.where(l1 > 0, l1, torch.ones_like(l1))
        rng = np.random.default_rng(seed)
        Z = torch.from_numpy(rng.standard_normal((n, num_vectors))).to(
            An.device, An.dtype)
        Z[:, 0] = 1.0
        for _ in range(sweeps):
            Z = Z - l1inv[:, None] * ell_spmv(An, Z)
            Z = Z / torch.clamp(torch.linalg.vector_norm(
                Z, dim=0, keepdim=True), min=1e-30)
        Q, _ = torch.linalg.qr(Z)
        return Q

    def element_graph_aggregates(self) -> tuple:
        """FE-data-driven aggregation (femli's element-data coarsening):
        two dofs are adjacent iff they share an element, and the greedy
        aggregation runs on that graph. Returns (agg_id (n_dofs,), n_agg)
        for ``SmoothedAggAMG(agg0=...)``."""
        from hypre_tpu_torch.amg.smoothed_agg import aggregate_graph

        nbr: list = [set() for _ in range(self.n_dofs)]
        for blk in self._elems.values():
            for conn in blk["conn"]:
                for a in conn:
                    nbr[a].update(conn)
        for i, s in enumerate(nbr):
            s.discard(i)
        return aggregate_graph(nbr)

    # -- solve dispatch (HYPRE_LSC_aux.cxx parameter strings) --------------

    def parameters(self, plist: Sequence[str]) -> "FEISystem":
        for p in plist:
            parts = p.split()
            if len(parts) >= 2:
                self._params[parts[0]] = parts[1]
        return self

    def _preconditioner(self):
        """The ``preconditioner`` parameter's M on A's device: boomeramg,
        pilut/ilut, euclid/ilu, parasails, schwarz, else diagonal."""
        A = self.A
        prec = self._params.get("preconditioner", "diagonal")
        dev = A.device
        if prec == "boomeramg":
            from hypre_tpu_torch.amg.boomeramg import BoomerAMG

            return BoomerAMG(max_coarse_size=64).setup(A, device=dev
                                                       ).precond()
        if prec in ("pilut", "ilut"):
            from hypre_tpu_torch.precond.ilu import ILUT

            return ILUT().setup(A, device=dev).precond()
        if prec in ("euclid", "ilu"):
            from hypre_tpu_torch.precond.euclid import Euclid

            return Euclid().setup(A, device=dev).precond()
        if prec == "parasails":
            from hypre_tpu_torch.precond.parasails import ParaSails

            return ParaSails().setup(A, device=dev).precond()
        if prec == "schwarz":
            from hypre_tpu_torch.precond.schwarz import Schwarz

            return Schwarz().setup(A, device=dev).precond()
        dinv = 1.0 / A.diagonal()
        return lambda r: dinv * r

    def solve(self, rtol: float = 1e-8, maxiter: int = 1000):
        """The ``solver`` parameter's Krylov method (cg/pcg, gmres,
        bicgstab; gmres by default) with the ``preconditioner``'s M, on
        A's device; A applies through its ``optimize_operator`` format."""
        assert self.A is not None, "call loadComplete() first"
        from hypre_tpu_torch.krylov import bicgstab, gmres, pcg
        from hypre_tpu_torch.seq.fastmv import optimize_operator

        solvers = dict(cg=pcg, pcg=pcg, gmres=gmres, bicgstab=bicgstab)
        solver = solvers[self._params.get("solver", "gmres")]
        op = optimize_operator(self.A)
        return solver(op.mv, self.b, M=self._preconditioner(), rtol=rtol,
                      maxiter=maxiter, device=self.A.device)

    # -- solution return (FEI 2.x getBlockNodeSolution / getNodalSolution)

    def getBlockNodeSolution(self, block_id, x):
        """FEI::getBlockNodeSolution — the nodes an element block touches,
        their dof offsets into ``values`` and their solution values."""
        blk = self._elems[block_id]
        seen, node_ids = set(), []
        for elem_nodes in blk["nodes"]:
            for nid in elem_nodes:
                if nid not in seen:
                    seen.add(nid)
                    node_ids.append(nid)
        xs = _host(x)
        d = self.dofs_per_node
        offsets = list(range(0, d * len(node_ids), d))
        values = (np.concatenate([xs[self._dofs(nid)] for nid in node_ids])
                  if node_ids else np.zeros(0))
        return node_ids, offsets, values

    def getNodalSolution(self, x):
        """FEI::getNodalSolution — every node's ID, dof offset, values."""
        xs = _host(x)
        d = self.dofs_per_node
        node_ids = list(self._node_ids)
        offsets = list(range(0, d * len(node_ids), d))
        return node_ids, offsets, xs[: d * len(node_ids)].copy()

    def residualNorm(self, which: int, x) -> float:
        """FEI::residualNorm — norm of b - A x (which: 1 = one, 2 = two,
        0 = inf)."""
        assert self.A is not None, "call loadComplete() first"
        xt = torch.as_tensor(_host(x)).to(self.A.device, self.A.dtype)
        r = _host(self.b - ell_spmv(self.A, xt))
        if which == 1:
            return float(np.linalg.norm(r, 1))
        if which == 0:
            return float(np.linalg.norm(r, np.inf))
        return float(np.linalg.norm(r))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fei_assemble_shared(systems: Sequence[FEISystem]) -> FEISystem:
    """Multi-processor FEI assembly: each FEISystem plays one rank; the
    element contributions at shared nodes (or nodes that appear on several
    ranks: application node IDs are global) are summed into one global
    system, the reference's shared-node exchange as IJ add-to semantics.
    BCs from any rank apply (the last writer wins on conflicts). Returns
    the merged, loadComplete'd system, on the first system's device and
    in its type."""
    assert systems, "no FEI systems to merge"
    first = systems[0]
    merged = FEISystem(dtype=first.dtype, device=first.device)
    merged.initFields(len(first.field_sizes), first.field_sizes)
    for k, s in enumerate(systems):
        if s.field_sizes != merged.field_sizes:
            raise ValueError("inconsistent field layouts across processors")
        d = s.dofs_per_node
        inv = {v: nid for nid, v in s._node_ids.items()}
        for bid, blk in s._elems.items():
            mbid = (k, bid) if bid in merged._elems else bid
            merged.initElemBlock(mbid, blk["n"], blk["npe"])
            for nodes, ke in zip(blk["nodes"], blk["mats"]):
                merged.sumInElemMatrix(mbid, None, nodes, ke)
            for dofs, fe in blk["rhs"]:
                # node ids from this rank's dof numbering
                merged.sumInElemRHS(mbid, None,
                                    [inv[dof // d] for dof in dofs[::d]], fe)
        for row, val in zip(s._bc_rows, s._bc_vals):
            merged._bc_rows.append(merged._dofs(inv[row // d])[row % d])
            merged._bc_vals.append(val)
    return merged.loadComplete()
