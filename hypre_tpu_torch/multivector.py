"""Multivector layer — hypre's ``multivector/`` abstraction on tensors.

Counterpart of ``hypre_tpu/multivector.py``. hypre's LOBPCG runs over an
abstract ``mv_MultiVector`` whose operations come through an
``mv_InterfaceInterpreter`` table (``multivector/interpreter.h:13-51``),
so that any vector object (ParCSR, struct, SStruct) can feed the
eigensolver. Here a user vector is a tensor of any shape, or a nested
tuple, list or dict of tensors; the interpreter reduces to the pair
(flatten, unflatten), and the rest is dense algebra on the flat (n, m)
block:

- ``Interpreter``: the table, derived from an example vector
  (``for_vector``; the reference uses ``jax.flatten_util.ravel_pytree``,
  the port a small flatten of its own with the same leaf order: dict
  entries by sorted key, sequences in order);
- ``MultiVector``: an (n, m) column block with its interpreter and the
  ``temp_multivector.c`` operations;
- ``lobpcg_interpreted``: hypre_LOBPCGSolve over such vectors; the
  operators take and return user vectors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from hypre_tpu_torch.krylov.lobpcg import lobpcg


def _leaves(tree) -> list:
    """The tensors of a nested tuple/list/dict, in flatten order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    raise TypeError(f"not a vector of tensors: {type(tree).__name__}")


def _rebuild(tree, leaves):
    """``tree``'s structure with its tensors replaced, in flatten order,
    by the next items of the iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return type(tree)(_rebuild(v, leaves) for v in tree)


@dataclasses.dataclass(frozen=True)
class Interpreter:
    """mv_InterfaceInterpreter: how one user vector moves in and out of
    flat coordinates. Derive with ``Interpreter.for_vector(example)``."""

    ravel: Callable[[Any], torch.Tensor]
    unravel: Callable[[torch.Tensor], Any]
    size: int

    @classmethod
    def for_vector(cls, example: Any) -> "Interpreter":
        leaves = _leaves(example)
        dtype = leaves[0].dtype
        for x in leaves[1:]:
            dtype = torch.promote_types(dtype, x.dtype)
        shapes = [x.shape for x in leaves]
        dtypes = [x.dtype for x in leaves]
        sizes = [x.numel() for x in leaves]

        def ravel(v) -> torch.Tensor:
            return torch.cat([x.reshape(-1).to(dtype) for x in _leaves(v)])

        def unravel(flat: torch.Tensor):
            parts = torch.split(flat, sizes)
            return _rebuild(example, iter(
                p.reshape(s).to(d) for p, s, d in zip(parts, shapes, dtypes)))

        return cls(ravel=ravel, unravel=unravel, size=sum(sizes))

    # -- interpreter.h single-vector slots, on flat coordinates ------------
    def inner_prod(self, x, y) -> torch.Tensor:
        return torch.vdot(self.ravel(x), self.ravel(y))

    def axpy(self, a, x, y):
        return self.unravel(self.ravel(y) + a * self.ravel(x))

    def copy(self, x):
        return self.unravel(self.ravel(x))

    def clear(self, x):
        return self.unravel(torch.zeros_like(self.ravel(x)))

    def scale(self, a, x):
        return self.unravel(a * self.ravel(x))


def _column_op(interp: Interpreter, op: Callable[[Any], Any]):
    """A user-vector operator lifted to (n, m) flat blocks, column by
    column (the reference's vmap)."""
    def block(V: torch.Tensor) -> torch.Tensor:
        return torch.stack([interp.ravel(op(interp.unravel(V[:, j])))
                            for j in range(V.shape[1])], dim=1)

    return block


@dataclasses.dataclass(frozen=True)
class MultiVector:
    """mv_TempMultiVector: m user vectors as an (n, m) flat block of
    columns, with the interpreter that defined the flattening."""

    data: torch.Tensor  # (n, m)
    interp: Interpreter

    @classmethod
    def from_vectors(cls, vectors, interp: Optional[Interpreter] = None):
        interp = interp or Interpreter.for_vector(vectors[0])
        return cls(data=torch.stack([interp.ravel(v) for v in vectors],
                                    dim=1), interp=interp)

    @property
    def num_vectors(self) -> int:
        return int(self.data.shape[1])

    def vectors(self) -> list:
        return [self.interp.unravel(self.data[:, j])
                for j in range(self.num_vectors)]

    # -- temp_multivector.c block operations -------------------------------
    def inner_prod_matrix(self, other: "MultiVector") -> torch.Tensor:
        """G[i, j] = <x_i, y_j> (mv_TempMultiVectorByMultiVector)."""
        return self.data.T @ other.data

    def by_matrix(self, coef: torch.Tensor) -> "MultiVector":
        """Y = X coef (mv_TempMultiVectorByMatrix)."""
        return MultiVector(data=self.data @ coef, interp=self.interp)

    def axpy(self, a: float, other: "MultiVector") -> "MultiVector":
        return MultiVector(data=other.data + a * self.data,
                           interp=self.interp)

    def apply(self, op: Callable[[Any], Any]) -> "MultiVector":
        """A user-vector operator applied to every column."""
        return MultiVector(data=_column_op(self.interp, op)(self.data),
                           interp=self.interp)


def lobpcg_interpreted(
    A: Callable[[Any], Any],
    X0: MultiVector,
    B: Optional[Callable[[Any], Any]] = None,
    T: Optional[Callable[[Any], Any]] = None,
    tol: float = 1e-6,
    maxiter: int = 100,
):
    """hypre_LOBPCGSolve over user vectors (HYPRE_LOBPCGSetup wires the
    interpreter the same way, ``HYPRE_lobpcg.c:401``). A, B and T take and
    return one user vector. Returns (eigenvalues (m,), eigenvector
    MultiVector, residual norms (m,)), on X0's device."""
    interp = X0.interp
    w, V, res = lobpcg(
        _column_op(interp, A), X0.data,
        B=None if B is None else _column_op(interp, B),
        T=None if T is None else _column_op(interp, T),
        tol=tol, maxiter=maxiter)
    return w, MultiVector(data=V, interp=interp), res
