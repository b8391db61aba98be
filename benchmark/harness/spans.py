"""``op:<name>`` spans for the traced segment: around the outer operator
and each level operator of a hierarchy that runs a hand-written kernel,
with the function bytes of each, so that the rooflines can tie every
kernel launch to the operator it applied. Undone by ``close``."""

from __future__ import annotations

from harness import trace
from harness.roofline import spmv_bytes, spmv_flops, stored_nonzeros

KINDS = {"DiaMatrix": "dia", "BandedEll": "banded"}


def _wrap_mv(M, name: str) -> None:
    inner = M.mv

    def mv(x):
        with trace.span(f"op:{name}"):
            return inner(x)

    object.__setattr__(M, "mv", mv)


def _unwrap_mv(M) -> None:
    if "mv" in vars(M):
        object.__delattr__(M, "mv")


def _op_entry(kind: str, n_rows: int, n_cols: int, nnz: int,
              value_bytes: int, stencil: bool) -> dict:
    return {"kind": kind, "flops": spmv_flops(nnz),
            "bytes": spmv_bytes(n_rows, n_cols, nnz, value_bytes, stencil)}


class Spans:
    def __init__(self, A, amg, op_obj):
        from hypre_tpu_torch.amg import hierarchy as H

        self.wrapped, self.ops = [], {}
        vb = A.vals.element_size()
        ell = amg.ell_hierarchy
        true = ell.n_level_true or tuple(
            lv.A.n_rows for lv in ell.levels) + (ell.coarse_inv.shape[0],)
        if type(op_obj).__name__ in KINDS:
            self._wrap(op_obj, "A", _op_entry(
                KINDS[type(op_obj).__name__], A.n_rows, A.n_rows,
                stored_nonzeros(op_obj), vb, A.shifts is not None))
        self.p_names = {}
        for l, (lev, elev) in enumerate(zip(amg.hierarchy.levels,
                                            ell.levels)):
            n, nc = true[l], true[l + 1]
            kind = KINDS.get(type(lev.A).__name__)
            if kind:
                self._wrap(lev.A, f"L{l}.A", _op_entry(
                    kind, n, n, stored_nonzeros(elev.A), vb,
                    elev.A.shifts is not None))
            kind = KINDS.get(type(lev.P).__name__)
            if kind:
                nnz = stored_nonzeros(elev.P)
                self._wrap(lev.P, f"L{l}.P",
                           _op_entry(kind, n, nc, nnz, vb, False))
                self.ops[f"L{l}.Pt"] = _op_entry(kind, nc, n, nnz, vb, False)
                self.p_names[id(lev.P)] = f"op:L{l}.Pt"
        self.H = H
        self.orig_t = getattr(H, "banded_spmv_t", None)
        if self.orig_t is not None:
            orig, names = self.orig_t, self.p_names

            def banded_spmv_t(P, r):
                with trace.span(names.get(id(P), "op:?")):
                    return orig(P, r)

            H.banded_spmv_t = banded_spmv_t

    def _wrap(self, M, name, entry):
        _wrap_mv(M, name)
        self.wrapped.append(M)
        self.ops[name] = entry

    def close(self):
        for M in self.wrapped:
            _unwrap_mv(M)
        if self.orig_t is not None:
            self.H.banded_spmv_t = self.orig_t
