"""Slab primitives for the on-device sparse setup: merge, compact, cap, gather.

Counterpart of ``hypre_tpu/seq/slabops.py``. A slab is an ``(n, K)`` pair of
column and value tensors, one row of candidates per matrix row, padding
marked by a negative column. Every merge is a sort along axis 1 with the
payloads carried along, a segmented doubling scan that leaves each run's
total at its first entry, and a second sort that left-compacts the unique
entries. Shift-structured (stencil) index maps gather by slicing instead of
indexing.

Two things decide the AMG hierarchy and are therefore kept bit for bit:

- ``seg_total_sorted`` adds a run of duplicates in the order of the
  reference's doubling scan (log2 K shifted adds), so totals that are equal
  there are equal here, and truncation ranks tie in the same places;
- ties between equal magnitudes are settled by the column index, through a
  stable sort, on the CPU and on the card alike.

``torch.sort`` takes one key. ``sort_slab`` with several keys chains stable
sorts from the last key to the first and gathers the payloads once; where
the slab is already ordered by the second key (``merge_slab``'s
truncation) one stable sort gives the same order. Row sums that feed a rank
or a threshold go through ``fold_sum`` (a fixed left-to-right chain).
"""

from __future__ import annotations

import numpy as np
import torch

from hypre_tpu_torch.core.config import PAD_COL, fold_sum

_BIG = 2**30


def _sort_key(key: torch.Tensor) -> torch.Tensor:
    """Floating keys with -0.0 folded onto +0.0, so that every sort routine
    sees the two as one value."""
    return key + 0.0 if key.is_floating_point() else key


def sort_slab(key, *vals, dimension: int = 1, num_keys: int = 1):
    """Stable sort along an axis with the payloads carried along.

    The first ``num_keys`` operands are the keys, compared in order; the
    result is every operand in sorted order (the reference's variadic
    ``lax.sort``)."""
    operands = (key, *vals)
    perm = None
    for j in reversed(range(num_keys)):
        kj = _sort_key(operands[j])
        if perm is not None:
            kj = torch.gather(kj, dimension, perm)
        _, idx = torch.sort(kj, dim=dimension, stable=True)
        perm = idx if perm is None else torch.gather(perm, dimension, idx)
    return tuple(torch.gather(o, dimension, perm) for o in operands)


def seg_total_sorted(key_s: torch.Tensor, val_s: torch.Tensor) -> torch.Tensor:
    """Per-entry segment totals over axis 1 of a column-sorted slab.

    t[i, j] = sum of val_s[i, j'] over the run of equal key_s starting at
    j; only the value at the FIRST entry of each run is the run's total
    (inclusive suffix scan by doubling; sorted keys make the distance-d
    equality test transitive). The adds are the reference's, one for one.
    """
    K = key_s.shape[1]
    s = val_s
    zero = torch.zeros((), dtype=val_s.dtype, device=val_s.device)
    d = 1
    while d < K:
        same = key_s[:, : K - d] == key_s[:, d:]
        add = torch.where(same, s[:, d:], zero)
        s = torch.cat([s[:, : K - d] + add, s[:, K - d:]], dim=1)
        d *= 2
    return s


def _where_col(mask, cols):
    """``cols`` where ``mask``, the padding column elsewhere."""
    return torch.where(mask, cols, PAD_COL)


def _where_val(mask, vals):
    """``vals`` where ``mask``, 0 elsewhere."""
    return torch.where(mask, vals, 0.0)


def merge_slab(cols: torch.Tensor, vals: torch.Tensor, out_k: int,
               max_elmts: int = 0, trunc_factor: float = 0.0,
               rescale_rowsum: bool = False):
    """Merge duplicate columns within each row of a candidate slab and
    left-compact the unique entries to width ``out_k``.

    Optionally fuses hypre's interpolation truncation
    (``par_interp_trunc_device.c``): keep the ``max_elmts`` largest |value|
    uniques per row (equal magnitudes: the smaller column first), drop those
    below trunc_factor*rowmax, and rescale survivors to preserve the row
    sum.

    Returns (out_cols, out_vals, required_k): required_k (a 0-d tensor) is
    the largest unique count of a row BEFORE truncation, so callers can
    detect that ``out_k`` was too small (only meaningful when
    max_elmts == 0).
    """
    n, K = cols.shape
    dev = cols.device
    key = torch.where(cols >= 0, cols, torch.full_like(cols, _BIG))
    key_s, val_s = sort_slab(key, vals)
    valid_s = key_s < _BIG
    is_new = valid_s & torch.cat(
        [torch.ones((n, 1), dtype=torch.bool, device=dev),
         key_s[:, 1:] != key_s[:, :-1]], dim=1)
    tot = seg_total_sorted(key_s, val_s)  # segment totals at first-of-run
    nuniq = is_new.sum(dim=1, dtype=torch.int32)
    required_k = nuniq.max() if n else torch.zeros((), dtype=torch.int32,
                                                   device=dev)

    if max_elmts > 0 or trunc_factor > 0.0:
        mag = torch.where(is_new, tot.abs(), torch.full_like(tot, -1.0))
        if trunc_factor > 0.0:
            row_max = mag.amax(dim=1, keepdim=True)
            keep_mag = mag >= trunc_factor * row_max
        else:
            keep_mag = is_new
        # rank uniques by |total| descending. The slab is in column order,
        # so one stable sort on the magnitude key breaks ties by column.
        skey = torch.where(is_new & keep_mag, -mag,
                           torch.full_like(mag, float("inf")))
        sk, c2, v2 = sort_slab(skey, key_s, tot)
        kk = max_elmts if max_elmts > 0 else out_k
        alive = ~torch.isinf(sk[:, :kk])  # dead slots carried a +inf key
        c2 = _where_col(alive, c2[:, :kk])
        v2 = _where_val(alive, v2[:, :kk])
        if rescale_rowsum:
            old_sum = fold_sum(_where_val(is_new, tot))
            new_sum = fold_sum(v2)
            nz = new_sum != 0
            scale = torch.where(
                nz, old_sum / torch.where(nz, new_sum,
                                          torch.ones_like(new_sum)),
                torch.ones_like(new_sum))
            v2 = v2 * scale[:, None]
        # restore column order within rows (downstream code assumes it)
        ck = torch.where(c2 >= 0, c2, torch.full_like(c2, _BIG))
        _, v3, c3 = sort_slab(ck, v2, c2)
        return c3, v3, required_k

    # plain compaction: stable-partition uniques left via position keys
    pos = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    pkey = torch.where(is_new, pos, torch.full_like(pos, _BIG))
    pk, c2, v2 = sort_slab(pkey, key_s, tot)
    alive = pk[:, :out_k] < _BIG
    return (_where_col(alive, c2[:, :out_k]),
            _where_val(alive, v2[:, :out_k]), required_k)


def cap_slab(cols: torch.Tensor, vals: torch.Tensor, kcap: int,
             rescale_rowsum: bool = False, lump_largest: bool = False,
             extra: tuple = (), tie_cols=None):
    """Keep the ``kcap`` largest-|v| entries per row (col-sorted output).

    The setup-path analogue of hypre's P_max_elmts applied to arbitrary
    slabs; dropped mass is optionally lumped onto the row's largest
    surviving entry, or the survivors rescaled, to preserve row sums.

    ``extra``: further per-entry payload slabs carried through the same
    selection (returned after the (cols, vals) pair). ``tie_cols``: the
    ids that break ties between equal magnitudes, when not ``cols``.
    """
    n, K = cols.shape
    if kcap >= K:
        return (cols, vals, *extra)
    valid = cols >= 0
    vals = _where_val(valid, vals)
    mag = torch.where(valid, vals.abs(), torch.full_like(vals, -1.0))
    tcols = cols if tie_cols is None else tie_cols
    tie = torch.where(valid, tcols, torch.full_like(tcols, _BIG))
    _, _, c2, v2, *e2 = sort_slab(-mag, tie, cols, vals, *extra, num_keys=2)
    c2, v2 = c2[:, :kcap], v2[:, :kcap]
    e2 = [e[:, :kcap] for e in e2]
    c2 = _where_col(c2 >= 0, c2)
    v2 = _where_val(c2 >= 0, v2)
    if lump_largest:
        dropped = fold_sum(vals) - fold_sum(v2)
        # slot 0 holds the largest |v|
        v2 = torch.cat([v2[:, :1] + dropped[:, None], v2[:, 1:]], dim=1)
    elif rescale_rowsum:
        old, new = fold_sum(vals), fold_sum(v2)
        nz = new != 0
        scale = torch.where(
            nz, old / torch.where(nz, new, torch.ones_like(new)),
            torch.ones_like(new))
        v2 = v2 * scale[:, None]
    ck = torch.where(c2 >= 0, c2, torch.full_like(c2, _BIG))
    _, v3, c3, *e3 = sort_slab(ck, v2, c2, *e2)
    return (c3, v3, *e3)


def compact_mask_slab(cols: torch.Tensor, vals: torch.Tensor,
                      keep: torch.Tensor, out_k: int):
    """Left-compact entries where ``keep`` (no dedup), PAD elsewhere."""
    n, K = cols.shape
    pos = torch.arange(K, dtype=torch.int32, device=cols.device)[None, :]
    pkey = torch.where(keep & (cols >= 0), pos, torch.full_like(pos, _BIG))
    pk, c2, v2 = sort_slab(pkey, cols, vals)
    alive = pk[:, :out_k] < _BIG
    return _where_col(alive, c2[:, :out_k]), _where_val(alive, v2[:, :out_k])


# ---------------------------------------------------------------------------
# Gather strategies: plain row gather vs shift (DIA) slices
# ---------------------------------------------------------------------------


class StencilPack:
    """Shift-structured index map: slot ``s`` of row ``i`` points at row
    ``i + offs[s]``.

    offs: host tuple of ints (the reference keeps them in a device array so
    that compiled programs are shared between grid sizes; nothing is
    compiled per shape here, and a host tuple lets every gather be a
    slice).
    margin: bound with ``|offset| <= margin`` for every slot, kept as the
    reference computes it.
    pair_idx[a]: slot index carrying -offs[a], or -1 (transpose pairing for
    paired_transpose_vals).
    d2: optional distance-2 composition structure for second_pass_pmis: a
    tuple of per-output-offset groups ``(singles, pairs)`` where
    ``singles`` are slot ids with offs[s] equal to the output offset and
    ``pairs`` are (a, b) with offs[a]+offs[b] equal to it.
    """

    def __init__(self, offs, margin: int, pair_idx: tuple = (),
                 d2: tuple | None = None):
        self.offs = tuple(int(o) for o in offs)
        self.margin = int(margin)
        self.pair_idx = tuple(pair_idx)
        self.d2 = d2

    @property
    def k(self) -> int:
        return len(self.offs)

    def slice(self, s0: int, s1: int) -> "StencilPack":
        """Sub-range of slots (blocked paths); drops pair/d2."""
        return StencilPack(self.offs[s0:s1], self.margin)


# Margin menu: margins are n_bucket >> j, as in the reference
_MARGIN_SHIFTS = (6, 5, 4, 3, 2, 1, 0)


def _pick_margin(n_bucket: int, max_abs_off: int) -> int:
    """Smallest menu margin covering the stencil extent."""
    for j in _MARGIN_SHIFTS:
        m = max(n_bucket >> j, 8)
        if m >= max_abs_off + 1:
            return m
    return int(max_abs_off + 1)


def make_stencil_pack(shifts_host, n_bucket: int, with_d2: bool = False,
                      margin: int | None = None) -> StencilPack:
    """Build a StencilPack from host offset values."""
    sh = [int(s) for s in shifts_host]
    if margin is None:
        margin = _pick_margin(n_bucket, max(abs(s) for s in sh) if sh else 0)
    pair_idx = tuple(sh.index(-s) if -s in sh else -1 for s in sh)
    d2 = None
    if with_d2:
        groups: dict = {}
        for a, sa in enumerate(sh):
            if sa != 0:
                groups.setdefault(sa, ([], []))[0].append(a)
            for b, sb in enumerate(sh):
                o = sa + sb
                if o != 0:
                    groups.setdefault(o, ([], []))[1].append((a, b))
        d2 = tuple((tuple(s), tuple(p))
                   for o, (s, p) in sorted(groups.items()))
    return StencilPack(sh, margin, pair_idx, d2)


def shift_rows(X: torch.Tensor, o: int, fill=0) -> torch.Tensor:
    """z[i] = X[i + o] along axis 0, ``fill`` where i + o is out of range."""
    n = X.shape[0]
    o = int(o)
    if o == 0:
        return X
    out = X.new_full(X.shape, fill)
    if abs(o) < n:
        if o > 0:
            out[: n - o] = X[o:]
        else:
            out[-o:] = X[: n + o]
    return out


def _shift_stack(X: torch.Tensor, offs, fill, flat: bool) -> torch.Tensor:
    n, k = X.shape[0], len(offs)
    out = X.new_full((n, k) + tuple(X.shape[1:]), fill)
    for s, o in enumerate(offs):
        o = int(o)
        if abs(o) >= n:
            continue
        if o >= 0:
            out[: n - o, s] = X[o:]
        else:
            out[-o:, s] = X[: n + o]
    if flat and X.ndim == 2:
        return out.reshape(n, k * X.shape[1])
    return out


def shift_gather_dyn(X: torch.Tensor, sp: StencilPack, fill=0,
                     flat: bool = False) -> torch.Tensor:
    """g[i, s, ...] = X[i + offs[s], ...] with out-of-range rows = fill.
    flat=True with a 2-D X returns (n, k*W), slot-major."""
    return _shift_stack(X, sp.offs, fill, flat)


def shift_scatter_add_dyn(contrib: torch.Tensor, sp: StencilPack):
    """out[j] = sum_s contrib[j - offs[s], s] (reverse of the gather), the
    slots added in order. contrib is (n, k); invalid slots must hold 0."""
    acc = None
    for s, o in enumerate(sp.offs):
        sl = shift_rows(contrib[:, s], -o, 0)
        acc = sl if acc is None else acc + sl
    return acc


def shift_scatter_max_dyn(contrib: torch.Tensor, sp: StencilPack, fill=0.0):
    """out[j] = max_s contrib[j - offs[s], s]; invalid slots must hold
    ``fill`` (the identity for the max in use)."""
    acc = None
    for s, o in enumerate(sp.offs):
        sl = shift_rows(contrib[:, s], -o, fill)
        acc = sl if acc is None else torch.maximum(acc, sl)
    return acc


def detect_shifts(cols_np: np.ndarray) -> np.ndarray | None:
    """If cols[i, s] == i + shift_s at every valid entry (a boundary-
    truncated stencil in lexicographic order), return the per-slot shifts.
    Host-side, once."""
    cols_np = np.asarray(cols_np)
    n, k = cols_np.shape
    if n == 0:
        return None
    rows = np.arange(n, dtype=np.int64)[:, None]
    diff = cols_np.astype(np.int64) - rows
    valid = cols_np >= 0
    shifts = np.zeros(k, np.int64)
    for s in range(k):
        v = diff[valid[:, s], s]
        if v.size == 0:
            continue
        if not (v == v[0]).all():
            return None
        shifts[s] = v[0]
    return shifts


def shift_gather_rows(X: torch.Tensor, shifts, fill=0, flat: bool = False):
    """g[i, s, ...] = X[i + shifts[s], ...] with out-of-range rows filled:
    the stencil specialization of ``X[cols]``. Consumers must still mask
    slots that are structurally invalid for interior reasons."""
    return _shift_stack(X, [int(s) for s in shifts], fill, flat)


def make_row_gather(shifts):
    """Returns gather(X, cols_c) -> (n, k, ...), by slices when the index
    map is shift-structured (shifts not None) else ``X[cols_c]``."""
    if shifts is None:
        def gather(X, cols_c):
            return X[cols_c.clamp(min=0).long()]
    else:
        def gather(X, cols_c):
            return shift_gather_rows(X, shifts)
    return gather
