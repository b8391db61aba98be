"""The device setup's replay of a recorded ladder (the reference's fast
setup, ``hypre_tpu/amg/device_setup.py``'s ``_try_fast_setup``).

A slow-path setup records its ladder in the shape registry; a second setup
of the same shape and knobs replays it with one read of the device. The
replay must give the slow path's hierarchy tensor for tensor, be rejected
(and the slow path's hierarchy returned) where the slow path would have
built something else, make no data-dependent read but its last one, and
stay off under ``HYPRE_TPU_NO_FAST_SETUP=1``. Every setup here runs the
port on CPU tensors; the registry is a file in a temporary directory.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import hypre_tpu_torch as H
from hypre_tpu_torch import warmup
from hypre_tpu_torch.amg import device_setup as TD
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_spans import span_paths

KW = dict(device="cpu", max_coarse_size=60, relax="chebyshev")
CASES = {
    "7pt-24-transfer_dia": dict(transfer_dia=True),
    "7pt-24-agg": dict(transfer_dia=True, agg_num_levels=1,
                       coarse_drop_tol=0.02),
    "5pt-40-no-shifts": dict(),
}


@pytest.fixture(scope="module", autouse=True)
def registry(tmp_path_factory):
    """A registry file of this module's own; the replay on."""
    mp = pytest.MonkeyPatch()
    mp.setenv(warmup.REGISTRY_ENV,
              str(tmp_path_factory.mktemp("reg") / "shapes.json"))
    mp.delenv("HYPRE_TPU_NO_FAST_SETUP", raising=False)
    mp.setattr(warmup, "_LOCAL", {})
    yield
    mp.undo()


def operator(case: str, scale=None):
    if case.startswith("7pt"):
        A = H.laplacian_3d_7pt(24, 24, 24, dtype=torch.float64, device="cpu")
    else:
        A = dataclasses.replace(
            H.laplacian_2d_5pt(40, 40, dtype=torch.float64, device="cpu"),
            shifts=None)
    if scale is not None:
        A = dataclasses.replace(A, vals=A.vals * scale)
    return A


def tensors(obj, prefix=""):
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from tensors(v, f"{prefix}[{i}]")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name), f"{prefix}.{f.name}")


def differences(h1, h2) -> list:
    a, b = list(tensors(h1)), list(tensors(h2))
    assert len(a) == len(b) > 10
    return [pa for (pa, x), (pb, y) in zip(a, b)
            if pa != pb or x.dtype != y.dtype or x.shape != y.shape
            or not torch.equal(x, y)]


@pytest.fixture(scope="module")
def twice():
    """case -> (the slow path's hierarchy, the second setup's)."""
    return {case: tuple(TD.setup_hierarchy_device(operator(case), **KW, **kw)
                        for _ in range(2))
            for case, kw in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_second_setup_replays_the_slow_paths_hierarchy_bit_for_bit(
        twice, case):
    slow, replayed = twice[case]
    assert not slow.replayed and replayed.replayed
    assert replayed.n_level_true == slow.n_level_true
    assert len(slow.levels) >= 2
    assert differences(slow, replayed) == []
    if CASES[case].get("transfer_dia"):
        assert isinstance(replayed.levels[0].P, H.TransferDia)


def other_values(kind: str):
    """Same shape as the recorded 7-pt 24^3, another CF split: random
    positive couplings, or couplings weak across y and z (1-D strength
    chains, whose C points outnumber the recorded coarse space, so the
    replay must stay in bounds until its check)."""
    A = operator("7pt-24-agg")
    rows = torch.arange(A.n_rows)[:, None]
    valid_off = (A.cols >= 0) & (A.cols != rows)
    if kind == "random":
        rng = np.random.default_rng(3)
        w = torch.from_numpy(rng.uniform(0.2, 5.0, A.vals.shape))
    else:
        weak = torch.tensor([abs(s) >= 24 for s in A.shifts])
        w = torch.where(weak, 0.01, 1.0).expand(A.vals.shape)
    vals = torch.where(valid_off, A.vals * w, 0.0)
    diag = 0.1 - vals.sum(dim=1, keepdim=True)
    return dataclasses.replace(A, vals=torch.where(A.cols == rows, diag,
                                                   vals))


@pytest.mark.parametrize("kind", ["random", "anisotropic"])
def test_same_shape_operator_with_another_split_is_rejected(
        twice, caplog, monkeypatch, kind):
    kw = CASES["7pt-24-agg"]
    # the ladder of the recorded operator, whatever ran before
    TD.setup_hierarchy_device(operator("7pt-24-agg"), **KW, **kw)
    A = other_values(kind)
    with caplog.at_level(logging.WARNING, logger=TD.__name__):
        got = TD.setup_hierarchy_device(A, **KW, **kw)
    assert not got.replayed
    assert any("rejected" in r.getMessage() for r in caplog.records)
    monkeypatch.setenv("HYPRE_TPU_NO_FAST_SETUP", "1")
    want = TD.setup_hierarchy_device(A, **KW, **kw)
    assert got.n_level_true != twice["7pt-24-agg"][0].n_level_true
    if kind == "anisotropic":
        assert got.n_level_true[1] > 1024  # past the recorded bucket
    assert differences(got, want) == []


def test_recorded_pt_width_below_the_need_is_rejected(twice, caplog):
    """A ladder whose level-0 trimmed Pt width ``tw`` is below the width
    the operator needs, while the untrimmed ``t`` still covers it, must be
    rejected: trimming to ``tw`` would cut Pt's entries."""
    kw = CASES["7pt-24-agg"]
    A = operator("7pt-24-agg")
    slow = twice["7pt-24-agg"][0]
    assert not differences(TD.setup_hierarchy_device(A, **KW, **kw), slow)
    sig = warmup.shape_key(TD._row_bucket(A.n_rows), A.k, A.shifts)
    key, = [k for k in warmup.read_registry()
            if k.startswith(f"ladder|{sig}|") and "|agg=1|" in k]
    rec = warmup.read_registry()[key]
    lev = next(lv for lv in rec["levels"] if lv["tdia"] is None)
    assert lev["t"] >= lev["tw"] > 4
    bad = dict(rec, levels=[dict(lv, tw=4) if lv is lev else lv
                            for lv in rec["levels"]])
    warmup.update_registry({key: bad})
    try:
        with caplog.at_level(logging.WARNING, logger=TD.__name__):
            got = TD.setup_hierarchy_device(A, **KW, **kw)
    finally:
        warmup.update_registry({key: rec})
    assert not got.replayed
    assert any("Pt width" in r.getMessage() for r in caplog.records)
    assert differences(got, slow) == []


def test_no_fast_setup_takes_the_slow_path(twice, monkeypatch):
    kw = CASES["5pt-40-no-shifts"]
    monkeypatch.setenv("HYPRE_TPU_NO_FAST_SETUP", "1")
    # the stage spans lie in the slow path's span: no replay was tried
    got, paths = span_paths(lambda: TD.setup_hierarchy_device(
        operator("5pt-40-no-shifts"), **KW, **kw))
    assert not got.replayed
    assert ("setup.slow", "setup.L0.split") in paths
    assert not any("setup.replay" in p for p in paths)
    assert differences(got, twice["5pt-40-no-shifts"][0]) == []


@pytest.mark.parametrize("shifted", [True, False])
def test_pmis_with_its_recorded_rounds_equals_the_loop(shifted):
    A = H.laplacian_3d_7pt(12, 12, 12, dtype=torch.float64, device="cpu")
    if not shifted:
        A = dataclasses.replace(A, shifts=None)
    _, scols, _, _ = TD.strength_and_cap(A, 0.25, 12, A.shifts)
    cf, rounds, decided = TD._pmis(scols, A.n_rows, shifts=A.shifts)
    assert decided is None and rounds >= 2
    assert torch.equal(TD.pmis_device(scols, A.n_rows, shifts=A.shifts), cf)
    for r in (rounds, rounds + 2):
        got, _, decided = TD._pmis(scols, A.n_rows, shifts=A.shifts,
                                   rounds=r)
        assert torch.equal(got, cf) and bool(decided)
    short, _, decided = TD._pmis(scols, A.n_rows, shifts=A.shifts,
                                 rounds=rounds - 1)
    assert not bool(decided) and not torch.equal(short, cf)


class DataDependentOps(TorchDispatchMode):
    """Counts the ops whose output shape or host value depends on the
    data: each one is a read-back on a card."""

    NAMES = ("aten._local_scalar_dense", "aten.nonzero", "aten.unique",
             "aten._unique", "aten.masked_select")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bool_index = name.startswith(("aten.index.", "aten.index_put")) and \
            any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] if len(args) > 1 else ()) or ())
        if name.startswith(self.NAMES) or bool_index:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def test_replay_reads_the_device_once(twice, monkeypatch):
    kw = CASES["7pt-24-agg"]
    A = operator("7pt-24-agg")
    TD.setup_hierarchy_device(A, **KW, **kw)  # A's own ladder recorded
    reads = []
    real = TD._read_back
    monkeypatch.setattr(TD, "_read_back",
                        lambda t: reads.append(t.numel()) or real(t))
    with DataDependentOps() as replay:
        got = TD.setup_hierarchy_device(A, **KW, **kw)
    assert got.replayed
    assert replay.seen == [] and len(reads) == 1
    monkeypatch.setenv("HYPRE_TPU_NO_FAST_SETUP", "1")
    with DataDependentOps() as slow:
        TD.setup_hierarchy_device(A, **KW, **kw)
    print(f"data-dependent ops: replay {len(replay.seen)} + 1 read of "
          f"{reads[0]} values, slow path {len(slow.seen)}")
    assert len(slow.seen) > 5
