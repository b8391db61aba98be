"""hypre_tpu_torch.warmup against hypre_tpu.warmup.

The setup signatures and the registry's answers must be the reference's;
the registry file is written with a merge and atomically (the reference
overwrites it with its cached copy); the facade's device backend records a
shape on first sight (the reference skips the record when the signature is
novel). Each package's registry is a file in its own temporary directory.
"""

import dataclasses
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest
import torch

from hypre_tpu import warmup as JW
from hypre_tpu.problems import laplacian as JL

import hypre_tpu_torch as H
from hypre_tpu_torch import warmup as TW
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def registries(tmp_path, monkeypatch):
    """Fresh registries and process state for both packages."""
    monkeypatch.setenv("HYPRE_TPU_SHAPE_REGISTRY", str(tmp_path / "ref.json"))
    monkeypatch.setenv(TW.REGISTRY_ENV, str(tmp_path / "port" / "shapes.json"))
    monkeypatch.setenv("HYPRE_TPU_NO_FAST_SETUP", "1")
    monkeypatch.setattr(JW, "_SHAPE_REG", None)
    monkeypatch.setattr(JW, "_PRIMED", set())
    monkeypatch.setattr(TW, "_PRIMED", set())
    monkeypatch.setattr(TW, "_LOCAL", {})
    return tmp_path


def pair(name):
    f64 = dict(dtype=torch.float64, device="cpu")
    if name == "7pt-16":
        return JL.laplacian_3d_7pt(16, 16, 16), H.laplacian_3d_7pt(16, 16, 16,
                                                                   **f64)
    if name == "27pt-8":
        return JL.laplacian_3d_27pt(8, 8, 8), H.laplacian_3d_27pt(8, 8, 8,
                                                                  **f64)
    if name == "5pt-33":  # 1089 rows, padded to the 1536 bucket
        return JL.laplacian_2d_5pt(33, 33), H.laplacian_2d_5pt(33, 33, **f64)
    jA, tA = pair("5pt-33")
    return (dataclasses.replace(jA, shifts=None),
            dataclasses.replace(tA, shifts=None))


@pytest.mark.parametrize("name", ["7pt-16", "27pt-8", "5pt-33", "no-shifts"])
def test_setup_signature_is_the_references(name):
    jA, tA = pair(name)
    assert TW.setup_signature(tA) == JW.setup_signature(jA)
    assert TW._shape_key(tA) == JW._shape_key(jA)


def test_registry_answers_along_a_sequence_of_calls():
    (jA, tA), (jB, tB) = pair("7pt-16"), pair("5pt-33")
    calls = [
        lambda W, A, B: W.novel_shape_report(A)[0],
        lambda W, A, B: W.shape_seen(A, record=False),
        lambda W, A, B: W.shape_seen(A),
        lambda W, A, B: W.shape_seen(A),
        lambda W, A, B: W.is_primed(A),
        lambda W, A, B: W._record_setup_signature(A),
        lambda W, A, B: W.novel_shape_report(A)[0],
        lambda W, A, B: W.is_primed(A),
        lambda W, A, B: W.novel_shape_report(B)[0],
        lambda W, A, B: W.shape_seen(B),
        lambda W, A, B: W.shape_seen(A),
    ]
    ref = [c(JW, jA, jB) for c in calls]
    got = [c(TW, tA, tB) for c in calls]
    assert got == ref
    assert got == [True, False, False, True, False, None, False, True, True,
                   False, True]
    # a later process reads what this one wrote
    assert set(json.loads(Path(TW._shape_reg_path()).read_text())) == {
        TW._shape_key(tA), TW._shape_key(tB), TW._sig_key(
            TW.setup_signature(tA))}
    TW._PRIMED.clear()
    assert not TW.novel_shape_report(tA)[0]
    msg = TW.novel_shape_report(tB)[1]
    assert "nvcc" in msg and "TPU" not in msg


def test_facade_warns_once_and_records_the_shape_on_first_sight():
    A = H.laplacian_3d_7pt(12, 12, 12, dtype=torch.float64, device="cpu")
    key = TW._shape_key(A)
    runs = []
    for _ in range(2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            amg = H.BoomerAMG(setup_backend="device", max_coarse_size=60) \
                .setup(A, device="cpu", optimize=True)
        runs.append([str(w.message) for w in caught
                     if "hypre_tpu_torch" in str(w.message)])
        # first sight: the shape is recorded even though the signature
        # was novel
        assert key in TW.read_registry()
    assert len(runs[0]) == 1 and "novel setup signature" in runs[0][0]
    assert runs[1] == []
    # the second setup knows the shape: the specialized (static) DIA solve
    assert amg.hierarchy.levels[0].A.offsets_static is not None


def test_an_entry_written_meanwhile_by_another_process_survives():
    TW.update_registry({"ours|1": 1})
    assert TW.read_registry()["ours|1"] == 1  # our read
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run(
        [sys.executable, "-c", "from hypre_tpu_torch import warmup; "
         "warmup.update_registry({'theirs|2': 2})"],
        env=env, check=True, timeout=120)
    TW.update_registry({"ours|3": 3})  # our write
    on_disk = json.loads(Path(TW._shape_reg_path()).read_text())
    assert on_disk == {"ours|1": 1, "theirs|2": 2, "ours|3": 3}


def test_a_write_that_fails_midway_leaves_the_old_file_whole(monkeypatch):
    TW.update_registry({"old|1": 1})
    path = Path(TW._shape_reg_path())
    before = path.read_bytes()

    def broken_dump(obj, f):
        f.write('{"old|1": 1, "new|')
        raise OSError("disk full")

    monkeypatch.setattr(TW.json, "dump", broken_dump)
    TW.update_registry({"new|2": 2})
    assert path.read_bytes() == before
    assert sorted(p.name for p in path.parent.iterdir()) == [
        path.name, path.name + ".lock"]
    # this process still knows the entry it could not write
    assert TW.read_registry()["new|2"] == 2


def test_warmup_primes_the_signature_and_returns_seconds():
    A = H.laplacian_3d_7pt(16, 16, 16, dtype=torch.float64, device="cpu")
    assert not TW.is_primed(A)
    secs = TW.warmup(A, device="cpu", setup_kwargs=dict(max_coarse_size=60))
    assert secs > 0 and TW.is_primed(A)
    assert not TW.novel_shape_report(A)[0]
    assert [k for k in TW.read_registry() if k.startswith("ladder|")]


def test_warmup_family_walks_the_row_buckets():
    got = TW.warmup_family("7pt", n_max=729, n_min=512, device="cpu",
                           dtype=torch.float64,
                           setup_kwargs=dict(max_coarse_size=60))
    assert [b for b, _ in got] == [512, 768]
    assert all(s > 0 for _, s in got)


def test_enable_persistent_cache_moves_both_library_builds(tmp_path,
                                                         monkeypatch):
    from hypre_tpu_torch import kernels, native

    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    # nothing is switched at import, and the reference's variable is not
    # read: the libraries stay in the package's build directory
    monkeypatch.setenv("HYPRE_TPU_COMP_CACHE", str(tmp_path / "jax"))
    default = ROOT / "hypre_tpu_torch" / "_build"
    assert kernels.BUILD_DIR == native.BUILD_DIR == default
    assert TW.enable_persistent_cache() == str(default)
    assert TW.enable_persistent_cache(str(tmp_path)) == str(tmp_path)
    assert kernels._lib_path("dia_spmv").parent == tmp_path
    assert native.library_path().parent == tmp_path
