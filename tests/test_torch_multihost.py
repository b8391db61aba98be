"""hypre_tpu_torch's multi-process layer (``parallel/multihost.py``, the
``dist`` backend of ``parallel/comm.py``).

The single-process behaviour mirrors ``tests/test_multihost.py:22-73``;
the bring-up is a real two-process run over gloo on loopback: each
process joins through ``init_multihost``, holds one shard of a 24^2
Laplacian, and its distributed products, one ``all_reduce`` and a
distributed setup must equal the one-process results.
"""

import json
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import hypre_tpu_torch as H
from hypre_tpu_torch.parallel import (
    flat_row_mesh, host_row_ranges, init_multihost, make_mesh,
    make_pod_mesh, par_spmv, partition_ell,
)
from hypre_tpu_torch.parallel.comm import DistComm
from hypre_tpu_torch.parallel.mesh import ROW_AXIS
from hypre_tpu_torch.parallel.multihost import DCN_AXIS, process_count
from hypre_tpu_torch.parallel.par_ell import collect_vector, distribute_vector
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_init_multihost_single_process_is_a_noop():
    # one process, no cluster environment: nothing to join, rank 0
    assert init_multihost() == 0
    assert not torch.distributed.is_initialized()
    assert process_count() == 1


def test_make_pod_mesh_axes():
    flat = flat_row_mesh(8, device="cpu")
    pod = make_pod_mesh(flat)
    assert pod.axis_names == (DCN_AXIS, ROW_AXIS)
    assert pod.shape == (1, 8)
    assert make_pod_mesh(flat, hosts=2).shape == (2, 4)
    assert make_pod_mesh(flat, hosts=2).shards.tolist() == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="not divisible"):
        make_pod_mesh(flat, hosts=3)


def test_flat_row_mesh_host_contiguous():
    mesh = flat_row_mesh(8, device="cpu")
    assert mesh.axis_names == (ROW_AXIS,)
    procs = list(mesh.shard_process)
    assert procs == sorted(procs)


def test_host_row_ranges_cover_disjoint():
    ranges = host_row_ranges(1003, flat_row_mesh(8, device="cpu"))
    assert ranges[0][0] == 0 and ranges[-1][1] == 1003
    for (_, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c


def test_pod_mesh_spmv_matches_flat():
    A = H.laplacian_2d_5pt(24, 24, dtype=torch.float32, device="cpu")
    mesh = make_pod_mesh(flat_row_mesh(8, device="cpu"), hosts=2).mesh
    x = np.random.default_rng(0).standard_normal(A.n_rows).astype(np.float32)
    y = collect_vector(par_spmv(partition_ell(A, mesh),
                                distribute_vector(x, mesh)), A.n_rows)
    np.testing.assert_allclose(y, A.mv(torch.from_numpy(x)).numpy(),
                               rtol=2e-5, atol=2e-5)


def test_dist_backend_refuses_card_tensors_on_gloo():
    # the check the dist backend makes before every exchange: a CUDA
    # tensor on a gloo group raises, naming NCCL, instead of a host copy
    comm = object.__new__(DistComm)
    comm.group_backend = "gloo"
    card = type("T", (), {"device": torch.device("cuda")})()
    with pytest.raises(RuntimeError, match="NCCL"):
        comm._check(card)
    comm._check(torch.zeros(1))
    comm.group_backend = "nccl"
    with pytest.raises(RuntimeError, match="NCCL"):
        comm._check(torch.zeros(1))
    with pytest.raises(RuntimeError, match="initialized"):
        make_mesh(2, device="cpu", backend="dist")


WORKER = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
torch.set_num_threads(1)
import hypre_tpu_torch as H
from hypre_tpu_torch.parallel import init_multihost, make_mesh, partition_ell
from hypre_tpu_torch.parallel import shutdown_multihost
from hypre_tpu_torch.parallel.par_ell import (
    collect_vector, distribute_vector, par_spmv, par_spmv_t)
from hypre_tpu_torch.parallel.par_setup import setup_hierarchy_par
import multicard_smoke as mc

rank = init_multihost("127.0.0.1:{port}", num_processes=2,
                      process_id=int(sys.argv[1]), timeout_s=100)


def bringup():
    A = H.laplacian_2d_5pt(24, 24, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(0).standard_normal(A.n_rows)
    out = {{}}
    for backend in ("dist", "local"):
        mesh = make_mesh(2, device="cpu", backend=backend)
        P = partition_ell(A, mesh)
        xd = distribute_vector(x, mesh)
        out[backend] = (
            collect_vector(par_spmv(P, xd), A.n_rows, mesh),
            collect_vector(par_spmv_t(P, xd), A.n_rows, mesh),
            [lv.A.n_rows for lv in setup_hierarchy_par(
                P, max_coarse_size=32).levels],
        )
        if backend == "dist":
            assert P.local_shards == 1 and xd.shape[0] == A.n_rows // 2
            total = mesh.comm.sum(torch.tensor([rank + 1.0]))
            assert float(total) == 3.0, float(total)
    for a, b in zip(out["dist"][:2], out["local"][:2]):
        assert np.array_equal(a, b), np.abs(a - b).max()
    assert np.allclose(out["local"][0], A.mv(torch.from_numpy(x)).numpy(),
                       rtol=1e-12, atol=1e-12)
    assert out["dist"][2] == out["local"][2], out
    return []


def solves():
    # the distributed solves against the same run on a local 2-shard mesh
    kw = dict(amg_shape=(16, 16, 16), ilu_shape=(24, 24),
              struct_shape=(64, 32), rtol=1e-8, max_coarse=64)
    dist = mc.solve_checks(make_mesh(2, device="cpu", backend="dist"),
                           torch.float64, **kw)
    local = mc.solve_checks(make_mesh(2, device="cpu"), torch.float64, **kw)
    return {{key: [b for b in mc.compare({{key: dist[key]}},
                                         {{key: local[key]}}, 1e-10)]
             + [dist[key]["iterations"]] for key in dist}}


for name, fn in (("bringup", bringup), ("solves", solves)):
    try:
        print("CHECK", name, json.dumps(fn()), flush=True)
    except Exception as e:
        print("CHECK", name, json.dumps(["raised: %r" % (e,)]), flush=True)
shutdown_multihost()
print("RANK_OK", rank)
"""


@pytest.fixture(scope="module")
def gloo_pair(tmp_path_factory):
    """Two OS processes that join through init_multihost on loopback
    (gloo), each holding one shard, run every check once; returns each
    rank's {check: result} (the start-up is paid once)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path_factory.mktemp("gloo") / "worker.py"
    script.write_text(textwrap.dedent(WORKER.format(root=str(ROOT),
                                                    port=port)))
    procs = [subprocess.Popen([sys.executable, str(script), str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in (0, 1)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"
        assert f"RANK_OK {i}" in out
        ranks.append({line.split()[1]: json.loads(line.split(None, 2)[2])
                      for line in out.splitlines()
                      if line.startswith("CHECK ")})
    return ranks


def test_two_process_gloo_bringup(gloo_pair):
    # par_spmv, par_spmv_t, an all_reduce and the distributed setup over
    # two processes equal the one-process (local backend) results
    for rank in gloo_pair:
        assert rank["bringup"] == []


@pytest.mark.parametrize("path", ["pcg_l1_jacobi", "pcg_par_ilu", "pfmg"])
def test_two_process_gloo_solve_equals_the_local_run(gloo_pair, path):
    # a real multi-process solve: PCG + l1-Jacobi on setup_hierarchy_par's
    # hierarchy at 16^3 (global inner products, the gathered coarse
    # solve), PCG + ParILU at 24^2 and sharded PFMG at 64 x 32, each on two
    # gloo processes against the same solve on a local 2-shard mesh: the
    # same iterations and x to 1e-10
    results = [rank["solves"] for rank in gloo_pair]
    assert isinstance(results[0], dict), results[0]
    for res in results:
        *failures, iterations = res[path]
        assert failures == [] and iterations > 0
    assert results[0][path] == results[1][path]
