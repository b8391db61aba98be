"""hypre_tpu_torch stands alone: it imports neither JAX nor hypre_tpu,
nor scipy (which only fem_stiffness_2d imports, inside the call), builds
nothing and joins no process group at import time, and chip_smoke.py
refuses to run without a card."""

import os
import re
import subprocess
import sys
from pathlib import Path

import torch
from torch_one_thread import one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "hypre_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "profile_torch_solve.py"]


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = (
        "import sys, hypre_tpu_torch\n"
        "import hypre_tpu_torch.convert, hypre_tpu_torch.kernels\n"
        "import hypre_tpu_torch.seq.slabops, hypre_tpu_torch.core.memory\n"
        "import hypre_tpu_torch.seq.transfer_dia\n"
        "import hypre_tpu_torch.amg.device_setup\n"
        "import hypre_tpu_torch.amg.boomeramg, hypre_tpu_torch.amg.air\n"
        "import hypre_tpu_torch.precond.common, hypre_tpu_torch.krylov\n"
        "import hypre_tpu_torch.krylov.lobpcg, hypre_tpu_torch.krylov.cgnr\n"
        "import hypre_tpu_torch.ij, hypre_tpu_torch.io\n"
        "import hypre_tpu_torch.refine, hypre_tpu_torch.seq.twofloat\n"
        "import hypre_tpu_torch.problems.unstructured\n"
        "import hypre_tpu_torch.amg.hybrid, hypre_tpu_torch.amg.mgr\n"
        "import hypre_tpu_torch.amg.block_tridiag\n"
        "import hypre_tpu_torch.amg.gsmg, hypre_tpu_torch.amg.smoothed_agg\n"
        "import hypre_tpu_torch.seq.bsr, hypre_tpu_torch.amg.block_amg\n"
        "import hypre_tpu_torch.amg.ams, hypre_tpu_torch.amg.ads\n"
        "import hypre_tpu_torch.amg.ame, hypre_tpu_torch.multivector\n"
        "import hypre_tpu_torch.problems.maxwell\n"
        "import hypre_tpu_torch.precond.ilu, hypre_tpu_torch.precond.ic\n"
        "import hypre_tpu_torch.precond.euclid, hypre_tpu_torch.precond.fsai\n"
        "import hypre_tpu_torch.precond.parasails\n"
        "import hypre_tpu_torch.precond.schwarz, hypre_tpu_torch.precond.poly\n"
        "import hypre_tpu_torch.precond.ilu_schur\n"
        "import hypre_tpu_torch.precond.saddle\n"
        "import hypre_tpu_torch.core.error, hypre_tpu_torch.stats\n"
        "import hypre_tpu_torch.drivers.ij, hypre_tpu_torch.drivers.struct\n"
        "import hypre_tpu_torch.struct, hypre_tpu_torch.struct.smg\n"
        "import hypre_tpu_torch.struct.sparse_msg, hypre_tpu_torch.struct.io\n"
        "import hypre_tpu_torch.struct.hybrid, hypre_tpu_torch.struct.cycred\n"
        "import hypre_tpu_torch.problems.struct_problems\n"
        "import hypre_tpu_torch.sstruct, hypre_tpu_torch.sstruct.fem\n"
        "import hypre_tpu_torch.sstruct.split, hypre_tpu_torch.sstruct.fac\n"
        "import hypre_tpu_torch.sstruct.syspfmg\n"
        "import hypre_tpu_torch.sstruct.maxwell, hypre_tpu_torch.fei\n"
        "import hypre_tpu_torch.drivers.sstruct\n"
        "import hypre_tpu_torch.parallel, hypre_tpu_torch.parallel.comm\n"
        "import hypre_tpu_torch.parallel.mesh, hypre_tpu_torch.parallel.halo\n"
        "import hypre_tpu_torch.parallel.par_ell\n"
        "import hypre_tpu_torch.parallel.par_amg\n"
        "import hypre_tpu_torch.parallel.par_setup\n"
        "import hypre_tpu_torch.parallel.multihost\n"
        "import hypre_tpu_torch.core.partition, hypre_tpu_torch.core.timing\n"
        "import hypre_tpu_torch.matrix_facade, hypre_tpu_torch.drivers.ij_mm\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'hypre_tpu', 'scipy')]\n"
        "assert not bad, bad\n"
        "assert not hypre_tpu_torch.kernels._libs\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_source_scan_finds_no_jax_or_reference_import():
    pattern = re.compile(r"^\s*(import\s+(jax|hypre_tpu)\b|"
                         r"from\s+(jax|hypre_tpu)[\s.])", re.M)
    assert len(PORT_FILES) > 15
    names = {p.name for p in PORT_FILES}
    assert {"slabops.py", "transfer_dia.py", "device_setup.py",
            "memory.py", "boomeramg.py", "air.py", "common.py", "gmres.py",
            "cogmres.py", "flexgmres.py", "lgmres.py", "bicgstab.py",
            "cgnr.py", "lobpcg.py", "ij.py", "io.py", "refine.py",
            "twofloat.py", "unstructured.py", "hybrid.py", "mgr.py",
            "block_tridiag.py", "gsmg.py", "smoothed_agg.py", "bsr.py",
            "block_amg.py", "ams.py", "ads.py", "ame.py", "multivector.py",
            "maxwell.py", "ilu.py", "ic.py", "euclid.py", "fsai.py",
            "parasails.py", "schwarz.py", "poly.py", "ilu_schur.py",
            "saddle.py", "error.py", "stats.py", "stencil.py", "matrix.py",
            "probe.py", "semi.py", "relax.py", "cycred.py", "jacobi.py",
            "pfmg.py", "smg.py", "sparse_msg.py",
            "struct_problems.py", "grid.py", "split.py", "syspfmg.py",
            "fac.py", "fem.py", "fei.py", "partition.py", "timing.py",
            "matrix_facade.py", "ij_mm.py", "comm.py", "mesh.py", "halo.py",
            "par_ell.py", "par_amg.py", "par_setup.py",
            "multihost.py"} <= names
    for rel in ("drivers/ij.py", "drivers/struct.py", "struct/hybrid.py",
                "struct/io.py", "struct/__init__.py", "drivers/sstruct.py",
                "sstruct/__init__.py", "sstruct/matrix.py",
                "sstruct/maxwell.py", "fei.py", "parallel/__init__.py",
                "parallel/mesh.py", "core/partition.py", "core/timing.py",
                "drivers/ij_mm.py"):
        assert ROOT / "hypre_tpu_torch" / rel in PORT_FILES
    for path in PORT_FILES:
        text = path.read_text()
        assert not pattern.search(text), path
        assert "hypre_tpu." not in re.sub(r"#.*|\"\"\"[\s\S]*?\"\"\"|"
                                          r"\"[^\"\n]*\"", "", text), path


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
