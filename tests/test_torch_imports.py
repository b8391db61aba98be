"""hypre_tpu_torch stands alone: it imports neither JAX nor hypre_tpu,
builds nothing at import time, and chip_smoke.py refuses to run without a
card."""

import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "hypre_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = (
        "import sys, hypre_tpu_torch\n"
        "import hypre_tpu_torch.convert, hypre_tpu_torch.kernels\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'hypre_tpu')]\n"
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
