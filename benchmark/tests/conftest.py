"""The benchmark's own tests (CPU, small grids): run them with
``python -m pytest benchmark/tests -q`` from the checkout's root."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
