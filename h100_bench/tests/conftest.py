"""The benchmark's own CPU tests: `pytest h100_bench/tests -q`."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
