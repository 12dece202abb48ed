"""Process-level rules of a run: where caches go, when the process
started, and the check that no JAX module was loaded."""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
#: top-level module names a run must not load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ekaid_tpu")


def process_start_wall() -> float:
    """The wall-clock time this process started, from /proc (ticks since
    boot) and the uptime; the import time of this module elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        hz = os.sysconf(os.sysconf_names["SC_CLK_TCK"])
        return time.time() - (uptime - start_ticks / hz)
    except (OSError, ValueError, KeyError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def set_cache_dirs() -> None:
    """Fixed cache directories inside the checkout, so that only the first
    run of a checkout builds (the program keeps its own nvcc and g++
    outputs under build/ekaid_torch at the checkout's root)."""
    cache = ROOT / "build" / "h100_bench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules(names=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN."""
    names = list(sys.modules) if names is None else list(names)
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
