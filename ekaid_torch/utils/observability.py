"""Step timing, profiling and the numerical sanitizer (counterpart of
`ekaid_tpu/utils/observability.py`).

  * `StepTimer`: per-step wall clock and an EMA of it, with items/s.
  * `profile`: a `torch.profiler` trace of the CPU, and of the CUDA
    device when one is present, written into `logdir` as a Chrome trace
    (`trace.json`; open it in Perfetto or chrome://tracing).
  * `enable_nan_debugging`: `torch.autograd.set_detect_anomaly`, which
    raises at the first backward op that produces NaN, naming the
    forward op that made it.
  * `log_compile_time`: the first call apart from the steady state. The
    port compiles nothing at run time but its kernels, which nvcc builds
    at their first use (`ekaid_torch/kernels.py`); CUDA results are
    synchronised before the clock stops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


class StepTimer:
    """EMA step timing + items/s; use as `with timer: step()`."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self.ema: Optional[float] = None
        self.last: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else (
            self.alpha * dt + (1 - self.alpha) * self.ema)
        self.last = dt
        return False

    def throughput(self, items: int) -> float:
        return items / self.ema if self.ema else float("nan")


@contextlib.contextmanager
def profile(logdir: str = os.path.join("build", "ekaid_profile")):
    """Trace the block with torch.profiler and write
    `<logdir>/trace.json`; yields the profiler (its `key_averages()`
    sums by op)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_nan_debugging(enable: bool = True):
    """Anomaly detection for every later backward pass (slow; for
    debugging only)."""
    torch.autograd.set_detect_anomaly(enable)


def _synchronize(out) -> None:
    tensors = (out if isinstance(out, (list, tuple))
               else list(out.values()) if isinstance(out, dict) else [out])
    devices = {t.device for t in tensors
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


def log_compile_time(fn: Callable, name: str = "fn") -> Callable:
    """Wrap fn: print the first call's time (its kernels' build
    included) apart from later calls'."""
    state = {"calls": 0}

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _synchronize(out)
        dt = time.perf_counter() - t0
        state["calls"] += 1
        tag = "compile+run" if state["calls"] == 1 else "run"
        print(f"[{name}] {tag}: {dt * 1e3:.2f} ms")
        return out

    return wrapper
