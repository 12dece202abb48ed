"""Spans, profiling and the numerical sanitizer (counterpart of
`ekaid_tpu/utils/observability.py`).

  * `span(name)`: a named host range. While a `torch.profiler` records,
    it is a FUNCTION-scope record in the profiler's own trace (on the
    clock of the CUDA activity, and not copied onto the device
    timeline, as a `record_function` annotation is), and its host time
    is added up by name; `count(name, n)` adds to a counter in the same
    way. `recorded()` reads both, `reset_recorded()` clears them. With
    no profiler recording, `span` returns one shared no-op context
    after a single flag check, and `count` returns at once.
  * `profile`: a `torch.profiler` trace of the CPU, and of the CUDA
    device when one is present, written into `logdir` as a Chrome trace
    (`trace.json`; open it in Perfetto or chrome://tracing).
  * `enable_nan_debugging`: `torch.autograd.set_detect_anomaly`, which
    raises at the first backward op that produces NaN, naming the
    forward op that made it.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
_RecordFunctionFast = getattr(torch._C._profiler, "_RecordFunctionFast",
                              None)
_lock = threading.Lock()
#: name -> [count, host ns] of the spans closed while recording
_spans: Dict[str, List[int]] = {}
_counts: Dict[str, int] = {}


class _Span:
    __slots__ = ("name", "_record", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._record = (_RecordFunctionFast(name) if _RecordFunctionFast
                        else _OFF)

    def __enter__(self):
        self._record.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        self._record.__exit__(*exc)
        with _lock:
            rec = _spans.setdefault(self.name, [0, 0])
            rec[0] += 1
            rec[1] += dt
        return False


def span(name: str):
    """`with span("ekaid.eval.score"): ...`: see the module's doc."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while a profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def recorded() -> dict:
    """{"spans": {name: {"count", "host_s"}}, "counts": {name: n}}: what
    the spans and counters added up since the last reset."""
    with _lock:
        return {"spans": {k: {"count": c, "host_s": t / 1e9}
                          for k, (c, t) in _spans.items()},
                "counts": dict(_counts)}


def reset_recorded() -> None:
    with _lock:
        _spans.clear()
        _counts.clear()


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
