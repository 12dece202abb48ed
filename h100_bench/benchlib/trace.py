"""A profiler window and its reduction to device time.

`Trace` runs torch.profiler (host and CUDA activity) over part of a
run's measured window. `summarize` reduces it: the traced window's
length on the host clock, the device's busy time (the union of its
kernel, copy and set intervals, clipped to the window), device time
and count by operation name, and the longest idle gaps, each named by
the innermost host span or operation running at its midpoint.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10
#: the host span that marks the traced window
WINDOW = "hb.trace_window"
_COPY = ("memcpy", "memset", "Memcpy", "Memset")


@dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: Dict[str, Tuple[float, int]]      # name -> (s, count)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def op_time(self, stem: str) -> float:
        return sum(s for n, (s, _) in self.device_ops.items() if stem in n)

    def op_count(self, stem: str) -> int:
        return sum(c for n, (_, c) in self.device_ops.items() if stem in n)

    def kernel_time_excluding(self, stems) -> float:
        return sum(s for n, (s, _) in self.device_ops.items()
                   if not any(x in n for x in stems)
                   and not any(x in n for x in _COPY))

    def breakdown(self) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1][0])
        return {"device_ops": [[n[:120], s] for n, (s, _) in ops[:TOP]],
                "idle_gaps": [[n[:120], s] for n, s in self.gaps[:TOP]]}


class Trace:
    """with Trace(device) as tr: ... ; then tr.summary (reduced on first
    use, after the measured part). A no-op off CUDA (the CPU runs of
    the tests)."""

    def __init__(self, device):
        self.enabled = torch.device(device).type == "cuda"
        self.prof = None
        self._summary: Optional[Summary] = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._mark = torch.profiler.record_function(WINDOW)
            self._mark.__enter__()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            torch.cuda.synchronize()
            self._wall = time.perf_counter() - self._t0
            self._mark.__exit__(None, None, None)
            self.prof.__exit__(*exc)
        return False

    @property
    def summary(self) -> Optional[Summary]:
        if self.prof is not None and self._summary is None:
            self._summary = summarize(self.prof, self._wall)
        return self._summary


def _events(prof):
    """(device?, start us, end us, name, user annotation?) of every
    event, from the profiler's raw results."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        yield (e.device_type() == DeviceType.CUDA, a,
               a + e.duration_ns() / 1e3, e.name(), e.is_user_annotation())


def summarize(prof, wall_s: float) -> Summary:
    return reduce_events(_events(prof), wall_s)


def reduce_events(events, wall_s: float) -> Summary:
    """The summary of (device?, start us, end us, name, annotation?)
    events, the window marked by its host span; wall_s, the window's
    host-clock length, stands where the trace holds no such span."""
    dev, host, marks = [], [], []
    for on_dev, a, b, name, note in events:
        if name == WINDOW and not on_dev:
            marks.append((a, b))
        elif note and name.startswith("hb.") and on_dev:
            continue            # the device-side copy of a host span
        elif on_dev:
            dev.append((a, b, name))
        else:
            host.append((a, b, name))
    if not marks:
        return Summary(wall_s, 0.0, {})
    t0, t1 = marks[0]
    wall_s = (t1 - t0) / 1e6
    by_name: Dict[str, Tuple[float, int]] = {}
    spans = []
    for a, b, name in dev:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        spans.append((a, b))
        s, c = by_name.get(name, (0.0, 0))
        by_name[name] = (s + (b - a) / 1e6, c + 1)
    spans.sort()
    busy, end, gaps = 0.0, t0, []
    for a, b in spans:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if t1 > end:
        gaps.append((end, t1))
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    named = []
    for a, b in gaps[:TOP]:
        mid = 0.5 * (a + b)
        inner = [(s, n) for s, e, n in host if s <= mid <= e]
        label = max(inner)[1] if inner else "host: no traced span"
        named.append((label, (b - a) / 1e6))
    return Summary(wall_s, busy / 1e6, by_name, named)
