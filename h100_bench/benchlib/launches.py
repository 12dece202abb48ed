"""Device time of the kernels launched inside a named host span.

A kernel runs on the device after the host has launched it, so its
place on the device timeline says nothing of which host span asked for
it. The profiler links the two: the host's launch call (a CUDA runtime
or driver event such as `cudaLaunchKernel`) and the device's kernel,
copy or set carry one correlation id. A device operation belongs to a
span when its launch call started inside that span, on the span's own
thread; its device time is its whole duration (no window clips it).
`reduce_launches` works on plain tuples (device?, start ns, end ns,
name, thread, correlation id, ...), so the CPU tests can hand it
events of their own; `span_device_time` reads a profiler's events.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Tuple

#: host calls that put work on the device
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy",
            "cudaMemset", "cuMemcpy", "cuMemset")


def events(prof):
    """(device?, start ns, end ns, name, thread, correlation id, user
    annotation?) of every event of a finished torch.profiler run."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        yield (e.device_type() == DeviceType.CUDA, a, a + e.duration_ns(),
               e.name(), e.start_thread_id(), e.correlation_id(),
               e.is_user_annotation())


def reduce_launches(evs: Iterable[Tuple], names) -> Dict[str, dict]:
    """{span name: {"spans": n, "device_s": s, "ops": k}} for each name
    of `names`: the device time and count of the device operations
    launched inside its spans."""
    spans: Dict[str, Dict[int, List[Tuple[int, int]]]] = {n: {}
                                                           for n in names}
    launch: Dict[int, Tuple[int, int]] = {}
    device: List[Tuple[int, int]] = []
    for on_dev, a, b, name, tid, corr, *_ in evs:
        if on_dev:
            if corr:
                device.append((corr, b - a))
        elif name in spans:
            spans[name].setdefault(tid, []).append((a, b))
        elif corr and name.startswith(LAUNCHES):
            launch[corr] = (a, tid)
    out = {}
    for name, by_tid in spans.items():
        starts = {tid: sorted(v) for tid, v in by_tid.items()}
        heads = {tid: [s for s, _ in v] for tid, v in starts.items()}
        total, ops = 0, 0
        for corr, dur in device:
            at = launch.get(corr)
            if at is None or at[1] not in starts:
                continue
            t, tid = at
            i = bisect.bisect_right(heads[tid], t) - 1
            if i >= 0 and starts[tid][i][1] >= t:
                total += dur
                ops += 1
        out[name] = {"spans": sum(len(v) for v in by_tid.values()),
                     "device_s": total / 1e9, "ops": ops}
    return out


def span_device_time(prof, names) -> Dict[str, dict]:
    return reduce_launches(events(prof), names)
