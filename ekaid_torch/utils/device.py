"""Device rule of the port's entry points: CUDA unless asked otherwise."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. 'cuda' (the default) raises
    when no card is visible; the CPU is used only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ekaid_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def host_to_device(array, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`: copied from pinned memory
    without blocking the host for a CUDA device, as is for the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


class HostCopy:
    """A tensor's copy to the host, started now and waited for alone.
    From a CUDA device the copy goes into pinned memory without blocking
    the host, queued on the device's current stream behind the work that
    made the tensor, with an event recorded after it: `wait` ends when
    this tensor is on the host, not when the work queued since has run.
    Elsewhere the tensor is read at once."""

    def __init__(self, t: torch.Tensor):
        self._done = None
        if t.device.type != "cuda":
            self._host = t.cpu()
            return
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._host.copy_(t, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record(torch.cuda.current_stream(t.device))

    def wait(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()


def visible_devices(device: torch.device) -> list:
    """The devices a model on `device` can be copied to: every CUDA
    device for a CUDA model (its own first), the CPU alone for a CPU
    one."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    own = device.index if device.index is not None else \
        torch.cuda.current_device()
    return [torch.device("cuda", own)] + [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())
        if i != own]
