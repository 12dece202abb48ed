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
