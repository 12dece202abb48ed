"""Device rule of the port's entry points: CUDA unless asked otherwise."""

from __future__ import annotations

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
