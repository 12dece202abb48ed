"""Backend resolution of the port (counterpart of part of
`ekaid_tpu/utils/platform.py`)."""

from __future__ import annotations


def resolve_roi_backend(backend: str) -> str:
    """`detector.roi_backend` 'auto' -> 'canvas'. The canvas wrapper
    (`ops/roi_kernels.py`) launches the K2 kernel for a CUDA tensor and
    runs its plain version for a CPU tensor, so no device query is
    needed; the other names pass through."""
    return "canvas" if backend == "auto" else backend
