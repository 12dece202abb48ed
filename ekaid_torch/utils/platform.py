"""Backend resolution of the port (counterpart of part of
`ekaid_tpu/utils/platform.py`)."""

from __future__ import annotations

#: `speaker.decode_kernel`'s names, as the reference's
DECODE_KERNELS = ("auto", "xla", "pallas", "pallas_interpret")


def resolve_roi_backend(backend: str) -> str:
    """`detector.roi_backend` 'auto' -> 'canvas'. The canvas wrapper
    (`ops/roi_kernels.py`) launches the K2 kernel for a CUDA tensor and
    runs its plain version for a CPU tensor, so no device query is
    needed; the other names pass through."""
    return "canvas" if backend == "auto" else backend


def resolve_decode_kernel(kernel: str) -> str:
    """`speaker.decode_kernel` 'auto' -> 'pallas', the greedy kernel K1
    (`models/greedy_decode.py`): K1 for a CUDA tensor, its plain twin
    for a CPU tensor, so no device query is needed. 'xla' is the torch
    step loop on either device (`DynamicSpeaker._sample_loop`), the
    only greedy path that takes `weight_quant` and `fused_core`;
    'pallas_interpret' is K1's plain twin, for CPU tensors only. The
    reference resolves 'auto' to its loop off its accelerator; the port
    keeps K1 there, so a CPU decode with a knob sets 'xla'."""
    if kernel not in DECODE_KERNELS:
        raise ValueError(f"speaker.decode_kernel {kernel!r}: one of "
                         f"{DECODE_KERNELS}")
    return "pallas" if kernel == "auto" else kernel
