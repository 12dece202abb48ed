"""Greedy NMS with one block per image: the K4 kernel and its plain
version.

Counterpart of `ekaid_tpu/ops/pallas_nms.py`. Each image runs `max_out`
dependent steps: take the live row with the largest score (the lowest
index among equal scores), emit it, and kill it and every row whose
geometric IoU with it exceeds the threshold. A row is live iff its
score is above NEG / 2, so padding rows carry NEG. When nothing is
live, every remaining slot is (0, False). The selections are
bit-equal to `ops/nms.py::nms` (the blocked NMS) and `nms_argmax`.

IoU is evaluated in one order everywhere: area = max(x2 - x1, 0) *
max(y2 - y1, 0), iw/ih clamped at 0, union = (area + barea) - inter,
iou = inter / union where union > 0 else 0, each step rounded (the
kernel writes them as `__fsub_rn`/`__fmul_rn`/`__fadd_rn`/`__fdiv_rn`,
so nothing is contracted into an FMA).

For a CUDA tensor `nms_kernel` launches `ekaid_torch/csrc/nms.cu` once
for the whole batch and counts the launch in `nms_kernel.launches`; it
never falls back. For a CPU tensor it runs `nms_kernel_plain`, a batched
torch transcription of the same steps with no host read.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG = -1e9
# The kernel keeps x1, y1, x2, y2, area and the live score of every row
# (24 bytes) in shared memory; a block of an sm_90 card may have 232,448
# bytes of it, less the kernel's 512 bytes of reduction scratch.
MAX_ROWS = (232448 - 512) // 24


def _flatten(boxes: torch.Tensor, scores: torch.Tensor):
    """Checks; boxes [N, R, 4] and scores [N, R] f32 over the flattened
    leading dims."""
    if boxes.shape[:-1] != scores.shape or boxes.shape[-1:] != (4,):
        raise ValueError(f"nms: boxes {tuple(boxes.shape)} and scores "
                         f"{tuple(scores.shape)} must be [..., R, 4] and "
                         "[..., R]")
    n, r = math.prod(scores.shape[:-1]), scores.shape[-1]
    return boxes.reshape(n, r, 4).float(), scores.reshape(n, r).float()


def nms_kernel_plain(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_thresh: float, max_out: int,
                     live_rows: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's function in plain torch. boxes [..., R, 4], scores [..., R]
    -> (indices [..., max_out] int32, valid [..., max_out] bool).

    `live_rows`, an int64 tensor of the flattened batch's length on the
    same device, gets each image's rows live at the start of every step
    added to it: the rows that the steps' IoU passes need."""
    lead = scores.shape[:-1]
    boxes, scores = _flatten(boxes, scores)
    n, r = scores.shape
    dev = scores.device
    idx_out = torch.zeros(n, max_out, dtype=torch.int32, device=dev)
    valid_out = torch.zeros(n, max_out, dtype=torch.bool, device=dev)
    if r and max_out:
        neg = torch.full_like(scores, NEG)
        masked = torch.where(scores > NEG / 2, scores, neg)
        x1, y1, x2, y2 = boxes.unbind(-1)
        area = (torch.clamp(x2 - x1, min=0.0)
                * torch.clamp(y2 - y1, min=0.0))
        ar = torch.arange(r, device=dev)
        beyond = torch.full_like(ar, r)
        for i in range(max_out):
            if live_rows is not None:
                live_rows += (masked > NEG).sum(-1)
            best_val = masked.amax(dim=-1, keepdim=True)           # [n, 1]
            best = torch.where(masked == best_val, ar, beyond).amin(
                dim=-1, keepdim=True)                               # [n, 1]
            ok = best_val > NEG
            bx1, by1, bx2, by2 = (torch.gather(c, 1, best)
                                  for c in (x1, y1, x2, y2))
            barea = torch.gather(area, 1, best)
            iw = torch.clamp(torch.minimum(x2, bx2) - torch.maximum(x1, bx1),
                             min=0.0)
            ih = torch.clamp(torch.minimum(y2, by2) - torch.maximum(y1, by1),
                             min=0.0)
            inter = iw * ih
            union = area + barea - inter
            iou = torch.where(union > 0, inter / union,
                              torch.zeros_like(inter))
            masked = torch.where((iou > iou_thresh) | (ar == best), neg,
                                 masked)
            idx_out[:, i] = torch.where(ok, best, 0)[:, 0].to(torch.int32)
            valid_out[:, i] = ok[:, 0]
    return (idx_out.reshape(*lead, max_out),
            valid_out.reshape(*lead, max_out))


def _kernel_launch(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_thresh: float, idx: torch.Tensor,
                   valid: torch.Tensor) -> None:
    """The launch alone: contiguous f32 boxes [N, R, 4] and scores
    [N, R] on one CUDA device into idx [N, M] int32 and valid [N, M]
    bool, made before."""
    from ekaid_torch import kernels
    dev = scores.device
    lib = kernels.load("nms")
    n, r = scores.shape
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ekaid_nms(boxes.data_ptr(), scores.data_ptr(),
                            ctypes.c_float(iou_thresh), idx.data_ptr(),
                            valid.data_ptr(), n, r, idx.shape[1], stream)
    kernels.check(lib, err, "nms kernel launch")


def nms_kernel(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
               max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: greedy NMS of one image (boxes [R, 4], scores [R]) or a batch
    (leading dims flattened) -> (indices [..., max_out] int32, valid
    [..., max_out] bool). The kernel for CUDA tensors, the plain version
    for CPU tensors; R may not exceed MAX_ROWS on either."""
    r = scores.shape[-1]
    if r > MAX_ROWS:
        raise ValueError(f"nms kernel: {r} rows per image exceed the "
                         f"{MAX_ROWS} its shared memory holds")
    if max_out < 0:
        raise ValueError(f"nms kernel: max_out {max_out} < 0")
    if scores.device.type == "cpu":
        return nms_kernel_plain(boxes, scores, iou_thresh, max_out)
    if scores.device.type != "cuda":
        raise ValueError(f"nms kernel: no kernel for {scores.device}")
    if boxes.device != scores.device:
        raise ValueError("nms kernel: boxes and scores on different devices")
    lead = scores.shape[:-1]
    fb, fs = _flatten(boxes, scores)
    fb, fs = fb.contiguous(), fs.contiguous()
    n = fs.shape[0]
    idx = torch.empty(n, max_out, dtype=torch.int32, device=fs.device)
    valid = torch.empty(n, max_out, dtype=torch.bool, device=fs.device)
    if n and max_out:
        _kernel_launch(fb, fs, iou_thresh, idx, valid)
        nms_kernel.launches += 1
    return idx.reshape(*lead, max_out), valid.reshape(*lead, max_out)


nms_kernel.launches = 0
