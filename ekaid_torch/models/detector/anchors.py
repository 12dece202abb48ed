"""Anchor generation and box transforms.

Counterpart of `ekaid_tpu/models/detector/anchors.py`. Detectron2-default
geometry: one anchor size per FPN level (32..512 on strides 4..64),
aspect ratios (0.5, 1.0, 2.0), zero grid offset. Anchors are built on
the host in numpy; the box transforms are torch (Box2BoxTransform
parity: deltas scaled by `weights`, dw/dh clamped at log(1000/16)).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

SCALE_CLAMP = math.log(1000.0 / 16.0)

LEVEL_STRIDES = (4, 8, 16, 32, 64)            # p2..p6
LEVEL_SIZES = (32, 64, 128, 256, 512)
ASPECT_RATIOS = (0.5, 1.0, 2.0)


def level_anchors(stride: int, size: float, feat_h: int, feat_w: int,
                  aspect_ratios: Sequence[float] = ASPECT_RATIOS
                  ) -> np.ndarray:
    """[H*W*A, 4] anchors (x1, y1, x2, y2) for one level."""
    shapes = []
    area = float(size) ** 2
    for ar in aspect_ratios:
        w = math.sqrt(area / ar)
        h = w * ar
        shapes.append((-w / 2.0, -h / 2.0, w / 2.0, h / 2.0))
    base = np.asarray(shapes, np.float32)                # [A, 4]
    xs = (np.arange(feat_w, dtype=np.float32)) * stride
    ys = (np.arange(feat_h, dtype=np.float32)) * stride
    shift_x, shift_y = np.meshgrid(xs, ys)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y],
                      axis=-1).reshape(-1, 1, 4)         # [HW, 1, 4]
    return (shifts + base[None]).reshape(-1, 4)


def pyramid_anchors(image_size: int,
                    strides: Sequence[int] = LEVEL_STRIDES,
                    sizes: Sequence[float] = LEVEL_SIZES):
    """List of per-level anchor arrays for a square image."""
    out = []
    for stride, size in zip(strides, sizes):
        f = int(math.ceil(image_size / stride))
        out.append(level_anchors(stride, size, f, f))
    return out


def encode_boxes(src: torch.Tensor, target: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (1, 1, 1, 1)
                 ) -> torch.Tensor:
    """get_deltas parity: src (anchors/proposals) -> target (gt)."""
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    scx = src[..., 0] + 0.5 * sw
    scy = src[..., 1] + 0.5 * sh
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    tcx = target[..., 0] + 0.5 * tw
    tcy = target[..., 1] + 0.5 * th
    wx, wy, ww, wh = weights
    eps = 1e-6
    dx = wx * (tcx - scx) / torch.clamp(sw, min=eps)
    dy = wy * (tcy - scy) / torch.clamp(sh, min=eps)
    dw = ww * torch.log(torch.clamp(tw, min=eps) / torch.clamp(sw, min=eps))
    dh = wh * torch.log(torch.clamp(th, min=eps) / torch.clamp(sh, min=eps))
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (1, 1, 1, 1)
                 ) -> torch.Tensor:
    """apply_deltas parity. deltas [..., 4], boxes [..., 4] -> [..., 4].
    Deltas in a narrower dtype than the boxes keep it through the
    clamp and the exp, as in the reference."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=SCALE_CLAMP)
    dh = torch.clamp(deltas[..., 3] / wh, max=SCALE_CLAMP)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def clip_boxes(boxes: torch.Tensor, image_size: int) -> torch.Tensor:
    return torch.clamp(boxes, 0.0, float(image_size))
