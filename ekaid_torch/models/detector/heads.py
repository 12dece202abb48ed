"""ROI box head: multilevel ROIAlign -> 2xFC-1024 -> class/box predictors.

Counterpart of `ekaid_tpu/models/detector/heads.py` (inference): 7x7xC
pooled features, two FC layers whose second ReLU output is the 1024-d
node feature the extraction keeps, a (K+1)-way classifier and K x 4
class-specific box deltas with weights (10, 10, 5, 5). Target matching,
proposal sampling and the ROI loss come with the training slice. The
reference's canvas schedule (`roi_group`, `roi_unroll`) sets how its
Pallas grid walks the ROIs; the CUDA kernel has no such schedule.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ekaid_torch.models.detector.anchors import clip_boxes, decode_boxes
from ekaid_torch.models.layers import DenseT
from ekaid_torch.ops.roi_align import multilevel_roi_align
from ekaid_torch.ops.roi_kernels import (multilevel_roi_align_canvas,
                                         multilevel_roi_align_pallas)
from ekaid_torch.utils.dtypes import F32, Policy

ROI_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
ROI_BACKENDS = ("xla", "pallas", "canvas")


class BoxHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int,
                 fc_dim: int = 1024, pool_size: int = 7,
                 policy: Policy = F32, roi_backend: str = "xla"):
        super().__init__()
        if roi_backend not in ROI_BACKENDS:
            raise ValueError(f"unknown roi_backend {roi_backend!r}")
        self.pool_size = pool_size
        self.policy = policy
        self.roi_backend = roi_backend
        flat = pool_size * pool_size * in_channels
        self.fc1 = DenseT(flat, fc_dim, policy=policy)
        self.fc2 = DenseT(fc_dim, fc_dim, policy=policy)
        self.cls_score = DenseT(fc_dim, num_classes + 1, policy=policy)
        self.bbox_pred = DenseT(fc_dim, num_classes * 4, policy=policy)

    def pool(self, fmaps: Sequence[torch.Tensor], rois: torch.Tensor,
             scales: Sequence[float]) -> torch.Tensor:
        """NHWC p2..p5 ([B, H, W, C] with rois [B, R, 4], or one image)
        -> [..., R, pool, pool, C]. A batch pools in one call of the
        backend's kernel ('canvas': K2, 'pallas': K3); 'xla' is the
        gather form, per image."""
        o = self.pool_size
        if rois.dim() == 3 and self.roi_backend == "canvas":
            return multilevel_roi_align_canvas(fmaps, rois, scales,
                                               out_size=o)
        if rois.dim() == 3 and self.roi_backend == "pallas":
            return multilevel_roi_align_pallas(fmaps, rois, scales,
                                               out_size=o)
        if rois.dim() == 3:
            return torch.stack([
                multilevel_roi_align([f[i] for f in fmaps], rois[i], scales,
                                     out_size=o)
                for i in range(rois.shape[0])])
        return multilevel_roi_align(fmaps, rois, scales, out_size=o)

    def forward(self, fmaps: Sequence[torch.Tensor], rois: torch.Tensor,
                scales: Sequence[float]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (features [..., fc_dim], scores [..., K+1], deltas
        [..., K*4])."""
        pooled = self.pool(fmaps, rois, scales)
        x = self.policy.cast_compute(pooled.reshape(*pooled.shape[:-3], -1))
        x = torch.relu(self.fc1(x))
        feat = torch.relu(self.fc2(x))
        return feat, self.cls_score(feat), self.bbox_pred(feat)


def decode_roi_boxes(deltas: torch.Tensor, proposals: torch.Tensor,
                     image_size: int) -> torch.Tensor:
    """deltas [..., R, K*4] flat, proposals [..., R, 4] -> clipped
    [..., R, K, 4]."""
    k = deltas.shape[-1] // 4
    boxes = decode_boxes(deltas.reshape(*deltas.shape[:-1], k, 4),
                         proposals[..., None, :], weights=ROI_WEIGHTS)
    return clip_boxes(boxes, image_size)
