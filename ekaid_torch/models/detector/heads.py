"""ROI box head: multilevel ROIAlign -> 2xFC-1024 -> class/box predictors.

Counterpart of `ekaid_tpu/models/detector/heads.py`: 7x7xC pooled
features, two FC layers whose second ReLU output is the 1024-d node
feature the extraction keeps, a (K+1)-way classifier and K x 4
class-specific box deltas with weights (10, 10, 5, 5); the proposals'
targets, their sampling before pooling, and the ROI loss. The
reference's canvas schedule (`roi_group`, `roi_unroll`) sets how its
Pallas grid walks the ROIs; the CUDA kernel has no such schedule.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ekaid_torch.models.detector.anchors import (clip_boxes, decode_boxes,
                                                 encode_boxes)
from ekaid_torch.models.detector.rpn import sample_targets
from ekaid_torch.models.layers import DenseT
from ekaid_torch.ops.nms import box_iou, top_k
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
        backend's kernel ('canvas': K2, 'pallas': K3; inference only,
        they refuse inputs that require grad); 'xla' is the gather
        form, per image, and so is one image's [R, 4]."""
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
        return self.head(self.pool(fmaps, rois, scales))

    def head(self, pooled: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The layers after pooling: [..., pool, pool, C] -> (features,
        scores, deltas)."""
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


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., R, *tail], idx [..., S] -> [..., S, *tail]."""
    tail = x.shape[idx.dim():]
    i = idx.reshape(*idx.shape, *(1,) * len(tail)).expand(*idx.shape, *tail)
    return torch.gather(x, idx.dim() - 1, i)


def roi_targets(proposals: torch.Tensor, gt_boxes: torch.Tensor,
                gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                num_classes: int, iou_thresh: float = 0.5
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each proposal's class label (background = num_classes) and
    matched gt index (Detectron2's label_and_sample matcher at 0.5).
    proposals [..., R, 4], gt [..., G, 4] -> int32 [..., R], int64
    [..., R]."""
    iou = box_iou(proposals, gt_boxes)
    iou = torch.where(gt_valid[..., None, :], iou,
                      torch.full_like(iou, -1.0))
    best = torch.argmax(iou, dim=-1)
    best_iou = iou.amax(dim=-1)
    cls = torch.where(best_iou >= iou_thresh,
                      torch.gather(gt_classes.long(), -1, best),
                      torch.full_like(best, num_classes))
    return cls.to(torch.int32), best


def sample_proposals(proposals: torch.Tensor, proposal_valid: torch.Tensor,
                     gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                     gt_valid: torch.Tensor, u_pos: torch.Tensor,
                     u_neg: torch.Tensor, u_tie: torch.Tensor,
                     num_classes: int, batch_size: int = 512,
                     positive_fraction: float = 0.25
                     ) -> Dict[str, torch.Tensor]:
    """Match and subsample the proposals before pooling (Detectron2's
    label_and_sample_proposals order). u_pos, u_neg: the sampling
    priorities, u_tie: the draw that orders the sampled rows (the
    reference's `fold_in(rng, 7)`), each uniform [..., R].

    Returns {'idx', 'weight', 'cls', 'matched'} [..., S] with S =
    min(batch_size, R): the sampled rows first (highest priority
    w + 1e-3 u_tie), `weight` 0 on the pad rows after them."""
    cls_t, matched = roi_targets(proposals, gt_boxes, gt_classes, gt_valid,
                                 num_classes)
    fg = (cls_t < num_classes) & proposal_valid
    bg = (cls_t == num_classes) & proposal_valid
    s_labels = torch.where(fg, torch.ones_like(cls_t),
                           torch.where(bg, torch.zeros_like(cls_t),
                                       torch.full_like(cls_t, -1)))
    w = sample_targets(s_labels, u_pos, u_neg, batch_size=batch_size,
                       positive_fraction=positive_fraction)
    s = min(batch_size, proposals.shape[-2])
    _, idx = top_k(w + u_tie * 1e-3, s)
    return {"idx": idx, "weight": torch.gather(w, -1, idx),
            "cls": torch.gather(cls_t, -1, idx),
            "matched": torch.gather(matched, -1, idx)}


def roi_loss(scores: torch.Tensor, deltas: torch.Tensor,
             proposals: torch.Tensor, cls_t: torch.Tensor,
             matched: torch.Tensor, weight: torch.Tensor,
             gt_boxes: torch.Tensor, num_classes: int,
             batch_size: int = 512) -> Dict[str, torch.Tensor]:
    """ROI losses over the sampled rows: softmax cross-entropy, and L1
    (Detectron2's smooth-L1 at beta 0) of the matched class's deltas on
    the foreground, normalised by the sampling batch size. scores
    [..., S, K+1], deltas [..., S, K*4] flat, proposals [..., S, 4]."""
    logp = torch.log_softmax(scores.float(), dim=-1)
    ce = -torch.gather(logp, -1, cls_t.long()[..., None])[..., 0]
    cls_loss = (ce * weight).sum(-1) / batch_size
    gt = gather_rows(gt_boxes, matched.long())
    target = encode_boxes(proposals, gt, weights=ROI_WEIGHTS)
    base = torch.clamp(cls_t.long(), 0, num_classes - 1)[..., None] * 4
    cols = base + torch.arange(4, device=base.device)
    picked = torch.gather(deltas, -1, cols)
    l1 = (picked - target).abs().sum(-1)
    fg = (cls_t < num_classes).to(l1.dtype)
    box_loss = (l1 * weight * fg).sum(-1) / batch_size
    return {"roi_cls": cls_loss, "roi_box": box_loss}
