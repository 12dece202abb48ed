"""Faster R-CNN R50-FPN: detection and per-class node extraction.

Counterpart of `ekaid_tpu/models/detector/faster_rcnn.py` (inference):
backbone -> RPN proposals -> ROIAlign -> box head -> class-wise NMS that
keeps the proposal indices -> per-class top-1 selection. `extract`
returns exactly `num_classes` ordered nodes per image with their fc2
features (zero-filled where a class is missing); `detect` returns the
top-`max_out` detections with their proposal features. The reference
`vmap`s its per-image selection; here the image is a batch dimension.
The training losses come with the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from ekaid_torch.models.detector.anchors import pyramid_anchors
from ekaid_torch.models.detector.backbone import ResNetFPN
from ekaid_torch.models.detector.heads import BoxHead, decode_roi_boxes
from ekaid_torch.models.detector.rpn import RPNHead, generate_proposals
from ekaid_torch.ops.nms import (fast_rcnn_nms, select_top1_per_class,
                                 top1_per_class)
from ekaid_torch.utils.dtypes import F32, Policy
from ekaid_torch.utils.platform import resolve_roi_backend

FPN_SCALES = (0.25, 0.125, 0.0625, 0.03125)      # p2..p5


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-image gather: x [B, N, ...], idx [B, M] -> [B, M, ...]."""
    idx = idx.long()
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


class FasterRCNN(nn.Module):
    """cfg is a DetectorConfig. Images are NHWC floats [B, S, S, 3]."""

    def __init__(self, cfg: Any, num_classes: int = 26, norm: str = "gn",
                 stride_in_1x1: bool = False, policy: Policy = F32):
        super().__init__()
        self.cfg = cfg
        self.num_classes = num_classes
        self.backbone = ResNetFPN(cfg.fpn_channels, norm=norm,
                                  stride_in_1x1=stride_in_1x1, policy=policy)
        self.rpn = RPNHead(cfg.fpn_channels, policy=policy)
        self.box_head = BoxHead(num_classes, cfg.fpn_channels,
                                fc_dim=cfg.roi_feat_dim,
                                pool_size=cfg.roi_pool_size, policy=policy,
                                roi_backend=resolve_roi_backend(
                                    cfg.roi_backend))
        for i, a in enumerate(pyramid_anchors(cfg.image_size)):
            self.register_buffer(f"anchors{i}", torch.as_tensor(a),
                                 persistent=False)

    def anchors(self) -> List[torch.Tensor]:
        return [getattr(self, f"anchors{i}") for i in range(5)]

    def features(self, images) -> List[torch.Tensor]:
        """NHWC pyramid [p2..p6]."""
        feats = self.backbone(images)
        return [feats[f"p{lvl}"] for lvl in (2, 3, 4, 5, 6)]

    def proposals(self, pyramid):
        logits, deltas = self.rpn(pyramid)
        return generate_proposals(
            logits, deltas, self.anchors(), self.cfg.image_size,
            pre_nms_topk=self.cfg.pre_nms_topk,
            post_nms_topk=self.cfg.post_nms_topk, nms_thresh=0.7,
            topk_impl=self.cfg.rpn_topk)

    def forward(self, images, topk: int = 0) -> Dict[str, torch.Tensor]:
        """Detection forward: proposals and ROI outputs for all B*R
        proposals in one pooling call. `topk` > 0 keeps only the best
        `topk` proposals (they arrive score-sorted)."""
        pyramid = self.features(images)
        boxes, scores, valid = self.proposals(pyramid)
        if topk:
            boxes, scores, valid = boxes[:, :topk], scores[:, :topk], \
                valid[:, :topk]
        feats, cls_scores, box_deltas = self.box_head(pyramid[:4], boxes,
                                                      FPN_SCALES)
        return {"proposals": boxes, "proposal_scores": scores,
                "proposal_valid": valid, "roi_features": feats,
                "cls_scores": cls_scores, "box_deltas": box_deltas}

    def _probs_and_boxes(self, out):
        probs = torch.softmax(out["cls_scores"].float(), dim=-1)
        probs = torch.where(out["proposal_valid"][..., None], probs,
                            torch.zeros((), device=probs.device))
        dec = decode_roi_boxes(out["box_deltas"], out["proposals"],
                               self.cfg.image_size)
        return probs, dec

    def extract(self, images) -> Dict[str, torch.Tensor]:
        """Per-class node extraction: features [B, K, fc_dim], boxes
        [B, K, 4], scores [B, K], classes [B, K] (the class, or K when
        missing), found [B, K]."""
        et = self.cfg.extract_topk
        topk = et if et and et < self.cfg.post_nms_topk else 0
        return self.select_extract(self(images, topk=topk))

    def select_extract(self, out: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """`extract`'s selection from a forward output."""
        cfg, k = self.cfg, self.num_classes
        # pre_extract_num, capped at the effective proposal budget
        pre = min(100, cfg.extract_topk or cfg.post_nms_topk)
        probs, dec = self._probs_and_boxes(out)
        feats = out["roi_features"]
        if cfg.select_impl == "topk":
            det = fast_rcnn_nms(dec, probs, iou_thresh=cfg.nms_thresh,
                                score_thresh=cfg.score_thresh, max_out=pre)
            slot, found = top1_per_class(det["class_idx"], det["valid"], k)
            sel_boxes = _take(det["boxes"], slot)
            sel_feat = _take(feats, _take(det["proposal_idx"], slot))
            sel_scores = _take(det["scores"], slot)
        elif cfg.select_impl == "fused":
            rows, found, sel_scores = select_top1_per_class(
                dec, probs, iou_thresh=cfg.nms_thresh,
                score_thresh=cfg.score_thresh, pre=pre)
            ar = torch.arange(k, device=dec.device)
            sel_boxes = _take(dec, rows)[:, ar, ar]       # class c's box
            sel_feat = _take(feats, rows)
        else:
            raise ValueError(f"unknown select_impl {cfg.select_impl!r}")
        f = found[..., None]
        zero = torch.zeros((), device=dec.device)
        classes = torch.where(found, torch.arange(k, device=dec.device),
                              torch.full_like(found, k, dtype=torch.long))
        return {"features": torch.where(f, sel_feat.float(), zero),
                "boxes": torch.where(f, sel_boxes, zero),
                "scores": torch.where(found, sel_scores, zero),
                "classes": classes.to(torch.int32), "found": found}

    def detect(self, images, max_out: int = 26) -> Dict[str, torch.Tensor]:
        """Top-`max_out` detections per image with proposal features:
        boxes [B, M, 4], classes [B, M] (K where invalid), scores
        [B, M], features [B, M, fc_dim], valid [B, M]."""
        return self.select_detect(self(images), max_out)

    def select_detect(self, out: Dict[str, torch.Tensor], max_out: int = 26
                      ) -> Dict[str, torch.Tensor]:
        """`detect`'s selection from a forward output."""
        probs, dec = self._probs_and_boxes(out)
        det = fast_rcnn_nms(dec, probs, iou_thresh=self.cfg.nms_thresh,
                            score_thresh=self.cfg.score_thresh,
                            max_out=max_out)
        classes = torch.where(det["valid"], det["class_idx"],
                              torch.full_like(det["class_idx"],
                                              self.num_classes))
        return {"boxes": det["boxes"], "classes": classes,
                "scores": det["scores"],
                "features": _take(out["roi_features"],
                                  det["proposal_idx"]).float(),
                "valid": det["valid"]}
