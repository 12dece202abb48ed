"""Faster R-CNN R50-FPN: detection and per-class node extraction.

Counterpart of `ekaid_tpu/models/detector/faster_rcnn.py` (inference):
backbone -> RPN proposals -> ROIAlign -> box head -> class-wise NMS that
keeps the proposal indices -> per-class top-1 selection. `extract`
returns exactly `num_classes` ordered nodes per image with their fc2
features (zero-filled where a class is missing); `detect` returns the
top-`max_out` detections with their proposal features. The reference
`vmap`s its per-image selection; here the image is a batch dimension.

`losses` is the training objective: the RPN loss over every anchor of
every level, and the ROI loss over 512 proposals an image sampled before
pooling, each image's pooled through the differentiable gather form (as
the reference's `vmap` over 2-D ROIs does; the ROIAlign kernels are
inference only). Like the reference, nothing stops the gradient at the
proposals: the ROI loss reaches the RPN's deltas through the pooled
boxes and through the box targets. The random draws are an argument
(`loss_draws`), and the discrete choices (proposals, anchor labels,
sampled sets) come back and can be replayed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ekaid_torch.models.detector.anchors import pyramid_anchors
from ekaid_torch.models.detector.backbone import ResNetFPN
from ekaid_torch.models.detector.heads import (BoxHead, gather_rows,
                                               decode_roi_boxes, roi_loss,
                                               sample_proposals)
from ekaid_torch.models.detector.rpn import (RPNHead, generate_proposals,
                                             proposals_at, rpn_loss)
from ekaid_torch.ops.nms import (fast_rcnn_nms, select_top1_per_class,
                                 top1_per_class)
from ekaid_torch.ops.roi_align import multilevel_roi_align
from ekaid_torch.utils.dtypes import F32, Policy
from ekaid_torch.utils.platform import resolve_roi_backend

FPN_SCALES = (0.25, 0.125, 0.0625, 0.03125)      # p2..p5
TRAIN_PRE_NMS_TOPK = 2000
#: the discrete choices of a loss step (`FasterRCNN.losses`)
RPN_CHOICES = ("labels", "matched", "weight")
ROI_CHOICES = ("idx", "weight", "cls", "matched")
CHOICES = (tuple("rpn_" + k for k in RPN_CHOICES)
           + ("proposal_index", "proposal_valid")
           + tuple("roi_" + k for k in ROI_CHOICES))


def _strip(choices: Dict[str, torch.Tensor], prefix: str, keys):
    return {k: choices[prefix + k] for k in keys}


def loss_draws(batch: int, n_anchors: int, n_proposals: int,
               gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The uniforms of one loss step, drawn from `gen` on its device:
    per image the RPN sampling's positive and negative priorities [B,
    n_anchors], the ROI sampling's [B, n_proposals] and the ROI
    tie-break [B, n_proposals]."""
    shapes = {"rpn_pos": n_anchors, "rpn_neg": n_anchors,
              "roi_pos": n_proposals, "roi_neg": n_proposals,
              "roi_tie": n_proposals}
    return {k: torch.rand(batch, n, generator=gen, device=gen.device)
            for k, n in shapes.items()}


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

    def proposals(self, pyramid, train: bool = False):
        """(boxes, scores, valid) [B, post_nms_topk, ...]. Training takes
        the top 2000 of a level before the NMS, sorted exactly."""
        logits, deltas = self.rpn(pyramid)
        return self._generate(logits, deltas, train)

    def _generate(self, logits, deltas, train: bool, return_index=False):
        return generate_proposals(
            logits, deltas, self.anchors(), self.cfg.image_size,
            pre_nms_topk=(TRAIN_PRE_NMS_TOPK if train
                          else self.cfg.pre_nms_topk),
            post_nms_topk=self.cfg.post_nms_topk, nms_thresh=0.7,
            topk_impl="exact" if train else self.cfg.rpn_topk,
            return_index=return_index)

    def num_anchors(self) -> int:
        return sum(a.shape[0] for a in self.anchors())

    def losses(self, images, gt_boxes, gt_classes, gt_valid,
               draws: Optional[Dict[str, torch.Tensor]] = None,
               choices: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Training losses, the mean over the batch, and the step's
        discrete choices. gt_boxes [B, G, 4], gt_classes [B, G], gt_valid
        [B, G]; `draws` as `loss_draws` makes them. Returns ({'rpn_obj',
        'rpn_box', 'roi_cls', 'roi_box', 'total'}, {CHOICES: [B, ...]}).

        `choices` given replays a step's choices (the anchors behind the
        proposals and their validity, the anchor labels, matches and
        sampled set, the sampled proposals with their weights, labels and
        matches) in place of making them; `draws` is then unused."""
        pyramid = self.features(images)
        logits, deltas = self.rpn(pyramid)
        anchors = torch.cat(self.anchors(), 0)
        all_logits = torch.cat(logits, 1)
        all_deltas = torch.cat(deltas, 1)
        d = draws or {}
        rpn_l, rc = rpn_loss(
            all_logits, all_deltas, anchors, gt_boxes, gt_valid,
            d.get("rpn_pos"), d.get("rpn_neg"), choices=None
            if choices is None else _strip(choices, "rpn_", RPN_CHOICES))
        if choices is None:
            # the anchors behind the proposals: a choice without a
            # gradient; their boxes below carry it to the RPN's deltas
            _, _, pvalid, pidx = self._generate(
                [x.detach() for x in logits], [x.detach() for x in deltas],
                train=True, return_index=True)
        else:
            pidx, pvalid = choices["proposal_index"], choices["proposal_valid"]
        props = proposals_at(all_deltas, anchors, pidx, self.cfg.image_size)
        if choices is None:
            sc = sample_proposals(props.detach(), pvalid, gt_boxes,
                                  gt_classes, gt_valid, d["roi_pos"],
                                  d["roi_neg"], d["roi_tie"],
                                  self.num_classes)
        else:
            sc = _strip(choices, "roi_", ROI_CHOICES)
        sel = gather_rows(props, sc["idx"])             # [B, S, 4]
        # each image's sampled ROIs through the gather form
        pooled = torch.stack([
            multilevel_roi_align([f[i] for f in pyramid[:4]], sel[i],
                                 FPN_SCALES, out_size=self.cfg.roi_pool_size)
            for i in range(sel.shape[0])])
        _, cls_scores, box_deltas = self.box_head.head(pooled)
        roi_l = roi_loss(cls_scores, box_deltas, sel, sc["cls"],
                         sc["matched"], sc["weight"], gt_boxes,
                         self.num_classes)
        out = {k: v.mean() for k, v in {**rpn_l, **roi_l}.items()}
        out["total"] = (out["rpn_obj"] + out["rpn_box"] + out["roi_cls"]
                        + out["roi_box"])
        made = {**{"rpn_" + k: v for k, v in rc.items()},
                "proposal_index": pidx, "proposal_valid": pvalid,
                **{"roi_" + k: v for k, v in sc.items()}}
        return out, made

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
