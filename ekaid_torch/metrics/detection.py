"""Detection AP evaluation at IoU 0.5 (counterpart of
`ekaid_tpu/metrics/detection.py`, host-side numpy).

Parity target: the reference's `VinbigdataEvaluator` hacks COCOeval's
iouThrs to a single 0.5 threshold (evaluator.py:40-41,129-130) and
reports AP/AP50/AR. This is a clean-room COCO-style 101-point
interpolated AP at one threshold: per class, detections are matched
greedily by score order to the best unmatched GT with IoU >= thresh;
AP = mean of interpolated precision over recall grid; mAP = mean over
classes with GT. Host-side numpy (not perf-critical, SURVEY.md §2.3).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    ix = np.maximum(0.0, np.minimum(a[:, None, 2], b[None, :, 2])
                    - np.maximum(a[:, None, 0], b[None, :, 0]))
    iy = np.maximum(0.0, np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 1], b[None, :, 1]))
    inter = ix * iy
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def average_precision(scores: Sequence[float], matched: Sequence[bool],
                      num_gt: int) -> float:
    """101-point interpolated AP from score-sorted match flags."""
    if num_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores), kind="stable")
    m = np.asarray(matched, bool)[order]
    tp = np.cumsum(m)
    fp = np.cumsum(~m)
    recall = tp / num_gt
    precision = tp / np.maximum(tp + fp, 1)
    # precision envelope
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    grid = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, grid, side="left")
    p = np.where(idx < len(precision), precision[np.minimum(
        idx, len(precision) - 1)], 0.0)
    return float(np.mean(p))


class DetectionEvaluator:
    """Accumulates (predictions, ground truth) per image; computes
    AP50 / per-class AP / AR@100 (VinbigdataEvaluator surface)."""

    def __init__(self, num_classes: int, iou_thresh: float = 0.5):
        self.k = num_classes
        self.thresh = iou_thresh
        self.dets: List[Dict] = []

    def add_image(self, pred_boxes, pred_classes, pred_scores, pred_valid,
                  gt_boxes, gt_classes, gt_valid):
        self.dets.append(dict(
            pb=np.asarray(pred_boxes), pc=np.asarray(pred_classes),
            ps=np.asarray(pred_scores), pv=np.asarray(pred_valid, bool),
            gb=np.asarray(gt_boxes), gc=np.asarray(gt_classes),
            gv=np.asarray(gt_valid, bool)))

    def summarize(self) -> Dict[str, float]:
        per_class_ap = {}
        recalls = []
        for c in range(self.k):
            scores, matched = [], []
            num_gt = 0
            for d in self.dets:
                gt = d["gb"][d["gv"] & (d["gc"] == c)]
                num_gt += len(gt)
                sel = d["pv"] & (d["pc"] == c)
                boxes = d["pb"][sel]
                scs = d["ps"][sel]
                order = np.argsort(-scs, kind="stable")
                boxes, scs = boxes[order], scs[order]
                iou = _iou_matrix(boxes, gt)
                taken = np.zeros(len(gt), bool)
                for i in range(len(boxes)):
                    # best unmatched gt above threshold
                    ok = False
                    if len(gt):
                        cand = np.where(~taken, iou[i], -1.0)
                        j = int(np.argmax(cand))
                        ok = cand[j] >= self.thresh
                        if ok:
                            taken[j] = True
                    scores.append(scs[i])
                    matched.append(bool(ok))
                if len(gt):
                    recalls.append(taken.mean())
            ap = average_precision(scores, matched, num_gt)
            if not np.isnan(ap):
                per_class_ap[c] = ap
        ap50 = (float(np.mean(list(per_class_ap.values())))
                if per_class_ap else 0.0)
        return {"AP50": ap50,
                "AR": float(np.mean(recalls)) if recalls else 0.0,
                **{f"AP50-c{c}": v for c, v in per_class_ap.items()}}


def proposal_recall(proposals, scores, valid, gt_boxes, gt_valid,
                    limits: Sequence[int] = (100, 1000),
                    iou_lo: float = 0.5, iou_hi: float = 0.95,
                    iou_step: float = 0.05) -> Dict[str, float]:
    """Class-agnostic proposal AR (the reference's inherited
    COCOEvaluator box-proposal mode, evaluator.py:462
    `_evaluate_box_proposals` semantics: objectness-sorted top-`limit`
    proposals matched greedily to GT at each IoU in 0.5:0.05:0.95;
    AR@limit = mean recall over the threshold grid).

    Batched arrays: proposals [N, R, 4], scores [N, R], valid [N, R],
    gt_boxes [N, G, 4], gt_valid [N, G].
    """
    thresholds = np.arange(iou_lo, iou_hi + 1e-9, iou_step)
    out = {}
    n = len(proposals)
    for limit in limits:
        recalls_per_t = []
        gt_overlaps: List[np.ndarray] = []
        for i in range(n):
            gt = np.asarray(gt_boxes[i])[np.asarray(gt_valid[i], bool)]
            if len(gt) == 0:
                continue
            sel = np.asarray(valid[i], bool)
            props = np.asarray(proposals[i])[sel]
            scs = np.asarray(scores[i])[sel]
            order = np.argsort(-scs, kind="stable")[:limit]
            props = props[order]
            iou = _iou_matrix(props, gt)            # [P, G]
            # greedy: repeatedly take the global best pair (the COCO
            # proposal evaluator's argmax-and-remove loop)
            overlaps = np.zeros(len(gt))
            iou_w = iou.copy()
            for _ in range(min(len(props), len(gt))):
                j = int(np.argmax(iou_w.max(axis=0)))
                p = int(np.argmax(iou_w[:, j]))
                if iou_w[p, j] <= 0:
                    break
                overlaps[j] = iou_w[p, j]
                iou_w[p, :] = -1
                iou_w[:, j] = -1
            gt_overlaps.append(overlaps)
        if not gt_overlaps:
            out[f"AR@{limit}"] = 0.0
            continue
        allo = np.concatenate(gt_overlaps)
        recalls_per_t = [(allo >= t).mean() for t in thresholds]
        out[f"AR@{limit}"] = float(np.mean(recalls_per_t))
    return out
