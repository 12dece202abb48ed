"""Region Proposal Network: head, proposal generation, training targets
and loss.

Counterpart of `ekaid_tpu/models/detector/rpn.py`: a shared 3x3 conv
head with a per-anchor objectness logit and 4 deltas; per-level top-k
by objectness, decode + clip, and level-aware NMS at 0.7 (proposals of
different pyramid levels never suppress each other) down to
`post_nms_topk` proposals, with static shapes and a validity mask; the
anchor labels (Detectron2's matcher), their sampling and the loss.

The reference draws its sampling priorities with `jax.random` inside
`sample_targets`; here the uniforms are arguments, so a caller (or a
test, with the reference's own draws) decides where they come from.
Functions over images take any leading batch dimensions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ekaid_torch.models.detector.anchors import (clip_boxes, decode_boxes,
                                                 encode_boxes)
from ekaid_torch.models.detector.backbone import Conv, nchw, nhwc
from ekaid_torch.ops.nms import batched_nms, box_iou, top_k
from ekaid_torch.utils.dtypes import F32, Policy


class RPNHead(nn.Module):
    """NHWC levels -> (logits [B, H*W*A] per level, deltas
    [B, H*W*A, 4] per level). The reference's `fused_preds` runs the two
    1x1 convs as one with bit-identical outputs, so the port has no such
    switch."""

    def __init__(self, in_channels: int, channels: int = 256,
                 num_anchors: int = 3, policy: Policy = F32):
        super().__init__()
        self.conv = Conv(in_channels, channels, 3, policy=policy)
        self.objectness = Conv(channels, num_anchors, 1, policy=policy)
        self.deltas = Conv(channels, num_anchors * 4, 1, policy=policy)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        logits, boxes = [], []
        for f in feats:
            h = torch.relu(self.conv(nchw(f)))
            b = f.shape[0]
            logits.append(nhwc(self.objectness(h)).reshape(b, -1))
            boxes.append(nhwc(self.deltas(h)).reshape(b, -1, 4))
        return logits, boxes


def generate_proposals(logits: Sequence[torch.Tensor],
                       deltas: Sequence[torch.Tensor],
                       anchors: Sequence[torch.Tensor],
                       image_size: int,
                       pre_nms_topk: int = 1000,
                       post_nms_topk: int = 1000,
                       nms_thresh: float = 0.7,
                       min_size: float = 0.0,
                       topk_impl: str = "exact",
                       return_index: bool = False):
    """Batched proposal generation. logits[l] [B, N_l], deltas[l]
    [B, N_l, 4], anchors[l] [N_l, 4] -> (boxes [B, post, 4], scores
    [B, post], valid [B, post]), and with `return_index` the flat index
    [B, post] of each slot's anchor in the levels' concatenation (the
    discrete choice; `proposals_at` recomputes the boxes from it).
    `topk_impl='approx'` is the TPU's partial reduction; like the
    reference on any other backend, the port sorts exactly for both
    values."""
    if topk_impl not in ("exact", "approx"):
        raise ValueError(f"unknown topk_impl {topk_impl!r}")
    lvl_boxes, lvl_scores, lvl_ids, lvl_flat = [], [], [], []
    base = 0
    for li, (lg, dl, an) in enumerate(zip(logits, deltas, anchors)):
        k = min(pre_nms_topk, lg.shape[1])
        sc, idx = top_k(lg, k)                           # [B, k]
        d = torch.gather(dl, 1, idx[..., None].expand(-1, -1, 4))
        box = clip_boxes(decode_boxes(d, an[idx]), image_size)
        lvl_boxes.append(box)
        lvl_scores.append(sc)
        lvl_ids.append(torch.full(idx.shape, li, dtype=torch.int32,
                                  device=idx.device))
        lvl_flat.append(idx + base)
        base += lg.shape[1]
    boxes = torch.cat(lvl_boxes, 1)
    scores = torch.cat(lvl_scores, 1)
    ids = torch.cat(lvl_ids, 1)
    if min_size > 0:
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        scores = torch.where((w >= min_size) & (h >= min_size), scores,
                             torch.full_like(scores, -1e9))
    keep, valid = batched_nms(boxes, scores, ids, nms_thresh, post_nms_topk)
    keep = keep.long()
    out = (torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4)),
           torch.gather(scores, 1, keep), valid)
    if return_index:
        out += (torch.gather(torch.cat(lvl_flat, 1), 1, keep),)
    return out


def proposals_at(deltas: torch.Tensor, anchors: torch.Tensor,
                 index: torch.Tensor, image_size: int) -> torch.Tensor:
    """The proposal boxes of chosen anchors: deltas [B, N, 4] and
    anchors [N, 4] of all levels, index [B, P] flat (as
    `generate_proposals(return_index=True)` gives it) -> clipped boxes
    [B, P, 4], bit-equal to `generate_proposals`' (decode and clip act
    on each box alone) and differentiable with respect to the deltas."""
    d = torch.gather(deltas, 1, index[..., None].expand(-1, -1, 4))
    return clip_boxes(decode_boxes(d, anchors[index]), image_size)


def rpn_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                gt_valid: torch.Tensor, pos_thresh: float = 0.7,
                neg_thresh: float = 0.3
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor labels (1 positive, 0 negative, -1 ignored) and the
    matched gt index, Detectron2's matcher: IoU >= pos_thresh positive,
    < neg_thresh negative, in between ignored, and every valid gt's
    best anchor positive (allow_low_quality_matches). anchors [N, 4],
    gt_boxes [..., G, 4] padded, gt_valid [..., G] -> int32 [..., N],
    int64 [..., N].

    The reference forces the positives with a scatter whose indices
    repeat (`zeros(N).at[per_gt_best].set(gt_valid)`), and XLA keeps the
    last write: a padded gt has every IoU at -1, so its best anchor is
    anchor 0, and a valid gt whose best anchor is anchor 0 loses its
    forced positive to a later padded gt. Here each anchor takes the
    value of the last gt that names it, on every device."""
    iou = box_iou(anchors, gt_boxes)                     # [..., N, G]
    iou = torch.where(gt_valid[..., None, :], iou,
                      torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=-1)
    best_gt = torch.argmax(iou, dim=-1)                  # the first maximum
    labels = torch.full(best_iou.shape, -1, dtype=torch.int32,
                        device=iou.device)
    labels = torch.where(best_iou < neg_thresh, torch.zeros_like(labels),
                         labels)
    labels = torch.where(best_iou >= pos_thresh, torch.ones_like(labels),
                         labels)
    per_gt_best = torch.argmax(iou, dim=-2)              # [..., G]
    g = per_gt_best.shape[-1]
    later = torch.triu(torch.ones(g, g, dtype=torch.bool,
                                  device=iou.device), diagonal=1)
    shadowed = ((per_gt_best[..., :, None] == per_gt_best[..., None, :])
                & later).any(-1)                         # a later gt writes
    write = (gt_valid & ~shadowed).to(torch.int32)
    force = torch.zeros(labels.shape, dtype=torch.int32, device=iou.device)
    force = force.scatter_reduce(-1, per_gt_best, write, "amax")
    labels = torch.where(force > 0, torch.ones_like(labels), labels)
    return labels, best_gt


def sample_targets(labels: torch.Tensor, u_pos: torch.Tensor,
                   u_neg: torch.Tensor, batch_size: int = 256,
                   positive_fraction: float = 0.5) -> torch.Tensor:
    """Subsample labels to `batch_size` with the given positive fraction
    (Detectron2 subsample_labels): an f32 weight mask [..., N] in {0, 1}.
    u_pos, u_neg [..., N]: uniform priorities in [0, 1) (the reference's
    `jax.random.uniform` of its two split keys); the positives and the
    negatives of highest priority are kept, by threshold at the
    count-th largest."""
    n = labels.shape[-1]
    num_pos_target = int(batch_size * positive_fraction)
    pos = labels == 1
    neg = labels == 0
    minus = torch.full_like(u_pos, -1.0)
    pri_pos = torch.where(pos, u_pos, minus)
    pri_neg = torch.where(neg, u_neg, minus)
    num_pos = torch.clamp(pos.sum(-1), max=num_pos_target)
    num_neg = torch.minimum(neg.sum(-1), batch_size - num_pos)
    k = min(batch_size, n)

    def topk_mask(pri, count):
        vals, _ = top_k(pri, k)
        at = torch.clamp(count - 1, 0, k - 1)[..., None]
        kth = torch.gather(vals, -1, at)
        return (pri >= kth) & (pri > 0) & (count > 0)[..., None]

    return (topk_mask(pri_pos, num_pos)
            | topk_mask(pri_neg, num_neg)).to(torch.float32)


def optax_sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor
                      ) -> torch.Tensor:
    """Sigmoid cross-entropy in the reference's form."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def rpn_loss(logits: torch.Tensor, deltas: torch.Tensor,
             anchors: torch.Tensor, gt_boxes: torch.Tensor,
             gt_valid: torch.Tensor, u_pos: Optional[torch.Tensor] = None,
             u_neg: Optional[torch.Tensor] = None, batch_size: int = 256,
             choices: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Per-image RPN loss (objectness BCE on the sampled anchors, L1 of
    the deltas on the sampled positives), normalised by the sampling
    batch size (Detectron2's convention). logits [..., N], deltas
    [..., N, 4], anchors [N, 4], gt [..., G, 4], gt_valid [..., G].

    Returns (losses {'rpn_obj', 'rpn_box'} [...], choices {'labels',
    'matched', 'weight'} [..., N]). `choices` given replays them in
    place of the targets and the sampling (the uniforms are then
    unused)."""
    if choices is None:
        labels, matched = rpn_targets(anchors, gt_boxes, gt_valid)
        w = sample_targets(labels, u_pos, u_neg, batch_size=batch_size)
        choices = {"labels": labels, "matched": matched, "weight": w}
    labels, matched, w = (choices["labels"], choices["matched"],
                          choices["weight"])
    obj_t = (labels == 1).to(logits.dtype)
    bce = optax_sigmoid_bce(logits, obj_t)
    obj_loss = (bce * w).sum(-1) / batch_size
    gt = torch.gather(gt_boxes, -2, matched.long()[..., None].expand(
        *matched.shape, 4))
    target = encode_boxes(anchors, gt)
    l1 = (deltas - target).abs().sum(-1)
    box_loss = (l1 * (w * obj_t)).sum(-1) / batch_size
    return {"rpn_obj": obj_loss, "rpn_box": box_loss}, choices
