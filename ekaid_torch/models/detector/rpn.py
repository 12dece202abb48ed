"""Region Proposal Network: head and proposal generation (inference).

Counterpart of `ekaid_tpu/models/detector/rpn.py`: a shared 3x3 conv
head with a per-anchor objectness logit and 4 deltas; at inference,
per-level top-k by objectness, decode + clip, and level-aware NMS at
0.7 (proposals of different pyramid levels never suppress each other)
down to `post_nms_topk` proposals, with static shapes and a validity
mask. The training targets and losses come with the training slice.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ekaid_torch.models.detector.anchors import clip_boxes, decode_boxes
from ekaid_torch.models.detector.backbone import Conv, nchw, nhwc
from ekaid_torch.ops.nms import batched_nms, top_k
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
                       topk_impl: str = "exact"
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched proposal generation. logits[l] [B, N_l], deltas[l]
    [B, N_l, 4], anchors[l] [N_l, 4] -> (boxes [B, post, 4], scores
    [B, post], valid [B, post]). `topk_impl='approx'` is the TPU's
    partial reduction; like the reference on any other backend, the
    port sorts exactly for both values."""
    if topk_impl not in ("exact", "approx"):
        raise ValueError(f"unknown topk_impl {topk_impl!r}")
    lvl_boxes, lvl_scores, lvl_ids = [], [], []
    for li, (lg, dl, an) in enumerate(zip(logits, deltas, anchors)):
        k = min(pre_nms_topk, lg.shape[1])
        sc, idx = top_k(lg, k)                           # [B, k]
        d = torch.gather(dl, 1, idx[..., None].expand(-1, -1, 4))
        box = clip_boxes(decode_boxes(d, an[idx]), image_size)
        lvl_boxes.append(box)
        lvl_scores.append(sc)
        lvl_ids.append(torch.full(idx.shape, li, dtype=torch.int32,
                                  device=idx.device))
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
    return (torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4)),
            torch.gather(scores, 1, keep), valid)
