"""Non-maximum suppression with static shapes that returns kept indices.

Counterpart of `ekaid_tpu/ops/nms.py` (XLA there, plain torch here).
Every NMS returns `(indices, valid)` of a fixed length, so callers gather
the kept proposals' features directly. The functions take any leading
batch dimensions (the reference `vmap`s over images and classes).

Tie order follows the reference: `jax.lax.top_k` and
`jnp.argsort(stable=True)` put the lower index first among equal values,
and `torch.topk` promises no order on CUDA, so every top-k here is a
stable descending sort, sliced. Padded rows all carry `NEG`, so ties
are certain.

IoU is the geometric convention (no +1) of detection NMS.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

NEG = -1e9


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest, lower index
    first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. a [..., N, 4], b [..., M, 4] -> [..., N, M]."""
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                     min=0.0)
    inter = iw * ih
    area_a = torch.clamp(ax2 - ax1, min=0.0) * torch.clamp(ay2 - ay1, min=0.0)
    area_b = torch.clamp(bx2 - bx1, min=0.0) * torch.clamp(by2 - by1, min=0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_argmax(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
               max_out: int, score_thresh: float = float("-inf")
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS by `max_out` sequential argmax steps, one image
    (boxes [R, 4], scores [R]). The tests' oracle."""
    r = boxes.shape[0]
    live = scores > score_thresh
    out_idx = torch.zeros(max_out, dtype=torch.int32, device=boxes.device)
    out_valid = torch.zeros(max_out, dtype=torch.bool, device=boxes.device)
    ar = torch.arange(r, device=boxes.device)
    for i in range(max_out):
        masked = torch.where(live, scores, torch.full_like(scores, NEG))
        best = int(torch.argmax(masked))
        ok = bool(masked[best] > NEG)
        ious = box_iou(boxes[best][None], boxes)[0]
        live = live & ~(ious > iou_thresh) & (ar != best)
        out_idx[i] = best if ok else 0
        out_valid[i] = ok
    return out_idx, out_valid


def _survivor_mask(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_thresh: float, block: int = 256) -> torch.Tensor:
    """Exact greedy-NMS survivor set by the reference's blocked
    algorithm. boxes [..., R, 4], scores [..., R] -> bool [..., R] over
    the original order.

    Boxes go in descending-score order in blocks of `block`. Within a
    block, "suppressed by a live predecessor" is iterated to its fixed
    point; the live members then suppress every later box at once. The
    fixed point runs for the whole batch until no member changes (one
    host sync per iteration): a member that has converged stays put, so
    the result equals a loop per member. Each host read is counted in
    `_survivor_mask.host_reads`."""
    lead, r = scores.shape[:-1], scores.shape[-1]
    boxes = boxes.reshape(-1, r, 4)
    scores = scores.reshape(-1, r)
    b = min(block, r)
    nblk = -(-r // b)
    pad = nblk * b - r

    order = torch.sort(-scores, dim=-1, stable=True).indices
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    sscores = torch.gather(scores, 1, order)
    if pad:
        sboxes = F.pad(sboxes, (0, 0, 0, pad))
        sscores = F.pad(sscores, (0, pad), value=NEG)
    live = sscores > NEG / 2             # padding + pre-masked rows dead

    ar = torch.arange(b, device=scores.device)
    upper = ar[:, None] < ar[None, :]
    pos = torch.arange(sboxes.shape[1], device=scores.device)
    for blk in range(nblk):
        start = blk * b
        blk_boxes = sboxes[:, start:start + b]
        blk_live = live[:, start:start + b]
        sup_map = upper & (box_iou(blk_boxes, blk_boxes) > iou_thresh)
        alive = blk_live
        while True:
            new = blk_live & ~(sup_map & alive[:, :, None]).any(dim=1)
            changed = bool((new != alive).any())
            _survivor_mask.host_reads += 1
            alive = new
            if not changed:
                break
        hit = ((box_iou(blk_boxes, sboxes) > iou_thresh)
               & alive[:, :, None]).any(dim=1)
        live = live & ~(hit & (pos >= start + b))
        live[:, start:start + b] = alive
    mask = torch.zeros_like(live[:, :r]).scatter_(1, order, live[:, :r])
    return mask.reshape(*lead, r)


_survivor_mask.host_reads = 0


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(x, (0, n)) if n else x


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
        max_out: int, score_thresh: float = float("-inf"),
        block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS. boxes [..., R, 4], scores [..., R] -> (indices
    [..., max_out] int32, valid [..., max_out] bool), in descending-score
    order; the same selections as `nms_argmax`."""
    neg = torch.full_like(scores, NEG)
    live = scores > score_thresh
    masked = torch.where(live, scores, neg)
    surv = _survivor_mask(boxes, masked, iou_thresh, block=block)
    sel = torch.where(surv & live, masked, neg)
    k = min(max_out, boxes.shape[-2])
    top, idx = top_k(sel, k)
    valid = top > NEG
    return (_pad_last(idx.to(torch.int32), max_out - k),
            _pad_last(valid, max_out - k))


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, iou_thresh: float, max_out: int,
                score_thresh: float = float("-inf")
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS by per-class coordinate offsets (torchvision
    batched_nms equivalence); the span is taken per batch member."""
    span = (boxes.amax(dim=(-2, -1)) - boxes.amin(dim=(-2, -1)) + 1.0)
    offset = classes.to(boxes.dtype)[..., None] * span[..., None, None]
    return nms(boxes + offset, scores, iou_thresh, max_out, score_thresh)


def _class_survivors(boxes, scores, iou_thresh, score_thresh):
    """Class-wise survivor scores: boxes [..., R, K, 4], scores
    [..., R, K+1] -> (class scores [..., R, K], surviving masked scores
    [..., R, K] with NEG elsewhere)."""
    k = scores.shape[-1] - 1
    cls_scores = scores[..., :k]
    neg = torch.full_like(cls_scores, NEG)
    masked = torch.where(cls_scores > score_thresh, cls_scores, neg)
    surv = _survivor_mask(boxes.transpose(-3, -2), masked.transpose(-2, -1),
                          iou_thresh)                      # [..., K, R]
    sel = torch.where(surv.transpose(-2, -1) & (masked > NEG / 2),
                      masked, neg)
    return cls_scores, sel


def fast_rcnn_nms(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_thresh: float = 0.5, score_thresh: float = 0.0,
                  max_out: int = 100) -> Dict[str, torch.Tensor]:
    """Class-wise inference NMS (fast_rcnn_inference_single_image
    parity) with static shapes.

    boxes [..., R, K, 4] decoded + clipped class boxes; scores
    [..., R, K+1] softmax probabilities (the background column, last,
    is dropped). Returns, per kept slot in score order: proposal_idx,
    class_idx, boxes, scores, valid, each [..., max_out(, 4)]."""
    r, k = scores.shape[-2], scores.shape[-1] - 1
    cls_scores, sel = _class_survivors(boxes, scores, iou_thresh,
                                       score_thresh)
    lead = sel.shape[:-2]
    flat_scores = cls_scores.reshape(*lead, r * k)   # row-major (prop, cls)
    flat_boxes = boxes.reshape(*lead, r * k, 4)
    m = min(max_out, r * k)
    top, idx = top_k(sel.reshape(*lead, r * k), m)
    valid = _pad_last(top > NEG, max_out - m)
    idx = _pad_last(idx, max_out - m)
    return {
        "proposal_idx": (idx // k).to(torch.int32),
        "class_idx": (idx % k).to(torch.int32),
        "boxes": torch.gather(flat_boxes, -2,
                              idx[..., None].expand(*idx.shape, 4)),
        "scores": torch.gather(flat_scores, -1, idx),
        "valid": valid,
    }


def select_top1_per_class(boxes: torch.Tensor, scores: torch.Tensor,
                          iou_thresh: float = 0.5, score_thresh: float = 0.0,
                          pre: int = 100
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Per-class best NMS survivor with the rank cap `pre`, without the
    top-`pre` list: exactly `fast_rcnn_nms` + `top1_per_class`, tie
    order included. Returns (rows [..., K] int32, found [..., K] bool,
    sel_scores [..., K])."""
    r, k = scores.shape[-2], scores.shape[-1] - 1
    _, sel = _class_survivors(boxes, scores, iou_thresh, score_thresh)
    best_val = sel.amax(dim=-2)
    best_row = torch.argmax(sel, dim=-2)             # first maximum
    found = best_val > NEG / 2
    lead = sel.shape[:-2]
    flat = sel.reshape(*lead, 1, r * k)
    flat_idx = torch.arange(r * k, device=sel.device)
    best_flat = best_row * k + torch.arange(k, device=sel.device)
    gt = flat > best_val[..., None]                  # [..., K, R*K]
    eq = (flat == best_val[..., None]) & (flat_idx < best_flat[..., None])
    rank = (gt | eq).sum(dim=-1)
    found = found & (rank < pre)
    return (best_row.to(torch.int32), found,
            torch.where(found, best_val, torch.zeros_like(best_val)))


def top1_per_class(class_idx: torch.Tensor, valid: torch.Tensor,
                   num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each class c, the first kept slot with that class, else
    invalid. class_idx/valid [..., M] -> (slot [..., C] int32, found
    [..., C] bool)."""
    classes = torch.arange(num_classes, device=class_idx.device)
    onehot = (class_idx[..., None, :] == classes[:, None]) & valid[..., None, :]
    slot = torch.argmax(onehot.to(torch.uint8), dim=-1).to(torch.int32)
    return slot, onehot.any(dim=-1)
