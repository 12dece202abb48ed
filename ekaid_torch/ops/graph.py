"""Difference-graph construction: device ops in torch, host ops in numpy.

Counterpart of `ekaid_tpu/ops/graph.py`.

* Device side (torch): the adjacency one-hot broadcast, the
  geometric position features the GAT encoders consume, and the
  expert-knowledge semantic adjacency of a batch of class ids.
* Host side (numpy): the spatial relation typing the synthetic data
  uses. Twelve labels: 0 disconnected, 1 i contains j, 2 i inside j,
  3 IoU >= 0.5, 4..11 the 45-degree sector from center(i) to center(j);
  priority contains > inside > iou > disconnected > angle. The lower
  triangle takes the reversal table of the mirrored upper entry.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# label reversal: 0->0, 1<->2, 3->3, sectors 4..11 rotate by 180 degrees
_REVERSE_TABLE = (0, 2, 1, 3, 8, 9, 10, 11, 4, 5, 6, 7)


# ----------------------------------------------------------- host (numpy) --

def _split_boxes(boxes):
    return boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]


def pairwise_iou(boxes_a, boxes_b):
    """All-pairs IoU with the +1 pixel convention.
    boxes_a [..., N, 4], boxes_b [..., M, 4] -> [..., N, M]."""
    ax1, ay1, ax2, ay2 = _split_boxes(boxes_a[..., :, None, :])
    bx1, by1, bx2, by2 = _split_boxes(boxes_b[..., None, :, :])
    iw = np.maximum(np.minimum(ax2, bx2) - np.maximum(ax1, bx1) + 1.0, 0.0)
    ih = np.maximum(np.minimum(ay2, by2) - np.maximum(ay1, by1) + 1.0, 0.0)
    inter = iw * ih
    area_a = (ax2 - ax1 + 1.0) * (ay2 - ay1 + 1.0)
    area_b = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
    return inter / (area_a + area_b - inter)


def _centers(boxes):
    x1, y1, x2, y2 = _split_boxes(boxes)
    return (x1 + x2) * 0.5, (y1 + y2) * 0.5


def pairwise_center_distance(boxes):
    cx, cy = _centers(boxes)
    dx = cx[..., :, None] - cx[..., None, :]
    dy = cy[..., :, None] - cy[..., None, :]
    return np.sqrt(dx * dx + dy * dy)


def pairwise_angle(boxes):
    """Angle in degrees [0, 360) from center(i) to center(j)."""
    cx, cy = _centers(boxes)
    dx = cx[..., None, :] - cx[..., :, None]
    dy = cy[..., None, :] - cy[..., :, None]
    ang = np.arctan2(dy, dx) / math.pi * 180.0
    return np.where(ang < 0, ang + 360.0, ang)


def bbox_relation_types(boxes, img_w: float = 1024.0,
                        img_h: float = 1024.0):
    """[..., N, 4] -> [..., N, N] int32: the label of box j relative to
    box i, for all ordered pairs."""
    boxes = boxes.astype(np.float32)
    x1, y1, x2, y2 = _split_boxes(boxes)

    def pair(u):
        return u[..., :, None], u[..., None, :]

    ix1, jx1 = pair(x1)
    iy1, jy1 = pair(y1)
    ix2, jx2 = pair(x2)
    iy2, jy2 = pair(y2)
    contains = (ix1 < jx1) & (iy1 < jy1) & (ix2 > jx2) & (iy2 > jy2)
    inside = (ix1 > jx1) & (iy1 > jy1) & (ix2 < jx2) & (iy2 < jy2)
    overlap = pairwise_iou(boxes, boxes) >= 0.5
    far = pairwise_center_distance(boxes) >= (img_w + img_h) / 3.0
    sector = np.ceil(pairwise_angle(boxes) / 45.0).astype(np.int32) + 3
    out = np.clip(sector, 4, 11)
    out = np.where(far, 0, out)
    out = np.where(overlap, 3, out)
    out = np.where(inside, 2, out)
    out = np.where(contains, 1, out)
    return out.astype(np.int32)


def reverse_relation_type(labels):
    return np.asarray(_REVERSE_TABLE, dtype=np.int32)[labels]


def spatial_adjacency(boxes, pad_to: int | None = None,
                      img_w: float = 1024.0, img_h: float = 1024.0):
    """[..., N, 4] -> [..., P, P] int32 (P = pad_to or N): upper
    triangle (with the diagonal) from the relation types, lower triangle
    from the reversal of the mirrored entry."""
    n = boxes.shape[-2]
    types = bbox_relation_types(boxes, img_w=img_w, img_h=img_h)
    upper = np.triu(np.ones((n, n), dtype=bool))
    adj = np.where(upper, types,
                   reverse_relation_type(np.swapaxes(types, -1, -2)))
    if pad_to is not None and pad_to > n:
        pad = [(0, 0)] * (adj.ndim - 2) + [(0, pad_to - n), (0, pad_to - n)]
        adj = np.pad(adj, pad)
    return adj


# ---------------------------------------------------------- device (torch) --

def broadcast_adjacency(adj_labels: torch.Tensor, num_labels: int,
                        num_objects: int | None = None,
                        dtype=torch.float32) -> torch.Tensor:
    """One-hot label broadcast: labels 1..L map to channels 0..L-1, label
    0 (no edge) to the all-zero vector.
    [..., P, P] int -> [..., N, N, L] with N = num_objects or P."""
    if num_objects is not None:
        adj_labels = adj_labels[..., :num_objects, :num_objects]
    chans = torch.arange(1, num_labels + 1, device=adj_labels.device)
    return (adj_labels.long()[..., None] == chans).to(dtype)


def semantic_adjacency(class_ids: torch.Tensor, organ_table: torch.Tensor,
                       cooccur_table: torch.Tensor, is_disease: torch.Tensor,
                       pad_to: int | None = None) -> torch.Tensor:
    """Expert-knowledge semantic adjacency of the combined class ids
    [..., N] (anatomy classes, then disease classes; `num_classes` is
    the missing-node sentinel) -> [..., P, P] int32, P = pad_to or N.
    Label 1 joins an anatomy and a disease node of one organ, label 2
    is the co-occurrence table's (2 above its threshold, else 0), and 2
    wins where both hold. organ_table [C+1] maps the sentinel to organ
    -1, which takes no edges; is_disease [C+1] is bool."""
    ids = class_ids.long()
    organs = organ_table.to(ids.device)[ids]
    disease = is_disease.to(ids.device)[ids]
    valid = organs >= 0
    same_organ = organs[..., :, None] == organs[..., None, :]
    cross = disease[..., :, None] ^ disease[..., None, :]
    both = valid[..., :, None] & valid[..., None, :]
    organ_edge = (same_organ & cross & both).int()
    co = cooccur_table.to(ids.device)[ids[..., :, None], ids[..., None, :]]
    adj = torch.maximum(organ_edge,
                        torch.where(both, co.int(), 0)).to(torch.int32)
    n = adj.shape[-1]
    if pad_to is not None and pad_to > n:
        adj = torch.nn.functional.pad(adj, (0, pad_to - n, 0, pad_to - n))
    return adj


def position_matrix(boxes: torch.Tensor, nongt_dim: int = 52,
                    eps: float = 1e-3) -> torch.Tensor:
    """Pairwise log-geometry: [..., N, 4] -> [..., N, min(N, nongt), 4]
    f32 with channels (log|dx/w|, log|dy/h|, log(w_i/w_j), log(h_i/h_j))."""
    x1, y1, x2, y2 = _split_boxes(boxes.float())
    w = x2 - x1 + 1.0
    h = y2 - y1 + 1.0
    cx = 0.5 * (x1 + x2)
    cy = 0.5 * (y1 + y2)
    dx = (cx[..., :, None] - cx[..., None, :]) / w[..., :, None]
    dx = torch.log(torch.clamp(dx.abs(), min=eps))
    dy = (cy[..., :, None] - cy[..., None, :]) / h[..., :, None]
    dy = torch.log(torch.clamp(dy.abs(), min=eps))
    dw = torch.log(w[..., :, None] / w[..., None, :])
    dh = torch.log(h[..., :, None] / h[..., None, :])
    pos = torch.stack([dx, dy, dw, dh], dim=-1)
    return pos[..., :nongt_dim, :]


def position_embedding(pos_mat: torch.Tensor, feat_dim: int = 64,
                       wave_length: float = 1000.0) -> torch.Tensor:
    """Sinusoidal embedding: [..., N, M, 4] -> [..., N, M, feat_dim]."""
    if feat_dim % 8:
        raise ValueError("feat_dim must be divisible by 8")
    n_freq = feat_dim // 8
    feat_range = torch.arange(n_freq, dtype=torch.float32,
                              device=pos_mat.device)
    dim_mat = torch.pow(torch.tensor(wave_length, dtype=torch.float32),
                        (8.0 / feat_dim) * feat_range)
    div = (100.0 * pos_mat[..., None]) / dim_mat      # [..., N, M, 4, F]
    emb = torch.cat([torch.sin(div), torch.cos(div)], dim=-1)
    return emb.reshape(*emb.shape[:-2], feat_dim)
