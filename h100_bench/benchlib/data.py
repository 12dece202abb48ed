"""Seeded corpora: study pairs, their image records and their QA rows.

A copy of the program's synthetic generators (`learnable_dataset` of
`ekaid_torch/data/pipeline.py`, the spatial relation typing of
`ekaid_torch/ops/graph.py`, the [0, 1) grayscale pool of the mode0
rehearsal), made from the run's seed, with the bulk drawn on the device
in a few calls and brought to the host once.

Every image has one 'hot' node h = index % nodes, shifted by a
class-coded pattern, so the answers (functions of the two hot nodes)
are learnable. A traffic file's `corpus` sets the sizes:

  qa_rows             QA rows in all
  images              images in the pool
  pairing             'disjoint': study pair p is images (2p, 2p + 1),
                      asked questions_per_pair rows, pair-major
  questions_per_pair  rows per study pair
  question_types      token rows of the question types; even types are
                      open (answer: <start>, 10 + h_bef, 80 + h_aft % 26),
                      odd ones closed (<start>, 3 if the hot nodes
                      coincide else 4)
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

_REVERSE_TABLE = (0, 2, 1, 3, 8, 9, 10, 11, 4, 5, 6, 7)


# ---- spatial relation typing (copied, numpy) ---------------------------------

def _split(b):
    return b[..., 0], b[..., 1], b[..., 2], b[..., 3]


def _pairwise_iou(a, b):
    ax1, ay1, ax2, ay2 = _split(a[..., :, None, :])
    bx1, by1, bx2, by2 = _split(b[..., None, :, :])
    iw = np.maximum(np.minimum(ax2, bx2) - np.maximum(ax1, bx1) + 1.0, 0.0)
    ih = np.maximum(np.minimum(ay2, by2) - np.maximum(ay1, by1) + 1.0, 0.0)
    inter = iw * ih
    area_a = (ax2 - ax1 + 1.0) * (ay2 - ay1 + 1.0)
    area_b = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
    return inter / (area_a + area_b - inter)


def _relation_types(boxes, img_w: float = 1024.0, img_h: float = 1024.0):
    boxes = boxes.astype(np.float32)
    x1, y1, x2, y2 = _split(boxes)

    def pair(u):
        return u[..., :, None], u[..., None, :]

    ix1, jx1 = pair(x1)
    iy1, jy1 = pair(y1)
    ix2, jx2 = pair(x2)
    iy2, jy2 = pair(y2)
    contains = (ix1 < jx1) & (iy1 < jy1) & (ix2 > jx2) & (iy2 > jy2)
    inside = (ix1 > jx1) & (iy1 > jy1) & (ix2 < jx2) & (iy2 < jy2)
    overlap = _pairwise_iou(boxes, boxes) >= 0.5
    cx, cy = (x1 + x2) * 0.5, (y1 + y2) * 0.5
    dx = cx[..., None, :] - cx[..., :, None]
    dy = cy[..., None, :] - cy[..., :, None]
    far = np.sqrt(dx * dx + dy * dy) >= (img_w + img_h) / 3.0
    ang = np.arctan2(dy, dx) / math.pi * 180.0
    ang = np.where(ang < 0, ang + 360.0, ang)
    out = np.clip(np.ceil(ang / 45.0).astype(np.int32) + 3, 4, 11)
    out = np.where(far, 0, out)
    out = np.where(overlap, 3, out)
    out = np.where(inside, 2, out)
    out = np.where(contains, 1, out)
    return out.astype(np.int32)


def spatial_adjacency(boxes):
    """[..., N, 4] -> [..., N, N] int32 relation labels 0..11: the upper
    triangle from the types, the lower from the mirrored reversal."""
    n = boxes.shape[-2]
    types = _relation_types(boxes)
    upper = np.triu(np.ones((n, n), dtype=bool))
    rev = np.asarray(_REVERSE_TABLE, np.int32)[np.swapaxes(types, -1, -2)]
    return np.where(upper, types, rev)


# ---- the corpus ----------------------------------------------------------------

def make_corpus(corpus: dict, model: dict, seed: int,
                device) -> Dict[str, np.ndarray]:
    """The arrays of a corpus (host numpy): questions [R, Lq], answers
    [R, T], pos [R, T], feature_idx [R, 2], and per image either feats
    [I, N, F], bb [I, N, 4], adj / sem_adj [I, P, P] (mode2) or images
    [I, S, S] (mode0)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 16])
    n_img = int(corpus["images"])
    rows = int(corpus["qa_rows"])
    N, F, P = model["num_nodes"], model["feature_dim"], model["adj_pad"]
    T, Lq = model["seq_length"], model["question_len"]
    hot = np.arange(n_img) % N
    out: Dict[str, np.ndarray] = {}
    if model["setting"] == "mode0":
        S = model["image_size"]
        out["images"] = torch.rand(n_img, S, S, generator=gen,
                                   device=device).cpu().numpy()
    else:
        feats = torch.randn(n_img, N, F, generator=gen, device=device)
        patterns = torch.randn(N, F, generator=gen, device=device)
        idx = torch.arange(n_img, device=device)
        hot_t = torch.as_tensor(hot, device=device)
        feats[idx, hot_t] += 4.0 * patterns[hot_t]
        geo = torch.rand(4, n_img, N, generator=gen, device=device,
                         dtype=torch.float64).cpu().numpy()
        x1, y1 = geo[0] * 800, geo[1] * 800
        w, h = 10 + geo[2] * 490, 10 + geo[3] * 490
        bb = np.stack([x1, y1, np.minimum(x1 + w, 1024.0),
                       np.minimum(y1 + h, 1024.0)], -1).astype(np.float32)
        adj = np.zeros((n_img, P, P), np.int32)
        adj[:, :N, :N] = spatial_adjacency(bb)
        sem = np.zeros((n_img, P, P), np.int32)
        sem[:, :N, :N] = torch.randint(0, 3, (n_img, N, N), generator=gen,
                                       device=device).cpu().numpy()
        out.update(feats=feats.cpu().numpy(), bb=bb, adj=adj, sem_adj=sem)

    types = [np.asarray(t, np.int32) for t in corpus["question_types"]]
    if corpus["pairing"] == "disjoint":
        q = int(corpus["questions_per_pair"])
        pairs = rows // q
        if pairs * 2 > n_img or pairs * q != rows:
            raise ValueError("disjoint corpus: qa_rows must be "
                             "questions_per_pair x pairs, 2 x pairs <= images")
        bef = np.repeat(2 * np.arange(pairs), q)
        aft = bef + 1
        qtype = np.concatenate([rng.permutation(len(types))[:q]
                                for _ in range(pairs)])
    else:
        raise ValueError(f"unknown pairing {corpus['pairing']!r}")
    questions = np.zeros((rows, Lq), np.int32)
    for k, t in enumerate(types):
        sel = qtype == k
        questions[sel, :len(t)] = t[:Lq]
    answers = np.zeros((rows, T), np.int32)
    pos = np.zeros((rows, T), np.int32)
    hb, ha = hot[bef], hot[aft]
    is_open = qtype % 2 == 0
    answers[:, 0] = 1
    answers[is_open, 1] = 10 + hb[is_open]
    answers[is_open, 2] = 80 + ha[is_open] % 26
    answers[~is_open, 1] = np.where(hb[~is_open] == ha[~is_open], 3, 4)
    pos[:, :3] = 1
    if int(answers.max()) >= model["vocab_size"]:
        raise ValueError("answer token past the vocabulary")
    out.update(questions=questions, answers=answers, pos=pos,
               feature_idx=np.stack([bef, aft], -1).astype(np.int64),
               qtype=qtype.astype(np.int32))
    return out


def batch(corpus: Dict[str, np.ndarray], rows, model: dict,
          device) -> Dict[str, torch.Tensor]:
    """The f32 model inputs of QA rows `rows` (the reference's batch)."""
    rows = np.asarray(rows, np.int64)
    fi = corpus["feature_idx"][rows]
    out = {"question": corpus["questions"][rows]}
    if model["setting"] == "mode0":
        out["d_feats"] = corpus["images"][fi[:, 0]]
        out["q_feats"] = corpus["images"][fi[:, 1]]
    else:
        for key, leg in (("d", 0), ("q", 1)):
            out[f"{key}_feats"] = corpus["feats"][fi[:, leg]]
            out[f"{key}_bb"] = corpus["bb"][fi[:, leg]]
            out[f"{key}_adj"] = corpus["adj"][fi[:, leg]]
            out[f"{key}_sem_adj"] = corpus["sem_adj"][fi[:, leg]]
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in out.items()}
