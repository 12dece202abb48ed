"""Synthetic MIMIC-Diff-VQA-shaped data, in numpy.

Counterpart of `ekaid_tpu/data/synthetic.py` (`synthetic_batch`) and of
the reference package's synthetic pair store (`synthetic_dataset` over
`SyntheticFeatureStore`, data/pipeline.py). From the same seed both give
the same arrays as the reference package: 52 nodes x 1024-d features,
100x100 stored adjacency labels, 20-token questions, 148-entry vocab.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ekaid_torch.ops.graph import spatial_adjacency


def _boxes(rng, shape):
    x1 = rng.uniform(0, 800, shape)
    y1 = rng.uniform(0, 800, shape)
    w = rng.uniform(10, 500, shape)
    h = rng.uniform(10, 500, shape)
    return np.stack([x1, y1, np.minimum(x1 + w, 1024.0),
                     np.minimum(y1 + h, 1024.0)], -1).astype(np.float32)


def synthetic_batch(cfg, batch_size: int, seed: int = 0,
                    with_labels: bool = True) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    n = cfg.data.num_nodes
    feat = cfg.data.feature_dim
    pad = cfg.data.adj_pad
    tq = cfg.question.max_len
    t = cfg.speaker.seq_length
    vocab = cfg.speaker.vocab_size

    d_bb = _boxes(rng, (batch_size, n))
    q_bb = _boxes(rng, (batch_size, n))
    d_adj = np.zeros((batch_size, pad, pad), np.int64)
    q_adj = np.zeros((batch_size, pad, pad), np.int64)
    d_adj[:, :n, :n] = spatial_adjacency(d_bb)
    q_adj[:, :n, :n] = spatial_adjacency(q_bb)
    d_sem = np.zeros((batch_size, pad, pad), np.int64)
    q_sem = np.zeros((batch_size, pad, pad), np.int64)
    d_sem[:, :n, :n] = rng.integers(0, 3, (batch_size, n, n))
    q_sem[:, :n, :n] = rng.integers(0, 3, (batch_size, n, n))

    batch = {
        "d_feats": rng.standard_normal(
            (batch_size, n, feat), dtype=np.float32),
        "q_feats": rng.standard_normal(
            (batch_size, n, feat), dtype=np.float32),
        "d_adj": d_adj, "q_adj": q_adj,
        "d_sem_adj": d_sem, "q_sem_adj": q_sem,
        "d_bb": d_bb, "q_bb": q_bb,
        "question": np.concatenate([
            rng.integers(1, vocab - 1, (batch_size, tq // 2)),
            np.zeros((batch_size, tq - tq // 2), np.int64)],
            axis=1).astype(np.int64),
    }
    if with_labels:
        lengths = rng.integers(1, max(2, t // 2), batch_size)
        labels = np.zeros((batch_size, t + 1), np.int64)
        masks = np.zeros((batch_size, t + 1), np.float32)
        labels[:, 0] = 1                      # <start>
        for i, L in enumerate(lengths):
            labels[i, 1:1 + L] = rng.integers(1, vocab - 1, L)
            masks[i, :L + 2] = 1.0            # tokens + EOS slot
        batch["labels"] = labels
        batch["masks"] = masks
    return batch


def synthetic_image(cfg, idx: int) -> Dict[str, np.ndarray]:
    """Deterministic per-image graph record (feats, bb, adj, sem_adj)."""
    d = cfg.data
    rng = np.random.default_rng(idx)
    bb = _boxes(rng, d.num_nodes)
    adj = np.zeros((d.adj_pad, d.adj_pad), np.int32)
    adj[:d.num_nodes, :d.num_nodes] = spatial_adjacency(bb)
    sem = np.zeros((d.adj_pad, d.adj_pad), np.int32)
    sem[:d.num_nodes, :d.num_nodes] = rng.integers(
        0, 3, (d.num_nodes, d.num_nodes))
    return {"feats": rng.standard_normal(
                (d.num_nodes, d.feature_dim)).astype(np.float32),
            "bb": bb, "adj": adj, "sem_adj": sem}


class SyntheticPairStore:
    """Study pairs with random questions and answers over a pool of
    synthetic images; the test split is the last tenth of the pairs.

    `sample(index)` returns one pair's model inputs, unbatched:
    d_/q_feats [N, F], d_/q_adj and d_/q_sem_adj [P, P], d_/q_bb [N, 4],
    question [Lq], plus labels [T+1]."""

    def __init__(self, cfg, n_pairs: int = 512, n_images: int = 256):
        self.cfg = cfg
        rng = np.random.default_rng(42)
        v = cfg.speaker.vocab_size
        t = cfg.speaker.seq_length
        lq = cfg.question.max_len
        self.questions = np.zeros((n_pairs, lq), np.int32)
        self.answers = np.zeros((n_pairs, t), np.int32)
        for i in range(n_pairs):
            ql = rng.integers(3, lq)
            self.questions[i, :ql] = rng.integers(1, v - 1, ql)
            al = rng.integers(2, max(3, t // 3))
            self.answers[i, 0] = 1
            self.answers[i, 1:al] = rng.integers(1, v - 1, al - 1)
            rng.integers(1, 16, al)           # POS ids (unused here)
        self.feature_idx = np.stack([rng.integers(0, n_images, n_pairs),
                                     rng.integers(0, n_images, n_pairs)],
                                    -1).astype(np.int64)
        self.split_idxs = np.arange(int(np.ceil(0.9 * n_pairs)), n_pairs,
                                    dtype=np.int64)

    def sample(self, index: int) -> Dict[str, np.ndarray]:
        d = synthetic_image(self.cfg, int(self.feature_idx[index][0]))
        q = synthetic_image(self.cfg, int(self.feature_idx[index][1]))
        labels = np.zeros(self.answers.shape[1] + 1, np.int32)
        labels[:-1] = self.answers[index]
        return {"d_feats": d["feats"], "q_feats": q["feats"],
                "d_adj": d["adj"], "q_adj": q["adj"],
                "d_sem_adj": d["sem_adj"], "q_sem_adj": q["sem_adj"],
                "d_bb": d["bb"], "q_bb": q["bb"],
                "question": self.questions[index].astype(np.int32),
                "labels": labels}
