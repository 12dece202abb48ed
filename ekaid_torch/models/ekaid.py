"""Full difference-VQA model: ChangeDetector + DynamicSpeaker (counterpart
of `ekaid_tpu/models/ekaid.py`).

A batch is a dict of padded arrays (numpy or torch):

  d_feats / q_feats   [B, N, F]   main/reference node features
  d_adj / q_adj       [B, P, P]   spatial adjacency labels 0..11
  d_sem_adj / ...     [B, P, P]   semantic adjacency labels 0..2
  d_bb / q_bb         [B, N, 4]   boxes
  question            [B, Lq]     question tokens

Only the eval path (`encode`, greedy `decode`) is ported; losses,
teacher forcing and beam search are not yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ekaid_torch.models.change_detector import ChangeDetector
from ekaid_torch.models.decoder import DynamicSpeaker
from ekaid_torch.models.layers import init_params
from ekaid_torch.ops.graph import broadcast_adjacency
from ekaid_torch.utils.device import resolve_device
from ekaid_torch.utils.dtypes import F32, Policy

_INPUTS = ("d_feats", "q_feats", "d_adj", "q_adj", "d_sem_adj", "q_sem_adj",
           "d_bb", "q_bb", "question")


class EkaidModel(nn.Module):
    """`device` defaults to CUDA and raises without a card unless the
    caller asks for 'cpu'. Parameters are drawn from `seed`; load trained
    or reference weights with `ekaid_torch.convert.load_flax_params`."""

    def __init__(self, cfg, ntoken: int, policy: Policy = F32,
                 device="cuda", seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.policy = policy
        self.change_detector = ChangeDetector(
            cfg.change_detector, feature_dim=cfg.data.feature_dim,
            speaker_embed_dim=cfg.speaker.embed_dim, ntoken=ntoken,
            graph=cfg.train.graph, setting=cfg.train.setting,
            question_att=cfg.question.att_mode, policy=policy)
        self.speaker = DynamicSpeaker(cfg.speaker, policy)
        if seed is not None:
            init_params(self, torch.Generator().manual_seed(seed))
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.speaker.word_emb.device

    def tensors(self, batch) -> Dict[str, torch.Tensor]:
        """The model inputs of `batch` as tensors on the model's device."""
        return {k: torch.as_tensor(batch[k], device=self.device)
                for k in _INPUTS}

    def _adjacencies(self, b):
        c = self.cfg.change_detector
        n = b["d_feats"].shape[1]
        dt = self.policy.compute_dtype
        return (broadcast_adjacency(b["d_adj"], c.spa_label_num, n, dt),
                broadcast_adjacency(b["q_adj"], c.spa_label_num, n, dt),
                broadcast_adjacency(b["d_sem_adj"], c.sem_label_num, n, dt),
                broadcast_adjacency(b["q_sem_adj"], c.sem_label_num, n, dt))

    @torch.no_grad()
    def encode(self, batch) -> Dict[str, torch.Tensor]:
        b = self.tensors(batch)
        d_adj, q_adj, d_sem, q_sem = self._adjacencies(b)
        return self.change_detector(
            b["d_feats"], b["q_feats"], d_adj, q_adj, d_sem, q_sem,
            b["d_bb"], b["q_bb"], b["question"])

    @torch.no_grad()
    def decode(self, batch) -> Dict[str, torch.Tensor]:
        """Greedy eval/inference path: the encoder's outputs plus seq,
        logprobs and module_weights."""
        enc = self.encode(batch)
        dec = self.speaker.sample(enc["feat_bef"], enc["feat_aft"],
                                  enc["feat_diff"])
        return {**enc, **dec}
