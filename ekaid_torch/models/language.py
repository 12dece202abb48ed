"""Question encoding: dual word embedding -> GRU -> self-attention pooling.

Counterpart of `ekaid_tpu/models/language.py`:
  * WordEmbedding: two [ntoken+1, 300] tables concatenated to 600-d;
    the padding row is index `ntoken` (row 0 stays trainable).
  * QuestionEncoder: one-layer GRU over every token, zero initial state.
  * QuestionSelfAttention: FCNet(H->H) -> tanh -> FCNet(H->1) scores,
    softmax over tokens ('fixed'), or the reference model's transposed
    softmax over the batch axis reread as [B, L] ('reference').

Training-mode dropout: `dropout_word` on the embeddings (0 by default),
`dropout_att` before the score FCNet's first product and on the pooled
vector; drawn only when a forward is given a generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from typing import Optional

from ekaid_torch.models.layers import FCNet, GRU, dropout, normal_table
from ekaid_torch.utils.dtypes import F32, Policy


class WordEmbedding(nn.Module):
    def __init__(self, ntoken: int, emb_dim: int = 300, dropout: float = 0.0,
                 policy: Policy = F32):
        super().__init__()
        self.ntoken = ntoken
        self.dropout = dropout
        self.policy = policy
        self.emb = nn.Parameter(torch.empty(ntoken + 1, emb_dim))
        self.emb_fixed = nn.Parameter(torch.empty(ntoken + 1, emb_dim),
                                      requires_grad=False)

    def _reset(self, gen):
        self.emb.copy_(normal_table(self.emb.shape, gen, self.ntoken))
        self.emb_fixed.copy_(normal_table(self.emb.shape, gen, self.ntoken))

    def forward(self, tokens, gen: Optional[torch.Generator] = None):
        # F.embedding, not indexing: on the CPU the gradient of an index
        # sums repeated tokens in a thread-dependent order
        tokens = tokens.long()
        out = torch.cat([F.embedding(tokens, self.emb),
                         F.embedding(tokens, self.emb_fixed)], dim=-1)
        return dropout(self.policy.cast_compute(out), self.dropout, gen)


class QuestionSelfAttention(nn.Module):
    def __init__(self, num_hid: int, dropout: float = 0.2,
                 att_mode: str = "fixed", policy: Policy = F32):
        super().__init__()
        if att_mode not in ("fixed", "reference"):
            raise ValueError(f"unknown att_mode {att_mode!r}")
        self.att_mode = att_mode
        self.policy = policy
        self.dropout = dropout
        self.FCNet_0 = FCNet([num_hid, num_hid], act=None, dropout=dropout,
                             policy=policy)
        self.FCNet_1 = FCNet([num_hid, 1], act=None, policy=policy)

    def forward(self, ques_feat, gen: Optional[torch.Generator] = None):
        """ques_feat [B, L, H] -> [B, H]."""
        p = self.policy
        scores = self.FCNet_1(torch.tanh(self.FCNet_0(ques_feat, gen)))[..., 0]
        if self.att_mode == "reference":
            B, L = scores.shape
            w = torch.softmax(p.cast_softmax(scores).T, dim=1)  # [L, B]
            w = w.contiguous().reshape(B, L)
        else:
            w = torch.softmax(p.cast_softmax(scores), dim=-1)
        pooled = torch.einsum("bl,blh->bh", p.cast_compute(w).float(),
                              ques_feat.float())
        return dropout(p.cast_compute(pooled), self.dropout, gen)


class QuestionEncoder(nn.Module):
    """word emb -> GRU -> self-att pooling; returns [B, hidden_dim]."""

    def __init__(self, ntoken: int, word_emb_dim: int = 300,
                 hidden_dim: int = 1024, dropout_word: float = 0.0,
                 dropout_att: float = 0.2, att_mode: str = "fixed",
                 policy: Policy = F32):
        super().__init__()
        self.WordEmbedding_0 = WordEmbedding(ntoken, word_emb_dim,
                                             dropout_word, policy)
        self.GRU_0 = GRU(2 * word_emb_dim, hidden_dim, policy)
        self.QuestionSelfAttention_0 = QuestionSelfAttention(
            hidden_dim, dropout_att, att_mode, policy)

    def forward(self, tokens, gen: Optional[torch.Generator] = None):
        seq = self.GRU_0(self.WordEmbedding_0(tokens, gen))
        return self.QuestionSelfAttention_0(seq, gen)
