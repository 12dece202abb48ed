"""Relation-aware graph attention over the 52-node difference graph.

Counterpart of `ekaid_tpu/models/gat.py`:
  * `_GraphAttention`: multi-head QK attention over the first
    `nongt_dim` nodes with the raw node features as values, an optional
    geometric bias log(max(relu(W pos_emb), 1e-6)), non-edges masked to
    -9e15, then the per-edge label bias; heads concatenated and mixed by
    `linear_out_2`.
  * `GAttNet`: `dir_reduce='reference'` gives 2x the direction-1
    (transposed adjacency) attention, as the reference model executes;
    only that direction's layer exists, as in the reference package's
    param tree. 'sum' adds self + every direction.
  * Relation encoders: the pooled question vector is concatenated to
    every node (zeroed on all-zero nodes), and the GAT output is added
    back to the nodes as a residual.

Training-mode dropout (rate `GAT_DROPOUT`) precedes every FCNet product
but the label bias and follows the direction reduction; it runs when a
forward is given a generator.
"""

from __future__ import annotations

import torch
from torch import nn

from typing import Optional

from ekaid_torch.models.layers import DenseT, FCNet, dropout
from ekaid_torch.utils.dtypes import F32, Policy

NEG_INF = -9e15
GAT_DROPOUT = 0.2


def q_expand_v_cat(q, v):
    """q [B, Q], v [B, N, D] -> [B, N, D+Q]; q is zeroed on nodes whose
    features sum to 0 (padded or missing nodes)."""
    mask = v.sum(dim=-1, keepdim=True) != 0
    q_exp = q[:, None, :].expand(v.shape[0], v.shape[1], q.shape[-1])
    q_exp = torch.where(mask, q_exp, torch.zeros_like(q_exp))
    return torch.cat([v, q_exp], dim=-1)


class _GraphAttention(nn.Module):
    def __init__(self, feat_dim: int, num_heads: int, nongt_dim: int,
                 pos_emb_dim: int, policy: Policy = F32):
        super().__init__()
        self.num_heads = num_heads
        self.nongt_dim = nongt_dim
        self.policy = policy
        d = GAT_DROPOUT
        self.query = FCNet([feat_dim, feat_dim], act=None, dropout=d,
                           policy=policy)
        self.key = FCNet([feat_dim, feat_dim], act=None, dropout=d,
                         policy=policy)
        self.pair_pos_fc1 = (FCNet([pos_emb_dim, num_heads], act=None,
                                   dropout=d, policy=policy)
                             if pos_emb_dim > 0 else None)
        self.linear_out_2 = DenseT(num_heads * feat_dim, feat_dim,
                                   policy=policy)

    def forward(self, roi_feat, cond_adj, pos_emb, label_bias, gen=None):
        p = self.policy
        B, N, D = roi_feat.shape
        M = min(self.nongt_dim, N)
        H = self.num_heads
        dh = D // H
        nongt_feat = roi_feat[:, :M]
        qh = self.query(roi_feat, gen).reshape(B, N, H, dh)
        kh = self.key(nongt_feat, gen).reshape(B, M, H, dh)
        aff = p.cast_compute(torch.einsum("bnhd,bmhd->bnhm", qh.float(),
                                          kh.float()))
        aff = p.cast_softmax(aff) * (1.0 / (dh ** 0.5))
        if self.pair_pos_fc1 is not None:
            pos_w = torch.relu(p.cast_softmax(
                self.pair_pos_fc1(p.cast_compute(pos_emb), gen)))
            aff = aff + torch.log(torch.clamp(pos_w.permute(0, 1, 3, 2),
                                              min=1e-6))
        edge = cond_adj[:, :, None, :] > 0
        aff = torch.where(edge, aff, torch.full_like(aff, NEG_INF))
        aff = aff + p.cast_softmax(label_bias)[:, :, None, :]
        w = torch.softmax(aff, dim=-1)
        out = torch.einsum("bnhm,bmd->bnhd", p.cast_compute(w).float(),
                           p.cast_compute(nongt_feat).float())
        return self.linear_out_2(p.cast_compute(out).reshape(B, N, H * D))


class GAttNet(nn.Module):
    def __init__(self, dir_num: int, label_num: int, in_feat_dim: int,
                 out_feat_dim: int, nongt_dim: int = 52,
                 label_bias: bool = False, num_heads: int = 4,
                 pos_emb_dim: int = -1, dir_reduce: str = "reference",
                 policy: Policy = F32):
        super().__init__()
        if dir_num > 2:
            raise ValueError("Got more than two directions in a graph.")
        if dir_reduce == "reference":
            self.dirs = [dir_num - 1]
        elif dir_reduce == "sum":
            self.dirs = list(range(dir_num))
        else:
            raise ValueError(f"unknown dir_reduce {dir_reduce!r}")
        self.dir_reduce = dir_reduce
        self.nongt_dim = nongt_dim
        self.policy = policy
        self.self_weights = FCNet([in_feat_dim, out_feat_dim], act=None,
                                  dropout=GAT_DROPOUT, policy=policy)
        self.bias = FCNet([label_num, 1], act=None, use_bias=label_bias,
                          policy=policy)
        for d in self.dirs:
            self.add_module(f"neighbor_net_{d}", _GraphAttention(
                out_feat_dim, num_heads, nongt_dim, pos_emb_dim, policy))

    def _run_dir(self, d, self_feat, adj_onehot, pos_emb, gen):
        M = min(self.nongt_dim, self_feat.shape[1])
        adj_d = adj_onehot if d == 0 else adj_onehot.transpose(1, 2)
        adj_d = adj_d[:, :, :M, :]
        cond = adj_d.sum(dim=-1)
        lbias = self.bias(self.policy.cast_compute(adj_d))[..., 0]
        layer = getattr(self, f"neighbor_net_{d}")
        return layer(self_feat, cond, pos_emb, lbias, gen)

    def forward(self, v_feat, adj_onehot, pos_emb=None,
                gen: Optional[torch.Generator] = None):
        """v_feat [B, N, in]; adj_onehot [B, N, N, label_num];
        pos_emb [B, N, M, pos_emb_dim] or None; gen: dropout draws
        (None: no dropout)."""
        self_feat = self.self_weights(v_feat, gen)
        if self.dir_reduce == "reference":
            out = 2.0 * self._run_dir(self.dirs[0], self_feat, adj_onehot,
                                      pos_emb, gen)
        else:
            out = self_feat
            for d in self.dirs:
                out = out + self._run_dir(d, self_feat, adj_onehot, pos_emb,
                                          gen)
        return torch.relu(dropout(out, GAT_DROPOUT, gen))


class ExplicitRelationEncoder(nn.Module):
    def __init__(self, v_dim: int, q_dim: int, out_dim: int, dir_num: int,
                 label_num: int, nongt_dim: int = 52, num_heads: int = 4,
                 dir_reduce: str = "reference", policy: Policy = F32):
        super().__init__()
        self.v_transform = (FCNet([v_dim, out_dim], policy=policy)
                            if v_dim != out_dim else None)
        self.gat = GAttNet(dir_num, label_num, out_dim + q_dim, out_dim,
                           nongt_dim=nongt_dim, num_heads=num_heads,
                           dir_reduce=dir_reduce, policy=policy)

    def forward(self, v, adj_onehot, q, gen=None):
        if self.v_transform is not None:
            v = self.v_transform(v, gen)
        return v + self.gat(q_expand_v_cat(q, v), adj_onehot, gen=gen)


class ImplicitRelationEncoder(nn.Module):
    """Fully connected graph (all-ones adjacency, one label) plus the
    geometric position bias."""

    def __init__(self, v_dim: int, q_dim: int, out_dim: int, dir_num: int,
                 pos_emb_dim: int = 64, nongt_dim: int = 52,
                 num_heads: int = 4, dir_reduce: str = "reference",
                 policy: Policy = F32):
        super().__init__()
        self.policy = policy
        self.v_transform = (FCNet([v_dim, out_dim], policy=policy)
                            if v_dim != out_dim else None)
        self.gat = GAttNet(dir_num, 1, out_dim + q_dim, out_dim,
                           nongt_dim=nongt_dim, num_heads=num_heads,
                           pos_emb_dim=pos_emb_dim, dir_reduce=dir_reduce,
                           policy=policy)

    def forward(self, v, pos_emb, q, gen=None):
        if self.v_transform is not None:
            v = self.v_transform(v, gen)
        B, N = v.shape[0], v.shape[1]
        ones_adj = torch.ones(B, N, N, 1, dtype=self.policy.compute_dtype,
                              device=v.device)
        return v + self.gat(q_expand_v_cat(q, v), ones_adj, pos_emb, gen)
