"""Graph change encoder, mode2 (counterpart of
`ekaid_tpu/models/change_detector.py`).

1. project the node features (`img`);
2. encode the question;
3. run the semantic / spatial / implicit relation encoders over each
   image's node graph;
4. diff = aft - bef;
5. gated context fusion (tanh/sigmoid gates);
6. per-node sigmoid attention pooling -> feat_bef / feat_aft and the
   pooled difference feat_diff, plus the auxiliary 6-way head `pred`.

`branch_mix='sequential'` runs the three encoders as cumulative
residuals (the reference model as executed); 'parallel' mixes three
independent branches with coef_sem / coef_spa. `pair_batch` picks how
bef and aft go through the shared encoder stack: 'off', two [B] passes;
'on', one [2B] pass, the inputs concatenated (bef, aft)
on the batch axis with the question vector twice, then split at B;
'train', the [2B] pass in training only. Each row's math is the same
either way, so eval outputs agree up to the products' sum order (a GEMM
may block B and 2B rows differently); in training the [2B] pass draws
one [2B] dropout mask a site from the generator where two passes draw
two [B] masks. The pixels-in mode0 front end is not ported yet.

Given a generator, the forward runs in training mode: the relation
encoders and the question encoder drop as their modules say, and the
fusion and pooling take six inverted-dropout masks at rate
`FUSION_DROPOUT` (both gates, both tanh contexts, both pooled
embeddings).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ekaid_torch.models.gat import (ExplicitRelationEncoder,
                                    ImplicitRelationEncoder)
from ekaid_torch.models.language import QuestionEncoder
from ekaid_torch.models.layers import DenseT, dropout
from ekaid_torch.ops.graph import position_embedding, position_matrix
from ekaid_torch.utils.dtypes import F32, Policy

_SEMANTIC = ("all", "semantic")
_SPATIAL = ("all", "spatial", "i+s")
_IMPLICIT = ("all", "implicit", "i+s")
FUSION_DROPOUT = 0.5


class ChangeDetector(nn.Module):
    def __init__(self, cfg, feature_dim: int, speaker_embed_dim: int,
                 ntoken: int, graph: str = "all", setting: str = "mode2",
                 question_att: str = "fixed", policy: Policy = F32):
        super().__init__()
        if setting != "mode2":
            raise NotImplementedError(
                f"setting {setting!r}: only mode2 is ported")
        if cfg.branch_mix not in ("sequential", "parallel"):
            raise ValueError(f"unknown branch_mix {cfg.branch_mix!r}")
        self.cfg = cfg
        self.graph = graph
        self.policy = policy
        A = cfg.att_dim
        self.img = DenseT(feature_dim, A, policy=policy)
        self.question = QuestionEncoder(ntoken, hidden_dim=speaker_embed_dim,
                                        att_mode=question_att, policy=policy)
        common = dict(v_dim=A, q_dim=speaker_embed_dim, out_dim=A,
                      dir_num=cfg.dir_num, nongt_dim=cfg.nongt_dim,
                      num_heads=cfg.att_head, dir_reduce=cfg.dir_reduce,
                      policy=policy)
        if graph in _SEMANTIC:
            self.semantic_relation = ExplicitRelationEncoder(
                label_num=cfg.sem_label_num, **common)
        if graph in _SPATIAL:
            self.spatial_relation = ExplicitRelationEncoder(
                label_num=cfg.spa_label_num, **common)
        if graph in _IMPLICIT:
            self.imp_relation = ImplicitRelationEncoder(
                pos_emb_dim=cfg.pos_emb_dim, **common)
        self.context1 = DenseT(A, A, use_bias=False, policy=policy)
        self.context2 = DenseT(A, A, policy=policy)
        self.gate1 = DenseT(A, A, use_bias=False, policy=policy)
        self.gate2 = DenseT(A, A, policy=policy)
        self.embed = DenseT(3 * A, cfg.dim, policy=policy)
        self.att = DenseT(cfg.dim, 1, policy=policy)
        self.fc1 = DenseT(A, 6, policy=policy)

    def _position_emb(self, bb):
        pos_mat = position_matrix(bb, nongt_dim=self.cfg.nongt_dim)
        return position_embedding(pos_mat, feat_dim=self.cfg.pos_emb_dim)

    def _encode_image(self, v, spa_adj, sem_adj, pos_emb, q, gen):
        c, g = self.cfg, self.graph
        if c.branch_mix == "sequential":
            if g in _SEMANTIC:
                v = self.semantic_relation(v, sem_adj, q, gen)
            if g in _SPATIAL:
                v = self.spatial_relation(v, spa_adj, q, gen)
            if g in _IMPLICIT:
                v = self.imp_relation(v, pos_emb, q, gen)
            return v
        outs, coefs = [], []
        if g in _SEMANTIC:
            outs.append(self.semantic_relation(v, sem_adj, q, gen))
            coefs.append(c.coef_sem)
        if g in _SPATIAL:
            outs.append(self.spatial_relation(v, spa_adj, q, gen))
            coefs.append(c.coef_spa)
        if g in _IMPLICIT:
            outs.append(self.imp_relation(v, pos_emb, q, gen))
            coefs.append(1.0 - sum(coefs))
        if g == "all":
            return sum(w * o for w, o in zip(coefs, outs))
        if g == "i+s":
            return sum(outs) / len(outs)
        return outs[0]

    def forward(self, input_1, input_2, d_adj, q_adj, d_sem_adj, q_sem_adj,
                d_bb, q_bb, question,
                gen: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """input_1/2 [B, N, F] node features (bef, aft); d_/q_adj
        [B, N, N, spa_label_num] and d_/q_sem_adj [B, N, N, sem_label_num]
        one-hot adjacency; d_/q_bb [B, N, 4] boxes; question [B, Lq].

        Returns pred [B, 6], att_bef/att_aft [B, 1, N] and
        feat_bef/feat_aft/feat_diff [B, att_dim]. gen: dropout draws
        (None: eval, no dropout)."""
        p = self.policy
        cast = p.cast_compute
        input_bef = self.img(cast(input_1))
        input_aft = self.img(cast(input_2))
        q_vec = self.question(question, gen)
        implicit = self.graph in _IMPLICIT
        pos_bef = self._position_emb(d_bb) if implicit else None
        pos_aft = self._position_emb(q_bb) if implicit else None
        pb = self.cfg.pair_batch
        if pb == "on" or (pb == "train" and gen is not None):
            B = input_bef.shape[0]
            enc = self._encode_image(
                torch.cat([input_bef, input_aft]), torch.cat([d_adj, q_adj]),
                torch.cat([d_sem_adj, q_sem_adj]),
                torch.cat([pos_bef, pos_aft]) if implicit else None,
                torch.cat([q_vec, q_vec]), gen)
            input_bef, input_aft = enc[:B], enc[B:]
        else:
            input_bef = self._encode_image(input_bef, d_adj, d_sem_adj,
                                           pos_bef, q_vec, gen)
            input_aft = self._encode_image(input_aft, q_adj, q_sem_adj,
                                           pos_aft, q_vec, gen)
        input_diff = input_aft - input_bef

        ctx_d = self.context1(input_diff)
        gate_d = self.gate1(input_diff)
        def drop(x):
            return dropout(x, FUSION_DROPOUT, gen)

        befs = (drop(torch.sigmoid(gate_d + self.gate2(input_bef)))
                * drop(torch.tanh(ctx_d + self.context2(input_bef))))
        afts = (drop(torch.sigmoid(gate_d + self.gate2(input_aft)))
                * drop(torch.tanh(ctx_d + self.context2(input_aft))))

        emb_bef = torch.relu(drop(self.embed(
            torch.cat([input_bef, input_diff, befs], dim=-1))))
        emb_aft = torch.relu(drop(self.embed(
            torch.cat([input_aft, input_diff, afts], dim=-1))))
        att_bef = torch.sigmoid(p.cast_softmax(self.att(emb_bef)))
        att_aft = torch.sigmoid(p.cast_softmax(self.att(emb_aft)))

        attended_1 = (input_bef * cast(att_bef)).sum(dim=1)
        attended_2 = (input_aft * cast(att_aft)).sum(dim=1)
        input_attended = attended_2 - attended_1
        return {"pred": self.fc1(input_attended),
                "att_bef": att_bef.transpose(1, 2),
                "att_aft": att_aft.transpose(1, 2),
                "feat_bef": attended_1,
                "feat_aft": attended_2,
                "feat_diff": input_attended}
