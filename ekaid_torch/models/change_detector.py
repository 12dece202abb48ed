"""Graph change encoder (counterpart of
`ekaid_tpu/models/change_detector.py`).

1. project the node features (`img`);
2. encode the question;
3. mode2 (region features): run the semantic / spatial / implicit
   relation encoders over each image's node graph; mode0 (pixels in):
   the `PixelEncoder` turns each image's R101 cells into the nodes
   before `img`, and one `SelfAttention` block (SSRE) over the nodes,
   each concatenated with the question vector, replaces the relation
   encoders;
4. diff = aft - bef;
5. gated context fusion (tanh/sigmoid gates);
6. per-node sigmoid attention pooling -> feat_bef / feat_aft and the
   pooled difference feat_diff, plus the auxiliary 6-way head `pred`.

With `return_nodes` (the LM decoder's encoder, `models/lm_decoder.py`)
the outputs also hold each image's nodes after step 3, `nodes_bef` and
`nodes_aft` [B, N, att_dim]; without it, the six outputs above alone.

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
two [B] masks. mode0 ignores `pair_batch`, as the reference does.

Given a generator, the forward runs in training mode: the relation
encoders and the question encoder drop as their modules say, and the
fusion and pooling take six inverted-dropout masks at rate
`FUSION_DROPOUT` (both gates, both tanh contexts, both pooled
embeddings).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ekaid_torch.models.detector.backbone import ResNet, nchw, nhwc
from ekaid_torch.models.gat import (ExplicitRelationEncoder,
                                    ImplicitRelationEncoder, q_expand_v_cat)
from ekaid_torch.models.language import QuestionEncoder
from ekaid_torch.models.layers import DenseT, dropout
from ekaid_torch.ops.graph import position_embedding, position_matrix
from ekaid_torch.utils.dtypes import F32, Policy

_SEMANTIC = ("all", "semantic")
_SPATIAL = ("all", "spatial", "i+s")
_IMPLICIT = ("all", "implicit", "i+s")
FUSION_DROPOUT = 0.5
SSRE_DROPOUT = 0.1
LN_EPS = 1e-6                  # flax nn.LayerNorm's epsilon
R101 = (3, 4, 23, 3)
TRUNK_CHANNELS = 2048          # the trunk's c5 width


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis: statistics and the affine
    in f32, eps 1e-6, the result rounded once to the compute dtype."""

    def __init__(self, features: int, policy: Policy = F32):
        super().__init__()
        self.policy = policy
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def _reset(self, gen):
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.scale.float(),
                         self.bias.float(), eps=LN_EPS)
        return self.policy.cast_compute(y)


class SelfAttention(nn.Module):
    """Multi-head self-attention with an output LayerNorm (the SSRE block
    of the pixels-in mode0 path): q/k/v projections of `in_dim` inputs
    to att_dim, softmax(q k / sqrt(dh)) in the softmax dtype, attention
    dropout SSRE_DROPOUT from `gen`, the heads' contexts concatenated
    and normalised."""

    def __init__(self, in_dim: int, att_dim: int, num_heads: int,
                 policy: Policy = F32):
        super().__init__()
        if att_dim % num_heads:
            raise ValueError(f"The hidden size ({att_dim}) is not a multiple "
                             f"of the number of attention heads "
                             f"({num_heads})")
        self.att_dim = att_dim
        self.num_heads = num_heads
        self.policy = policy
        self.query = DenseT(in_dim, att_dim, policy=policy)
        self.key = DenseT(in_dim, att_dim, policy=policy)
        self.value = DenseT(in_dim, att_dim, policy=policy)
        self.LayerNorm_0 = LayerNorm(att_dim, policy)

    def forward(self, q_in, k_in, v_in, gen=None):
        p = self.policy
        H = self.num_heads
        dh = self.att_dim // H
        B, L, _ = q_in.shape
        qh = self.query(q_in).reshape(B, L, H, dh)
        kh = self.key(k_in).reshape(B, -1, H, dh)
        vh = self.value(v_in).reshape(B, -1, H, dh)
        att = p.cast_compute(torch.einsum("blhd,bmhd->bhlm", qh.float(),
                                          kh.float()))
        att = torch.softmax(p.cast_softmax(att) / (dh ** 0.5), dim=-1)
        att = dropout(att, SSRE_DROPOUT, gen)
        ctx = p.cast_compute(torch.einsum(
            "bhlm,bmhd->blhd", p.cast_compute(att).float(), vh.float()))
        return self.LayerNorm_0(ctx.reshape(B, L, self.att_dim))


class PixelEncoder(nn.Module):
    """The pixels-in front end (mode0): an R101 trunk with GroupNorm,
    then `fc_reshape` 2048 -> att_dim on each c5 cell; the cells,
    flattened row-major over (h, w), become the node axis. Images are
    [B, H, W] grayscale (repeated into 3 channels) or [B, H, W, 3]."""

    def __init__(self, att_dim: int, norm: str = "gn",
                 policy: Policy = F32):
        super().__init__()
        self.att_dim = att_dim
        self.policy = policy
        self.trunk = ResNet(3, depths=R101, norm=norm, policy=policy)
        self.fc_reshape = DenseT(TRUNK_CHANNELS, att_dim, policy=policy)

    def forward(self, images):
        if images.dim() == 3:
            images = images[..., None].expand(*images.shape, 3)
        c5 = nhwc(self.trunk(nchw(images))["c5"])       # [B, h, w, 2048]
        x = self.fc_reshape(self.policy.cast_compute(c5))
        return x.reshape(x.shape[0], -1, self.att_dim)


class ChangeDetector(nn.Module):
    def __init__(self, cfg, feature_dim: int, speaker_embed_dim: int,
                 ntoken: int, graph: str = "all", setting: str = "mode2",
                 question_att: str = "fixed", policy: Policy = F32,
                 return_nodes: bool = False):
        super().__init__()
        if setting not in ("mode2", "mode0"):
            raise ValueError(f"unknown setting {setting!r}")
        if cfg.branch_mix not in ("sequential", "parallel"):
            raise ValueError(f"unknown branch_mix {cfg.branch_mix!r}")
        self.cfg = cfg
        self.graph = graph
        self.setting = setting
        self.policy = policy
        self.return_nodes = return_nodes
        A = cfg.att_dim
        if setting == "mode0":
            # img runs on the extractor's att_dim-wide cells
            self.extractor = PixelEncoder(A, policy=policy)
            self.SSRE = SelfAttention(A + speaker_embed_dim, A, cfg.att_head,
                                      policy=policy)
            feature_dim = A
        self.img = DenseT(feature_dim, A, policy=policy)
        self.question = QuestionEncoder(ntoken, hidden_dim=speaker_embed_dim,
                                        att_mode=question_att, policy=policy)
        common = dict(v_dim=A, q_dim=speaker_embed_dim, out_dim=A,
                      dir_num=cfg.dir_num, nongt_dim=cfg.nongt_dim,
                      num_heads=cfg.att_head, dir_reduce=cfg.dir_reduce,
                      policy=policy)
        if setting == "mode2":         # mode0 has no relation encoders
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

    def _relations(self, input_bef, input_aft, d_adj, q_adj, d_sem_adj,
                   q_sem_adj, d_bb, q_bb, q_vec, gen):
        """mode2: the relation encoders over both images, in one [2B]
        pass or two [B] passes as `pair_batch` says."""
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
            return enc[:B], enc[B:]
        return (self._encode_image(input_bef, d_adj, d_sem_adj, pos_bef,
                                   q_vec, gen),
                self._encode_image(input_aft, q_adj, q_sem_adj, pos_aft,
                                   q_vec, gen))

    def forward(self, input_1, input_2, d_adj, q_adj, d_sem_adj, q_sem_adj,
                d_bb, q_bb, question,
                gen: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """input_1/2 [B, N, F] node features (bef, aft), or in mode0
        [B, H, W] images; d_/q_adj [B, N, N, spa_label_num] and
        d_/q_sem_adj [B, N, N, sem_label_num] one-hot adjacency; d_/q_bb
        [B, N, 4] boxes (all None in mode0); question [B, Lq].

        Returns pred [B, 6], att_bef/att_aft [B, 1, N] and
        feat_bef/feat_aft/feat_diff [B, att_dim]. gen: dropout draws
        (None: eval, no dropout)."""
        p = self.policy
        cast = p.cast_compute
        if self.setting == "mode0":
            input_1 = self.extractor(cast(input_1))
            input_2 = self.extractor(cast(input_2))
        input_bef = self.img(cast(input_1))
        input_aft = self.img(cast(input_2))
        q_vec = self.question(question, gen)
        if self.setting == "mode0":
            bef2 = q_expand_v_cat(q_vec, input_bef)
            aft2 = q_expand_v_cat(q_vec, input_aft)
            input_bef = self.SSRE(bef2, bef2, bef2, gen)
            input_aft = self.SSRE(aft2, aft2, aft2, gen)
        else:
            input_bef, input_aft = self._relations(
                input_bef, input_aft, d_adj, q_adj, d_sem_adj, q_sem_adj,
                d_bb, q_bb, q_vec, gen)
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
        out = {"pred": self.fc1(input_attended),
               "att_bef": att_bef.transpose(1, 2),
               "att_aft": att_aft.transpose(1, 2),
               "feat_bef": attended_1,
               "feat_aft": attended_2,
               "feat_diff": input_attended}
        if self.return_nodes:
            out.update(nodes_bef=input_bef, nodes_aft=input_aft)
        return out
