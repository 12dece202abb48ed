"""The plain EKAID model, frozen for the benchmark's comparison.

A copy of the model's mathematics in plain PyTorch, kept beside the
benchmark so that a change to the program cannot move the yardstick:
the question encoder (dual word embedding, GRU, self-attention
pooling), the semantic / spatial / implicit relation encoders and their
graph attention, the pixels-in R101-GroupNorm trunk and its
self-attention block (mode0), the gated fusion and attention pooling,
and the two-LSTM `DynamicSpeaker` step. It imports nothing of the
program.

Parameters carry the program's names and layouts (dense kernels are
[in, out], LSTM gates (i, f, g, o), GRU gates (r, z, n), conv kernels
OIHW), so one state dict made by `benchlib.weights` loads into both.

Precision: every value that the program rounds to its compute dtype
goes through `Precision.q` here, and every matrix product through
`Precision.mm` (the operands rounded by q, the f32 product rounded by
q). `F32` rounds nothing, which is the reference; `fp8()` rounds to
float8 e4m3 at the same points, the control one precision below the
configuration's bfloat16.

It is the inference model: dropout is the identity there, and none is
drawn.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -9e15
LN_EPS = 1e-6
GN_GROUPS = 32
GN_EPS = 1e-6
R101 = (3, 4, 23, 3)
TRUNK_CHANNELS = 2048
_SEMANTIC = ("all", "semantic")
_SPATIAL = ("all", "spatial", "i+s")
_IMPLICIT = ("all", "implicit", "i+s")


@dataclass(frozen=True)
class Precision:
    """Where the model rounds: `q` rounds a tensor to the compute
    precision (identity for the f32 reference)."""
    q: Callable[[torch.Tensor], torch.Tensor]
    name: str = "float32"

    def mm(self, a, b):
        return self.q(torch.matmul(self.q(a).float(), self.q(b).float()))


def _identity(x):
    return x.float()


def _round_fp8(x):
    """float8 e4m3 rounding (saturating at +-448), back in f32."""
    x = x.float().clamp(-448.0, 448.0)
    return x.to(torch.float8_e4m3fn).float()


F32 = Precision(_identity, "float32")


def fp8() -> Precision:
    return Precision(_round_fp8, "float8_e4m3")


# ---- initialisation rules, read by benchlib.weights ------------------------
# Each module lists (parameter, rule, argument) for its own parameters:
# 'uniform' U(-a, a); 'normal' N(0, 1) with an optional zeroed row;
# 'scaled_normal' N(0, 1) * a; 'const' the value a; 'norm_of' the
# Frobenius norm of the named sibling.


class Dense(nn.Module):
    def __init__(self, pr: Precision, n_in: int, n_out: int,
                 use_bias: bool = True):
        super().__init__()
        self.pr = pr
        self.kernel = nn.Parameter(torch.empty(n_in, n_out))
        self.bias = nn.Parameter(torch.empty(n_out)) if use_bias else None

    def init_rules(self):
        a = 1.0 / math.sqrt(self.kernel.shape[0])
        out = [("kernel", "uniform", a)]
        if self.bias is not None:
            out.append(("bias", "uniform", a))
        return out

    def forward(self, x):
        y = self.pr.mm(x, self.kernel)
        if self.bias is not None:
            y = self.pr.q(y + self.pr.q(self.bias))
        return y


class WNDense(nn.Module):
    def __init__(self, pr: Precision, n_in: int, n_out: int,
                 use_bias: bool = True):
        super().__init__()
        self.pr = pr
        self.v = nn.Parameter(torch.empty(n_in, n_out))
        self.g = nn.Parameter(torch.empty(()))
        self.bias = nn.Parameter(torch.empty(n_out)) if use_bias else None

    def init_rules(self):
        a = 1.0 / math.sqrt(self.v.shape[0])
        out = [("v", "uniform", a), ("g", "norm_of", "v")]
        if self.bias is not None:
            out.append(("bias", "uniform", a))
        return out

    def forward(self, x):
        v = self.v.float()
        kernel = (self.g.float() / torch.sqrt(torch.sum(v * v))) * v
        y = self.pr.mm(x, kernel)
        if self.bias is not None:
            y = self.pr.q(y + self.pr.q(self.bias))
        return y


class FCNet(nn.Module):
    def __init__(self, pr, dims, act: bool = True, use_bias: bool = True):
        super().__init__()
        self.act = act
        self.n = len(dims) - 1
        for i in range(self.n):
            self.add_module(f"WNDense_{i}", WNDense(pr, dims[i], dims[i + 1],
                                                    use_bias))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"WNDense_{i}")(x)
            if self.act:
                x = torch.relu(x)
        return x


def lstm_gates(z, c_prev):
    i, f, g, o = z.float().chunk(4, dim=-1)
    c = torch.sigmoid(f) * c_prev.float() + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


class LSTMCell(nn.Module):
    def __init__(self, pr, n_in: int, hidden: int):
        super().__init__()
        self.pr = pr
        self.w_ih = nn.Parameter(torch.empty(n_in, 4 * hidden))
        self.w_hh = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.b = nn.Parameter(torch.empty(4 * hidden))
        self.hidden = hidden

    def init_rules(self):
        a = 1.0 / math.sqrt(self.hidden)
        return [("w_ih", "uniform", a), ("w_hh", "uniform", a),
                ("b", "uniform", a)]

    def forward(self, x, h, c):
        q = self.pr.q
        z = q(q(self.pr.mm(x, self.w_ih) + self.pr.mm(h, self.w_hh))
              + q(self.b))
        h, c = lstm_gates(z, q(c))
        return q(h), q(c)


class GRU(nn.Module):
    def __init__(self, pr, n_in: int, hidden: int):
        super().__init__()
        self.pr = pr
        self.hidden = hidden
        self.w_ih = nn.Parameter(torch.empty(n_in, 3 * hidden))
        self.w_hh = nn.Parameter(torch.empty(hidden, 3 * hidden))
        self.b_ih = nn.Parameter(torch.empty(3 * hidden))
        self.b_hh = nn.Parameter(torch.empty(3 * hidden))

    def init_rules(self):
        a = 1.0 / math.sqrt(self.hidden)
        return [(n, "uniform", a) for n in ("w_ih", "w_hh", "b_ih", "b_hh")]

    def forward(self, x):
        q = self.pr.q
        xp = q(self.pr.mm(x, self.w_ih) + q(self.b_ih))
        h = torch.zeros(x.shape[0], self.hidden, device=x.device)
        ys = []
        for t in range(x.shape[1]):
            hp = q(self.pr.mm(h, self.w_hh) + q(self.b_hh))
            xr, xz, xn = xp[:, t].chunk(3, dim=-1)
            hr, hz, hn = hp.chunk(3, dim=-1)
            r = q(torch.sigmoid(q(xr + hr)))
            z = q(torch.sigmoid(q(xz + hz)))
            n = q(torch.tanh(q(xn + q(r * hn))))
            h = q(q(q(1.0 - z) * n) + q(z * h))
            ys.append(h)
        return torch.stack(ys, dim=1)


# ---- question encoder --------------------------------------------------------

class WordEmbedding(nn.Module):
    def __init__(self, pr, ntoken: int, dim: int = 300):
        super().__init__()
        self.pr = pr
        self.ntoken = ntoken
        self.emb = nn.Parameter(torch.empty(ntoken + 1, dim))
        self.emb_fixed = nn.Parameter(torch.empty(ntoken + 1, dim),
                                      requires_grad=False)

    def init_rules(self):
        return [("emb", "normal", self.ntoken),
                ("emb_fixed", "normal", self.ntoken)]

    def forward(self, tokens):
        t = tokens.long()
        return self.pr.q(torch.cat([F.embedding(t, self.emb),
                                    F.embedding(t, self.emb_fixed)], -1))


class QuestionSelfAttention(nn.Module):
    def __init__(self, pr, hid: int):
        super().__init__()
        self.pr = pr
        self.FCNet_0 = FCNet(pr, [hid, hid], act=False)
        self.FCNet_1 = FCNet(pr, [hid, 1], act=False)

    def forward(self, feat):
        q = self.pr.q
        s = self.FCNet_1(q(torch.tanh(self.FCNet_0(feat))))[..., 0]
        w = torch.softmax(s.float(), dim=-1)
        return q(torch.einsum("bl,blh->bh", q(w), feat.float()))


class QuestionEncoder(nn.Module):
    def __init__(self, pr, ntoken: int, hidden: int):
        super().__init__()
        self.WordEmbedding_0 = WordEmbedding(pr, ntoken)
        self.GRU_0 = GRU(pr, 600, hidden)
        self.QuestionSelfAttention_0 = QuestionSelfAttention(pr, hidden)

    def forward(self, tokens):
        return self.QuestionSelfAttention_0(
            self.GRU_0(self.WordEmbedding_0(tokens)))


# ---- graph attention ---------------------------------------------------------

def q_expand_v_cat(q, v):
    mask = v.sum(dim=-1, keepdim=True) != 0
    qe = q[:, None, :].expand(v.shape[0], v.shape[1], q.shape[-1])
    qe = torch.where(mask, qe, torch.zeros_like(qe))
    return torch.cat([v, qe], dim=-1)


class GraphAttention(nn.Module):
    def __init__(self, pr, dim: int, heads: int, nongt: int, pos_dim: int):
        super().__init__()
        self.pr = pr
        self.heads = heads
        self.nongt = nongt
        self.query = FCNet(pr, [dim, dim], act=False)
        self.key = FCNet(pr, [dim, dim], act=False)
        self.pair_pos_fc1 = (FCNet(pr, [pos_dim, heads], act=False)
                             if pos_dim > 0 else None)
        self.linear_out_2 = Dense(pr, heads * dim, dim)

    def forward(self, roi, cond, pos_emb, label_bias):
        q = self.pr.q
        B, N, D = roi.shape
        M = min(self.nongt, N)
        H = self.heads
        dh = D // H
        nongt = roi[:, :M]
        qh = self.query(roi).reshape(B, N, H, dh)
        kh = self.key(nongt).reshape(B, M, H, dh)
        aff = q(torch.einsum("bnhd,bmhd->bnhm", qh.float(), kh.float()))
        aff = aff * (1.0 / math.sqrt(dh))
        if self.pair_pos_fc1 is not None:
            pw = torch.relu(self.pair_pos_fc1(q(pos_emb)).float())
            aff = aff + torch.log(torch.clamp(pw.permute(0, 1, 3, 2),
                                              min=1e-6))
        edge = cond[:, :, None, :] > 0
        aff = torch.where(edge, aff, torch.full_like(aff, NEG_INF))
        aff = aff + label_bias.float()[:, :, None, :]
        w = torch.softmax(aff, dim=-1)
        out = torch.einsum("bnhm,bmd->bnhd", q(w), q(nongt))
        return self.linear_out_2(q(out).reshape(B, N, H * D))


class GAttNet(nn.Module):
    """The reference's executed direction reduction: 2x the attention
    over the transposed adjacency (direction 1)."""

    def __init__(self, pr, label_num: int, in_dim: int, out_dim: int,
                 nongt: int, heads: int, pos_dim: int = -1):
        super().__init__()
        self.pr = pr
        self.nongt = nongt
        self.self_weights = FCNet(pr, [in_dim, out_dim], act=False)
        self.bias = FCNet(pr, [label_num, 1], act=False, use_bias=False)
        self.neighbor_net_1 = GraphAttention(pr, out_dim, heads, nongt,
                                             pos_dim)

    def forward(self, v, adj, pos_emb=None):
        self_feat = self.self_weights(v)
        M = min(self.nongt, self_feat.shape[1])
        adj_d = adj.transpose(1, 2)[:, :, :M, :]
        cond = adj_d.sum(dim=-1)
        lbias = self.bias(self.pr.q(adj_d))[..., 0]
        return torch.relu(
            2.0 * self.neighbor_net_1(self_feat, cond, pos_emb, lbias))


class RelationEncoder(nn.Module):
    def __init__(self, pr, dim: int, q_dim: int, label_num: int, nongt: int,
                 heads: int, pos_dim: int = -1):
        super().__init__()
        self.pr = pr
        self.implicit = pos_dim > 0
        self.gat = GAttNet(pr, label_num, dim + q_dim, dim, nongt, heads,
                           pos_dim)

    def forward(self, v, adj, q, pos_emb=None):
        if self.implicit:
            B, N = v.shape[:2]
            adj = torch.ones(B, N, N, 1, device=v.device)
        return self.pr.q(v + self.gat(q_expand_v_cat(q, v), adj, pos_emb))


def one_hot_adjacency(labels, num_labels: int, n: int):
    labels = labels[..., :n, :n].long()
    chans = torch.arange(1, num_labels + 1, device=labels.device)
    return (labels[..., None] == chans).float()


def position_embedding(boxes, nongt: int, feat_dim: int):
    b = boxes.float()
    x1, y1, x2, y2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    w, h = x2 - x1 + 1.0, y2 - y1 + 1.0
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    dx = torch.log(torch.clamp(((cx[..., :, None] - cx[..., None, :])
                                / w[..., :, None]).abs(), min=1e-3))
    dy = torch.log(torch.clamp(((cy[..., :, None] - cy[..., None, :])
                                / h[..., :, None]).abs(), min=1e-3))
    dw = torch.log(w[..., :, None] / w[..., None, :])
    dhh = torch.log(h[..., :, None] / h[..., None, :])
    pos = torch.stack([dx, dy, dw, dhh], -1)[..., :nongt, :]
    nf = feat_dim // 8
    rng = torch.arange(nf, dtype=torch.float32, device=b.device)
    dim_mat = torch.pow(torch.tensor(1000.0, device=b.device),
                        (8.0 / feat_dim) * rng)
    div = (100.0 * pos[..., None]) / dim_mat
    emb = torch.cat([torch.sin(div), torch.cos(div)], dim=-1)
    return emb.reshape(*emb.shape[:-2], feat_dim)


# ---- pixels-in front end (mode0) -------------------------------------------

class Conv(nn.Module):
    def __init__(self, pr, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.pr = pr
        self.stride = stride
        self.kernel = nn.Parameter(torch.empty(cout, cin, k, k))

    def init_rules(self):
        return [("kernel", "scaled_normal",
                 1.0 / math.sqrt(self.kernel[0].numel()))]

    def forward(self, x):
        q = self.pr.q
        return q(F.conv2d(q(x), q(self.kernel), None, stride=self.stride,
                          padding=self.kernel.shape[-1] // 2))


class Norm(nn.Module):
    """GroupNorm(32) (or LayerNorm over the last axis with `layer`):
    statistics and affine in f32, one rounding."""

    def __init__(self, pr, features: int, layer: bool = False):
        super().__init__()
        self.pr = pr
        self.layer = layer
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def init_rules(self):
        return [("scale", "const", 1.0), ("bias", "const", 0.0)]

    def forward(self, x):
        if self.layer:
            y = F.layer_norm(x.float(), x.shape[-1:], self.scale, self.bias,
                             eps=LN_EPS)
        else:
            y = F.group_norm(x.float(), GN_GROUPS, self.scale, self.bias,
                             eps=GN_EPS)
        return self.pr.q(y)


class Bottleneck(nn.Module):
    def __init__(self, pr, cin: int, cout: int, stride: int):
        super().__init__()
        width = cout // 4
        if stride != 1 or cin != cout:
            self.conv_sc = Conv(pr, cin, cout, 1, stride)
            self.norm_sc = Norm(pr, cout)
        else:
            self.conv_sc = None
        self.conv1 = Conv(pr, cin, width, 1)
        self.norm1 = Norm(pr, width)
        self.conv2 = Conv(pr, width, width, 3, stride)
        self.norm2 = Norm(pr, width)
        self.conv3 = Conv(pr, width, cout, 1)
        self.norm3 = Norm(pr, cout)
        self.pr = pr

    def forward(self, x):
        sc = x if self.conv_sc is None else self.norm_sc(self.conv_sc(x))
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        return torch.relu(self.pr.q(y + sc))


class Trunk(nn.Module):
    def __init__(self, pr, depths=R101,
                 channels=(256, 512, 1024, TRUNK_CHANNELS)):
        super().__init__()
        self.pr = pr
        self.stem_conv = Conv(pr, 3, 64, 7, 2)
        self.stem_norm = Norm(pr, 64)
        self.blocks = []
        prev = 64
        for s, (depth, ch) in enumerate(zip(depths, channels)):
            for b in range(depth):
                name = f"c{s + 2}_b{b}"
                self.add_module(name, Bottleneck(
                    pr, prev, ch, 2 if (b == 0 and s > 0) else 1))
                self.blocks.append(name)
                prev = ch

    def forward(self, x):
        x = torch.relu(self.stem_norm(self.stem_conv(self.pr.q(x))))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x


class PixelEncoder(nn.Module):
    def __init__(self, pr, att_dim: int, depths=R101):
        super().__init__()
        self.pr = pr
        self.att_dim = att_dim
        self.trunk = Trunk(pr, depths)
        self.fc_reshape = Dense(pr, TRUNK_CHANNELS, att_dim)

    def forward(self, images):
        x = images.float()[:, None].expand(-1, 3, -1, -1)
        c5 = self.trunk(x).permute(0, 2, 3, 1)
        y = self.fc_reshape(c5)
        return y.reshape(y.shape[0], -1, self.att_dim)


class SelfAttention(nn.Module):
    def __init__(self, pr, in_dim: int, att_dim: int, heads: int):
        super().__init__()
        self.pr = pr
        self.att_dim = att_dim
        self.heads = heads
        self.query = Dense(pr, in_dim, att_dim)
        self.key = Dense(pr, in_dim, att_dim)
        self.value = Dense(pr, in_dim, att_dim)
        self.LayerNorm_0 = Norm(pr, att_dim, layer=True)

    def forward(self, x):
        q = self.pr.q
        B, L, _ = x.shape
        H = self.heads
        dh = self.att_dim // H
        qh = self.query(x).reshape(B, L, H, dh)
        kh = self.key(x).reshape(B, L, H, dh)
        vh = self.value(x).reshape(B, L, H, dh)
        att = q(torch.einsum("blhd,bmhd->bhlm", qh, kh))
        att = torch.softmax(att / math.sqrt(dh), dim=-1)
        ctx = q(torch.einsum("bhlm,bmhd->blhd", q(att), vh))
        return self.LayerNorm_0(ctx.reshape(B, L, self.att_dim))


# ---- the change encoder --------------------------------------------------------

class ChangeDetector(nn.Module):
    def __init__(self, pr, cfg: dict, ntoken: int):
        super().__init__()
        self.pr = pr
        self.cfg = cfg
        A = cfg["att_dim"]
        E = cfg["embed_dim"]
        self.mode0 = cfg["setting"] == "mode0"
        feature_dim = cfg["feature_dim"]
        if self.mode0:
            self.extractor = PixelEncoder(pr, A, tuple(cfg.get(
                "trunk_depths", R101)))
            self.SSRE = SelfAttention(pr, A + E, A, cfg["att_head"])
            feature_dim = A
        self.img = Dense(pr, feature_dim, A)
        self.question = QuestionEncoder(pr, ntoken, E)
        if not self.mode0:
            common = dict(dim=A, q_dim=E, nongt=cfg["nongt_dim"],
                          heads=cfg["att_head"])
            self.semantic_relation = RelationEncoder(
                pr, label_num=cfg["sem_label_num"], **common)
            self.spatial_relation = RelationEncoder(
                pr, label_num=cfg["spa_label_num"], **common)
            self.imp_relation = RelationEncoder(
                pr, label_num=1, pos_dim=cfg["pos_emb_dim"], **common)
        self.context1 = Dense(pr, A, A, use_bias=False)
        self.context2 = Dense(pr, A, A)
        self.gate1 = Dense(pr, A, A, use_bias=False)
        self.gate2 = Dense(pr, A, A)
        self.embed = Dense(pr, 3 * A, cfg["dim"])
        self.att = Dense(pr, cfg["dim"], 1)
        self.fc1 = Dense(pr, A, 6)

    def _graph(self, v, spa, sem, pos, qv):
        v = self.semantic_relation(v, sem, qv)
        v = self.spatial_relation(v, spa, qv)
        return self.imp_relation(v, None, qv, pos_emb=pos)

    def forward(self, b: Dict[str, torch.Tensor]):
        pr, c = self.pr, self.cfg
        q = pr.q
        x1, x2 = b["d_feats"], b["q_feats"]
        if self.mode0:
            x1, x2 = self.extractor(x1), self.extractor(x2)
        bef = self.img(x1)
        aft = self.img(x2)
        qv = self.question(b["question"])
        if self.mode0:
            bef2, aft2 = q_expand_v_cat(qv, bef), q_expand_v_cat(qv, aft)
            bef, aft = self.SSRE(bef2), self.SSRE(aft2)
        else:
            n = x1.shape[1]
            spa = [one_hot_adjacency(b[k], c["spa_label_num"], n)
                   for k in ("d_adj", "q_adj")]
            sem = [one_hot_adjacency(b[k], c["sem_label_num"], n)
                   for k in ("d_sem_adj", "q_sem_adj")]
            pos = [position_embedding(b[k], c["nongt_dim"], c["pos_emb_dim"])
                   for k in ("d_bb", "q_bb")]
            bef = self._graph(bef, spa[0], sem[0], pos[0], qv)
            aft = self._graph(aft, spa[1], sem[1], pos[1], qv)
        diff = q(aft - bef)
        ctx_d = self.context1(diff)
        gate_d = self.gate1(diff)

        def fuse(x):
            g = q(torch.sigmoid(q(gate_d + self.gate2(x))))
            t = q(torch.tanh(q(ctx_d + self.context2(x))))
            return q(g * t)

        befs, afts = fuse(bef), fuse(aft)
        emb_b = torch.relu(self.embed(torch.cat([bef, diff, befs], -1)))
        emb_a = torch.relu(self.embed(torch.cat([aft, diff, afts], -1)))
        att_b = torch.sigmoid(self.att(emb_b).float())
        att_a = torch.sigmoid(self.att(emb_a).float())
        f1 = q((bef * q(att_b)).sum(dim=1))
        f2 = q((aft * q(att_a)).sum(dim=1))
        fd = q(f2 - f1)
        return {"pred": self.fc1(fd), "att_bef": att_b.transpose(1, 2),
                "att_aft": att_a.transpose(1, 2), "feat_bef": f1,
                "feat_aft": f2, "feat_diff": fd}


# ---- the speaker -------------------------------------------------------------

class DynamicCore(nn.Module):
    def __init__(self, pr, c: dict):
        super().__init__()
        self.pr = pr
        E, R, D = c["embed_dim"], c["rnn_size"], c["input_dim"]
        G = 2 * R + D
        self.module_att_lstm = LSTMCell(pr, E + R, R)
        self.weight_fc = Dense(pr, R, 3)
        self.pos1 = Dense(pr, R, R)
        self.weight_pos = Dense(pr, R, c["pos_classes"])
        self.pos2 = Dense(pr, c["pos_classes"], R)
        self.gate1x = Dense(pr, G, G)
        self.gate2x = Dense(pr, G, D)
        self.lang_lstm = LSTMCell(pr, c["word_embed_size"] + D, R)

    def forward(self, xt, fused, feats, state):
        q = self.pr.q
        h_mod, c_mod, prev_h, c_lang = state
        h_mod, c_mod = self.module_att_lstm(torch.cat([fused, prev_h], -1),
                                            h_mod, c_mod)
        mw = torch.softmax(self.weight_fc(h_mod).float(), dim=-1)
        dpos = self.weight_pos(torch.relu(self.pos1(prev_h)))
        ppos = self.pos2(q(torch.softmax(dpos.float(), dim=-1)))
        att = q(torch.matmul(q(mw)[:, None, :], q(feats))[:, 0])
        gate_h = torch.relu(self.gate1x(torch.cat([prev_h, ppos, att], -1)))
        gate = q(torch.sigmoid(self.gate2x(gate_h).float()))
        h_lang, c_lang = self.lang_lstm(torch.cat([xt, q(gate * att)], -1),
                                        prev_h, c_lang)
        return h_lang, (h_mod, c_mod, h_lang, c_lang), mw


class DynamicSpeaker(nn.Module):
    def __init__(self, pr, c: dict):
        super().__init__()
        self.pr = pr
        self.c = c
        self.word_emb = nn.Parameter(torch.empty(c["vocab_size"],
                                                 c["word_embed_size"]))
        self.embed = Dense(pr, 3 * c["input_dim"], c["embed_dim"])
        self.core = DynamicCore(pr, c)
        self.logit = Dense(pr, c["rnn_size"], c["vocab_size"])

    def init_rules(self):
        return [("word_emb", "normal", None)]

    def fused(self, enc):
        q = self.pr.q
        bef, dif, aft = q(enc["feat_bef"]), q(enc["feat_diff"]), \
            q(enc["feat_aft"])
        fused = torch.relu(self.embed(torch.cat([bef, dif, aft], -1)))
        return fused, torch.stack([bef, dif, aft], dim=1)

    def run(self, enc, tokens, ban_first: bool = False):
        """Teacher-forced steps: tokens [B, T] are the inputs of steps
        0..T-1. Returns log-probs [B, T, V] (f32) and module weights
        [B, T, 3]; with ban_first, the NULL token is banned at step 0,
        as the free-running decode bans it."""
        pr, c = self.pr, self.c
        q = pr.q
        B, T = tokens.shape
        fused, feats = self.fused(enc)
        z = torch.zeros(B, c["rnn_size"], device=tokens.device)
        state = (z, z, z, z)
        logps, mws = [], []
        for t in range(T):
            xt = torch.relu(q(F.embedding(tokens[:, t].long(),
                                          self.word_emb)))
            h, state, mw = self.core(xt, fused, feats, state)
            logp = torch.log_softmax(self.logit(h).float(), dim=-1)
            if ban_first and t == 0:
                logp = logp.clone()
                logp[:, 0] = -math.inf
            logps.append(logp)
            mws.append(mw)
        return torch.stack(logps, 1), torch.stack(mws, 1)

    def greedy(self, enc):
        """The free-running greedy decode (BOS in, NULL banned at step
        0, lowest index among equal maxima, stop once every row ended):
        seq [B, T] int32."""
        c, q = self.c, self.pr.q
        B = enc["feat_bef"].shape[0]
        dev = enc["feat_bef"].device
        fused, feats = self.fused(enc)
        z = torch.zeros(B, c["rnn_size"], device=dev)
        state = (z, z, z, z)
        it = torch.full((B,), c["bos_token"], dtype=torch.long, device=dev)
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        seq = torch.zeros(B, c["seq_length"], dtype=torch.int32, device=dev)
        for t in range(c["seq_length"]):
            if not bool(alive.any()):
                break
            xt = torch.relu(q(F.embedding(it, self.word_emb)))
            h, state, _ = self.core(xt, fused, feats, state)
            logp = torch.log_softmax(self.logit(h).float(), dim=-1)
            if t == 0:
                logp[:, 0] = -math.inf
            nxt = logp.argmax(-1)
            alive = alive & (nxt > 0)
            nxt = nxt * alive
            seq[:, t] = nxt.int()
            it = nxt
        return seq


class EkaidReference(nn.Module):
    """The whole model: `encode` and `forced` (teacher-forced log-probs
    of given answer tokens after BOS)."""

    def __init__(self, cfg: dict, ntoken: int, pr: Precision = F32):
        super().__init__()
        self.cfg = cfg
        self.change_detector = ChangeDetector(pr, cfg, ntoken)
        self.speaker = DynamicSpeaker(pr, cfg)

    def encode(self, b):
        return self.change_detector(b)

    def forced(self, b, seq):
        """Log-probs [B, T, V] and module weights [B, T, 3] at each
        position of the served tokens seq [B, T]: step 0 reads BOS and
        step t reads seq[:, t - 1], as the greedy decode feeds them."""
        enc = self.encode(b)
        bos = torch.full_like(seq[:, :1], self.cfg["bos_token"])
        inputs = torch.cat([bos, seq[:, :-1]], dim=1)
        return self.speaker.run(enc, inputs, ban_first=True)
