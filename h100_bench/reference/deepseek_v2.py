"""The plain DeepSeek-V2 LM and the LLaVA-1.5 projector, frozen for the
benchmark's comparison: a copy of the repository's plain reference
(`tests/plain_deepseek_v2.py`), kept beside the benchmark so that a
change to the program cannot move the yardstick, with two additions:

- Precision: every product's operands and output, every norm's and
  every activation's output and the residual stream go through
  `Precision.q` (`reference/model.py`'s hook): `F32` rounds nothing,
  which is the reference; `fp8()` rounds to float8 e4m3 at the same
  points, the control one precision below the configuration's
  bfloat16.
- Layer by layer: the weights are read from a mapping when a layer
  runs and dropped after it, so the benchmark can hand it a mapping
  that makes each tensor from the seed on demand and never holds more
  than one layer's float32 weights on the card.

It follows the published modeling code (deepseek-ai/DeepSeek-V2-Lite,
modeling_deepseek.py) and LLaVA-1.5's `mlp2x_gelu` projector
(arXiv:2310.03744), with the departures the original lists: the softmax
scale is qk_head_dim^-0.5 x mscale(factor, mscale_all_dim)^2, as
modeling_deepseek.py sets it; gate ties go to the lower expert index;
the routed experts of a layer are stacked [E, out, in] tensors; only
greedy top-k, softmax scores, no q LoRA, no attention bias; the input is
given as embeddings. It imports nothing of the program and nothing of
`transformers`.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from reference.model import F32, Precision


def param_shapes(c: Mapping, att_dim: int) -> Dict[str, tuple]:
    """Every parameter's name and shape."""
    D, H = c["hidden_size"], c["num_attention_heads"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    r, E, I = c["kv_lora_rank"], c["n_routed_experts"], \
        c["moe_intermediate_size"]
    out = {"projector.0.weight": (D, att_dim), "projector.0.bias": (D,),
           "projector.2.weight": (D, D), "projector.2.bias": (D,),
           "embed_tokens.weight": (c["vocab_size"], D)}
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        out.update({
            p + "input_layernorm.weight": (D,),
            p + "post_attention_layernorm.weight": (D,),
            p + "self_attn.q_proj.weight": (H * (dn + dr), D),
            p + "self_attn.kv_a_proj_with_mqa.weight": (r + dr, D),
            p + "self_attn.kv_a_layernorm.weight": (r,),
            p + "self_attn.kv_b_proj.weight": (H * (dn + dv), r),
            p + "self_attn.o_proj.weight": (D, H * dv)})
        if is_moe(c, i):
            S = I * c["n_shared_experts"]
            out.update({
                p + "mlp.gate.weight": (E, D),
                p + "mlp.experts.gate_proj": (E, I, D),
                p + "mlp.experts.up_proj": (E, I, D),
                p + "mlp.experts.down_proj": (E, D, I),
                p + "mlp.shared_experts.gate_proj.weight": (S, D),
                p + "mlp.shared_experts.up_proj.weight": (S, D),
                p + "mlp.shared_experts.down_proj.weight": (D, S)})
        else:
            F_ = c["intermediate_size"]
            out.update({p + "mlp.gate_proj.weight": (F_, D),
                        p + "mlp.up_proj.weight": (F_, D),
                        p + "mlp.down_proj.weight": (D, F_)})
    out["norm.weight"] = (D,)
    out["lm_head.weight"] = (c["vocab_size"], D)
    return out


def is_moe(c: Mapping, i: int) -> bool:
    return (c["n_routed_experts"] is not None
            and i >= c["first_k_dense_replace"]
            and i % c["moe_layer_freq"] == 0)


# ---- YaRN (modeling_deepseek.py) --------------------------------------------

def yarn_find_correction_dim(num_rotations, dim, base, max_pos):
    return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_find_correction_range(low_rot, high_rot, dim, base, max_pos):
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base, max_pos))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base, max_pos))
    return max(low, 0), min(high, dim - 1)


def yarn_get_mscale(scale=1.0, mscale=1.0):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_linear_ramp_mask(lo, hi, dim):
    if lo == hi:
        hi += 0.001
    return torch.clamp((torch.arange(dim, dtype=torch.float32) - lo)
                       / (hi - lo), 0, 1)


def rotary_cos_sin(c: Mapping, seq_len: int):
    """cos, sin [seq_len, rope_dim] in the published layout (the
    frequencies repeated over both halves), with YaRN's mscale ratio."""
    dim, base = c["qk_rope_head_dim"], c["rope_theta"]
    rs = c.get("rope_scaling")
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                            / dim))
    mscale = 1.0
    if rs is None:
        inv_freq = extra
    else:
        factor = rs["factor"]
        inter = 1.0 / (factor * base ** (
            torch.arange(0, dim, 2, dtype=torch.float32) / dim))
        low, high = yarn_find_correction_range(
            rs["beta_fast"], rs["beta_slow"], dim, base,
            rs["original_max_position_embeddings"])
        mask = 1.0 - yarn_linear_ramp_mask(low, high, dim // 2)
        inv_freq = inter * (1 - mask) + extra * mask
        mscale = (yarn_get_mscale(factor, rs["mscale"])
                  / yarn_get_mscale(factor, rs["mscale_all_dim"]))
    t = torch.arange(seq_len, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * mscale, emb.sin() * mscale


def softmax_scale(c: Mapping) -> float:
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    rs = c.get("rope_scaling")
    if rs is not None and rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rotate_half(x):
    x1, x2 = x[..., :x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary_pos_emb(x, cos, sin):
    """x [..., S, d] with interleaved pairs, as the checkpoint lays them
    out: de-interleaved, then rotated by halves."""
    *lead, s, d = x.shape
    x = x.reshape(*lead, s, d // 2, 2).transpose(-1, -2).reshape(*lead, s, d)
    return x * cos + rotate_half(x) * sin


# ---- the blocks ----------------------------------------------------------------

def linear(pr: Precision, x, weight, bias=None):
    y = pr.q(F.linear(pr.q(x), pr.q(weight)))
    return y if bias is None else pr.q(y + pr.q(bias))


def rms_norm(pr: Precision, x, weight, eps):
    var = x.pow(2).mean(-1, keepdim=True)
    return pr.q(pr.q(weight) * pr.q(x * torch.rsqrt(var + eps)))


def mlp(pr, w, prefix, x):
    h = pr.q(pr.q(F.silu(linear(pr, x, w[prefix + "gate_proj.weight"])))
             * linear(pr, x, w[prefix + "up_proj.weight"]))
    return linear(pr, h, w[prefix + "down_proj.weight"])


def gate(c, weight, x):
    """(expert ids [T, k], weights [T, k]) of the greedy top-k gate over
    the softmax scores (in f32 at every precision, as published)."""
    scores = F.linear(x, weight).softmax(dim=-1)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = order[:, :c["num_experts_per_tok"]]
    wk = torch.gather(scores, 1, idx)
    if c["num_experts_per_tok"] > 1 and c["norm_topk_prob"]:
        wk = wk / (wk.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        wk = wk * c["routed_scaling_factor"]
    return idx, wk


def moe(pr, c, w, prefix, x):
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    idx, wk = gate(c, pr.q(w[prefix + "gate.weight"]), x)
    gp, up, dp = (w[prefix + "experts." + n]
                  for n in ("gate_proj", "up_proj", "down_proj"))
    y = torch.zeros_like(x)
    for e in range(c["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok) == 0:
            continue
        xe = x[tok]
        h = pr.q(pr.q(F.silu(linear(pr, xe, gp[e]))) * linear(pr, xe, up[e]))
        y.index_add_(0, tok, linear(pr, h, dp[e]) * wk[tok, slot][:, None])
    y = pr.q(pr.q(y) + mlp(pr, w, prefix + "shared_experts.", x))
    return y.reshape(shape)


def attention(pr, c, w, prefix, x, cos, sin):
    B, S, _ = x.shape
    q_ = pr.q
    H = c["num_attention_heads"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    r = c["kv_lora_rank"]
    q = linear(pr, x, w[prefix + "q_proj.weight"]).view(B, S, H, dn + dr)
    q = q.transpose(1, 2)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    ckv = linear(pr, x, w[prefix + "kv_a_proj_with_mqa.weight"])
    ckv, k_pe = ckv.split([r, dr], dim=-1)
    k_pe = k_pe.view(B, S, 1, dr).transpose(1, 2)
    kv = linear(pr, rms_norm(pr, ckv, w[prefix + "kv_a_layernorm.weight"],
                             c["rms_norm_eps"]),
                w[prefix + "kv_b_proj.weight"])
    kv = kv.view(B, S, H, dn + dv).transpose(1, 2)
    k_nope, v = kv.split([dn, dv], dim=-1)
    q_pe = q_(apply_rotary_pos_emb(q_pe, cos, sin))
    k_pe = q_(apply_rotary_pos_emb(k_pe, cos, sin))
    qs = torch.cat([q_nope, q_pe], dim=-1)
    ks = torch.cat([k_nope, k_pe.expand(B, H, S, dr)], dim=-1)
    att = torch.matmul(qs, ks.transpose(2, 3)) * softmax_scale(c)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    att = q_(att.masked_fill(~causal, float("-inf")).softmax(dim=-1))
    out = q_(torch.matmul(att, v)).transpose(1, 2).reshape(B, S, H * dv)
    return linear(pr, out, w[prefix + "o_proj.weight"])


def layer(c, w, i, x, cos, sin, pr: Precision = F32):
    p = f"layers.{i}."
    eps = c["rms_norm_eps"]
    x = pr.q(x + attention(pr, c, w, p + "self_attn.", rms_norm(
        pr, x, w[p + "input_layernorm.weight"], eps), cos, sin))
    h = rms_norm(pr, x, w[p + "post_attention_layernorm.weight"], eps)
    h = (moe(pr, c, w, p + "mlp.", h) if is_moe(c, i)
         else mlp(pr, w, p + "mlp.", h))
    return pr.q(x + h)


def forward(c, w, inputs_embeds, pr: Precision = F32, positions=None):
    """Logits [B, S, V] of one causal forward over the embeddings;
    positions: the positions whose logits to return (all by default)."""
    cos, sin = rotary_cos_sin(c, inputs_embeds.shape[1])
    cos, sin = cos.to(inputs_embeds.device), sin.to(inputs_embeds.device)
    x = pr.q(inputs_embeds)
    for i in range(c["num_hidden_layers"]):
        x = layer(c, w, i, x, cos, sin, pr)
    if positions is not None:
        x = x[:, positions]
    x = rms_norm(pr, x, w["norm.weight"], c["rms_norm_eps"])
    return linear(pr, x, w["lm_head.weight"])


def projector(w, x, pr: Precision = F32):
    h = linear(pr, x, w["projector.0.weight"], w["projector.0.bias"])
    h = pr.q(F.gelu(h))
    return linear(pr, h, w["projector.2.weight"], w["projector.2.bias"])


def prompt(c, w, nodes_bef, nodes_aft, feat_bef, feat_diff, feat_aft,
           question, bos: Optional[int] = None, pr: Precision = F32):
    """The prompt's embeddings [B, 2N + 3 + Lq + 1, D]: the projected
    nodes of both images and the three pooled vectors, the question's
    ids (pads kept) and BOS through the LM's table."""
    vis = torch.cat([nodes_bef, nodes_aft, feat_bef[:, None],
                     feat_diff[:, None], feat_aft[:, None]], dim=1)
    table = w["embed_tokens.weight"]
    bos = c["bos_token_id"] if bos is None else bos
    ids = torch.cat([question.long(), torch.full_like(
        question[:, :1].long(), bos)], dim=1)
    return torch.cat([projector(w, pr.q(vis), pr), pr.q(table[ids])], dim=1)


def forced_logprobs(c, w, prompt_embeds, answer, pr: Precision = F32):
    """Log-probs [B, T, V] of the answer's positions, teacher-forced: the
    prompt, then answer[:, :T-1] fed back; position t's distribution is
    the one that picks answer[:, t]."""
    table = w["embed_tokens.weight"]
    T, L = answer.shape[1], prompt_embeds.shape[1]
    x = torch.cat([prompt_embeds, pr.q(table[answer[:, :T - 1].long()])],
                  dim=1)
    logits = forward(c, w, x, pr, positions=slice(L - 1, None))
    return torch.log_softmax(logits.float(), dim=-1)
