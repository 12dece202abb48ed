"""DeepSeek-V2 (arXiv:2405.04434): multi-head latent attention (MLA)
and DeepSeekMoE, for inference through a latent cache.

The layer equations are those of the published modeling code
(deepseek-ai/DeepSeek-V2-Lite, modeling_deepseek.py); `tests/
plain_deepseek_v2.py` is the plain float32 reference this module is
held to. Parameter names follow the published checkpoint's, with the
routed experts of a layer stacked into [E, out, in] tensors
(`Experts`).

Precision: the parameters and activations are in the compute dtype
(bf16 on the card; `utils/dtypes.lm_param_dtype`); norms, rotary
embedding, the attention softmax and the gate's softmax run in f32 and
round once to the compute dtype.

The cache (`LatentCache`) holds, for each layer, token and row, the
kv_lora_rank-wide normalised latent and the qk_rope_head_dim-wide rotated
key: 576 values a token and layer at DeepSeek-V2-Lite's widths, never
the expanded keys and values. The prefill attends in the expanded form
(keys and values of every head from the latent); a decode step attends
in the absorbed form: W_UK folded into the query, so that the scores
are one product against the cache's latents and rope keys, and W_UV
applied after the attention. A step reads its position from a device
tensor and attends over the whole cache under a mask, so it has no
shape that changes from step to step and waits on nothing of the host.

The routed experts (`MoE`) run on the tokens sorted by expert: on the
card in bf16 as three grouped products (`torch._grouped_mm`, one group
an expert, the groups' ends as device offsets); elsewhere as a loop
over the experts on their slices of the same sorted rows. Gate ties go
to the lower expert index (a stable sort).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


# ---- YaRN ----------------------------------------------------------------------

def yarn_mscale(scale: float, mscale: float) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(c) -> torch.Tensor:
    """[qk_rope_head_dim // 2] f32 frequencies: YaRN's blend of the
    interpolated and extrapolated frequencies over the correction
    range."""
    dim, base, rs = c.qk_rope_head_dim, c.rope_theta, c.rope_scaling
    pos = base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    extra, inter = 1.0 / pos, 1.0 / (rs.factor * pos)

    def corr(rot):
        return dim * math.log(rs.original_max_position_embeddings
                              / (rot * 2 * math.pi)) / (2 * math.log(base))

    lo = max(math.floor(corr(rs.beta_fast)), 0)
    hi = min(math.ceil(corr(rs.beta_slow)), dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - lo)
            / (hi - lo)).clamp(0, 1)
    return (inter * ramp + extra * (1 - ramp)).float()


def rope_mscale(c) -> float:
    """The factor on cos and sin (1 where mscale == mscale_all_dim)."""
    rs = c.rope_scaling
    return (yarn_mscale(rs.factor, rs.mscale)
            / yarn_mscale(rs.factor, rs.mscale_all_dim))


def softmax_scale(c) -> float:
    """qk_head_dim^-0.5 x mscale(factor, mscale_all_dim)^2."""
    m = yarn_mscale(c.rope_scaling.factor, c.rope_scaling.mscale_all_dim)
    return (c.qk_nope_head_dim + c.qk_rope_head_dim) ** -0.5 * m * m


def rope_tables(c, length: int, device) -> torch.Tensor:
    """[length, qk_rope_head_dim // 2] complex64: the rotations
    (cos + i sin, times the mscale ratio) of positions 0..length-1."""
    t = torch.arange(length, dtype=torch.float32, device=device)
    freqs = torch.outer(t, yarn_inv_freq(c).to(device))
    return torch.polar(torch.full_like(freqs, rope_mscale(c)), freqs)


def apply_rope(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotates interleaved pairs (x[2i], x[2i+1]) of x [..., d] by the
    rotations rot [..., d // 2] (broadcast over x's other axes), as one
    complex product in f32, rounded once; the pairs stay interleaved."""
    xc = torch.view_as_complex(x.float().unflatten(-1, (-1, 2)))
    return torch.view_as_real(xc * rot).flatten(-2).to(x.dtype)


# ---- the blocks ----------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        y = F.rms_norm(x.float(), x.shape[-1:], eps=self.eps)
        return self.weight * y.to(x.dtype)


def _linear(n_in: int, n_out: int) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False)


class MLP(nn.Module):
    """down(silu(gate(x)) * up(x))."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.gate_proj = _linear(dim, hidden)
        self.up_proj = _linear(dim, hidden)
        self.down_proj = _linear(hidden, dim)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Experts(nn.Module):
    """The routed experts, stacked: gate_proj, up_proj [E, I, D] and
    down_proj [E, D, I]."""

    def __init__(self, n: int, dim: int, hidden: int):
        super().__init__()
        self.gate_proj = nn.Parameter(torch.empty(n, hidden, dim))
        self.up_proj = nn.Parameter(torch.empty(n, hidden, dim))
        self.down_proj = nn.Parameter(torch.empty(n, dim, hidden))

    def grouped(self, xs: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        """xs [R, D], rows sorted by expert, offs [E] int32 the groups'
        ends: three grouped products, nothing read back to the host."""
        def mm(a, w):
            return torch._grouped_mm(a, w.transpose(-2, -1), offs=offs)

        h = F.silu(mm(xs, self.gate_proj)) * mm(xs, self.up_proj)
        return mm(h, self.down_proj)

    def looped(self, xs: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        """The same over each expert's slice of the sorted rows, one
        expert at a time (the slices' lengths read on the host)."""
        out = torch.empty_like(xs)
        start = 0
        for e, n in enumerate(counts.tolist()):
            if n:
                x = xs[start:start + n]
                h = (F.silu(F.linear(x, self.gate_proj[e]))
                     * F.linear(x, self.up_proj[e]))
                out[start:start + n] = F.linear(h, self.down_proj[e])
            start += n
        return out


def grouped_products_apply(x: torch.Tensor) -> bool:
    """Whether the routed experts run as grouped products: bf16 on a
    CUDA device, where `torch._grouped_mm` has its kernel."""
    return x.is_cuda and x.dtype == torch.bfloat16


def route(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(expert ids [T, k], their scores [T, k]): the k highest scores,
    ties to the lower index."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = idx[:, :k]
    return idx, torch.gather(scores, 1, idx)


class MoE(nn.Module):
    """DeepSeekMoE: a softmax gate in f32 over the routed experts, the
    greedy top-k of it (times routed_scaling_factor, or normalised where
    norm_topk_prob), the chosen experts' outputs summed with those
    weights in f32, and the shared experts on every token."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        self.gate = nn.Module()
        self.gate.weight = nn.Parameter(
            torch.empty(c.n_routed_experts, c.hidden_size))
        self.experts = Experts(c.n_routed_experts, c.hidden_size,
                               c.moe_intermediate_size)
        self.shared_experts = MLP(
            c.hidden_size, c.moe_intermediate_size * c.n_shared_experts)

    def routing(self, x: torch.Tensor):
        c = self.c
        scores = F.linear(x.float(), self.gate.weight.float()).softmax(-1)
        idx, w = route(scores, c.num_experts_per_tok)
        if c.num_experts_per_tok > 1 and c.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        else:
            w = w * c.routed_scaling_factor
        return idx, w

    def forward(self, x, grouped=None):
        """grouped: force the grouped (True) or looped (False) products;
        by default `grouped_products_apply`."""
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        idx, w = self.routing(x)
        k = idx.shape[1]
        ids, order = torch.sort(idx.reshape(-1), stable=True)
        xs = x[order // k]
        # each expert's group ends where the sorted ids pass its own
        ends = torch.searchsorted(
            ids, torch.arange(self.c.n_routed_experts, device=x.device),
            right=True, out_int32=True)
        if grouped is None:
            grouped = grouped_products_apply(x)
        if grouped:
            ys = self.experts.grouped(xs, ends)
        else:
            ys = self.experts.looped(xs, torch.diff(
                ends, prepend=ends.new_zeros(1)))
        y = torch.empty_like(ys)
        y[order] = ys
        y = (y.view(-1, k, shape[-1]).float() * w[..., None]).sum(1)
        y = y.to(x.dtype) + self.shared_experts(x)
        return y.reshape(shape)


class LatentCache:
    """The MLA cache: [layers, B, length, kv_lora_rank + qk_rope_head_dim]
    in the compute dtype, zeroed (a step attends over every slot, the
    unwritten ones masked)."""

    def __init__(self, c, batch: int, length: int, dtype, device):
        self.data = torch.zeros(
            c.num_hidden_layers, batch, length,
            c.kv_lora_rank + c.qk_rope_head_dim, dtype=dtype, device=device)

    @property
    def length(self) -> int:
        return self.data.shape[2]


class MLA(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        H = c.num_attention_heads
        self.q_proj = _linear(c.hidden_size,
                              H * (c.qk_nope_head_dim + c.qk_rope_head_dim))
        self.kv_a_proj_with_mqa = _linear(
            c.hidden_size, c.kv_lora_rank + c.qk_rope_head_dim)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps)
        self.kv_b_proj = _linear(c.kv_lora_rank,
                                 H * (c.qk_nope_head_dim + c.v_head_dim))
        self.o_proj = _linear(H * c.v_head_dim, c.hidden_size)
        self.scale = softmax_scale(c)

    def _query(self, x, rot):
        c = self.c
        q = self.q_proj(x).unflatten(-1, (c.num_attention_heads, -1))
        q_nope, q_pe = q.split([c.qk_nope_head_dim, c.qk_rope_head_dim], -1)
        return q_nope, apply_rope(q_pe, rot.unsqueeze(-2))

    def _latent(self, x, rot):
        """[..., kv_lora_rank + qk_rope_head_dim]: the normalised latent
        and the rotated rope key, as the cache holds them."""
        r = self.c.kv_lora_rank
        ckv, k_pe = self.kv_a_proj_with_mqa(x).split(
            [r, self.c.qk_rope_head_dim], -1)
        return torch.cat([self.kv_a_layernorm(ckv), apply_rope(k_pe, rot)],
                         -1)

    def _w_uk_uv(self):
        """W_UK [H, dn, r] and W_UV [H, dv, r], views of kv_b_proj."""
        c = self.c
        w = self.kv_b_proj.weight.view(c.num_attention_heads,
                                       c.qk_nope_head_dim + c.v_head_dim,
                                       c.kv_lora_rank)
        return w[:, :c.qk_nope_head_dim], w[:, c.qk_nope_head_dim:]

    def prefill(self, x, cache: torch.Tensor, rot):
        """x [B, L, D] at positions 0..L-1 (rot [L, d/2] their
        rotations), causal; writes the latents of those positions into
        this layer's cache [B, length, 576]."""
        c = self.c
        B, L, _ = x.shape
        H, dn, dr = c.num_attention_heads, c.qk_nope_head_dim, \
            c.qk_rope_head_dim
        q_nope, q_pe = self._query(x, rot)
        lat = self._latent(x, rot)
        cache[:, :L] = lat
        kv = self.kv_b_proj(lat[..., :c.kv_lora_rank]).unflatten(-1, (H, -1))
        k_nope, v = kv.split([dn, c.v_head_dim], -1)
        k = torch.cat([k_nope, lat[..., None, c.kv_lora_rank:].expand(
            B, L, H, dr)], -1)
        q = torch.cat([q_nope, q_pe], -1)
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=self.scale)
        return self.o_proj(o.transpose(1, 2).reshape(B, L, -1))

    def step(self, x, cache: torch.Tensor, pos: torch.Tensor, dead, rot):
        """x [B, D] at position pos ([1] int64 on the device), rot
        [1, d/2] its rotation, dead [length] bool (the positions past
        pos): the absorbed form over this layer's cache."""
        c = self.c
        B = x.shape[0]
        r = c.kv_lora_rank
        q_nope, q_pe = self._query(x, rot)                  # [B, H, .]
        cache.index_copy_(1, pos, self._latent(x, rot)[:, None])
        w_uk, w_uv = self._w_uk_uv()
        q_lat = torch.bmm(q_nope.transpose(0, 1), w_uk).transpose(0, 1)
        qc = torch.cat([q_lat, q_pe], -1)                   # [B, H, 576]
        s = torch.bmm(qc, cache.transpose(1, 2)).float() * self.scale
        p = s.masked_fill_(dead, float("-inf")).softmax(-1).to(x.dtype)
        o_lat = torch.bmm(p, cache[..., :r])                # [B, H, r]
        o = torch.bmm(o_lat.transpose(0, 1), w_uv.transpose(1, 2))
        return self.o_proj(o.transpose(0, 1).reshape(B, -1))

    def step_expanded(self, x, cache: torch.Tensor, pos: int, rot):
        """The same step with the keys and values of every head expanded
        from the cached latents (the plain form the absorbed one is
        tested against); pos a host int."""
        c = self.c
        B = x.shape[0]
        H, dn = c.num_attention_heads, c.qk_nope_head_dim
        q_nope, q_pe = self._query(x, rot)
        cache[:, pos] = self._latent(x, rot)
        lat = cache[:, :pos + 1]
        kv = self.kv_b_proj(lat[..., :c.kv_lora_rank]).unflatten(-1, (H, -1))
        k_nope, v = kv.split([dn, c.v_head_dim], -1)
        s = (torch.einsum("bhd,blhd->bhl", q_nope.float(), k_nope.float())
             + torch.einsum("bhd,bld->bhl", q_pe.float(),
                            lat[..., c.kv_lora_rank:].float())) * self.scale
        o = torch.einsum("bhl,blhd->bhd", s.softmax(-1), v.float())
        return self.o_proj(o.to(x.dtype).reshape(B, -1))


class DecoderLayer(nn.Module):
    def __init__(self, c, i: int):
        super().__init__()
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.self_attn = MLA(c)
        self.post_attention_layernorm = RMSNorm(c.hidden_size,
                                                c.rms_norm_eps)
        self.mlp = (MoE(c) if i >= c.first_k_dense_replace
                    and i % c.moe_layer_freq == 0
                    else MLP(c.hidden_size, c.intermediate_size))

    def prefill(self, x, cache, rot):
        x = x + self.self_attn.prefill(self.input_layernorm(x), cache, rot)
        return x + self.mlp(self.post_attention_layernorm(x))

    def step(self, x, cache, pos, dead, rot):
        x = x + self.self_attn.step(self.input_layernorm(x), cache, pos,
                                    dead, rot)
        return x + self.mlp(self.post_attention_layernorm(x))


class DeepseekV2(nn.Module):
    """The language model: embed_tokens, the decoder layers, norm and
    the untied lm_head. `prefill` and `step` run through a
    `LatentCache`; logits come out in f32 from the compute dtype's
    product."""

    def __init__(self, c):
        super().__init__()
        self.lm_cfg = c
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(c, i)
                                    for i in range(c.num_hidden_layers))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.lm_head = _linear(c.hidden_size, c.vocab_size)

    def new_cache(self, batch: int, length: int) -> LatentCache:
        w = self.lm_head.weight
        return LatentCache(self.lm_cfg, batch, length, w.dtype, w.device)

    def rope(self, length: int) -> torch.Tensor:
        return rope_tables(self.lm_cfg, length, self.lm_head.weight.device)

    def logits(self, h):
        return self.lm_head(self.norm(h)).float()

    def prefill(self, x, cache: LatentCache, rot):
        """x [B, L, D] embeddings at positions 0..L-1 (rot: `rope`'s
        rotations): the last position's logits [B, V]."""
        L = x.shape[1]
        for layer, kv in zip(self.layers, cache.data):
            x = layer.prefill(x, kv, rot[:L])
        return self.logits(x[:, -1])

    def step(self, ids, cache: LatentCache, pos: torch.Tensor, rot):
        """ids [B] at position pos ([1] int64 on the device): logits
        [B, V]."""
        dead = torch.arange(cache.length, device=pos.device) > pos
        r = rot.index_select(0, pos)
        x = self.embed_tokens(ids)
        for layer, kv in zip(self.layers, cache.data):
            x = layer.step(x, kv, pos, dead, r)
        return self.logits(x)
