"""The plain DeepSeek-V2 reference (`tests/plain_deepseek_v2.py`) tied to
a public implementation: the `transformers` `DeepseekV2ForCausalLM`
installed here, built from a small `DeepseekV2Config` in code (nothing
downloaded), its weights drawn from a seed and copied into the
reference's names. With plain RoPE the logits agree to f32 round-off.
With YaRN they agree once the `transformers` model's softmax scale is
multiplied by mscale(factor, mscale_all_dim)^2: the published
modeling_deepseek.py applies that factor, and `transformers` 4.57's
`DeepseekV2Attention` leaves it out (without it they differ, which the
test also shows). Skipped where `transformers` lacks the model."""

import os

import pytest
import torch

import plain_deepseek_v2 as ref

SMALL = dict(vocab_size=300, hidden_size=64, intermediate_size=96,
             moe_intermediate_size=32, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=4,
             n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=2,
             kv_lora_rank=32, q_lora_rank=None, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, first_k_dense_replace=1,
             topk_method="greedy", n_group=1, topk_group=1,
             norm_topk_prob=False, routed_scaling_factor=1.0,
             rms_norm_eps=1e-6, rope_theta=10000.0, attention_bias=False,
             tie_word_embeddings=False, max_position_embeddings=163840)
YARN = {"type": "yarn", "factor": 40.0,
        "original_max_position_embeddings": 4096, "beta_fast": 32,
        "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}


@pytest.fixture(scope="module")
def hf():
    os.environ.setdefault("USE_TF", "0")
    tf = pytest.importorskip("transformers")
    if not hasattr(tf, "DeepseekV2ForCausalLM"):
        pytest.skip("transformers has no DeepseekV2ForCausalLM")
    return tf


def build(hf, rope_scaling):
    cfg = hf.DeepseekV2Config(rope_scaling=dict(rope_scaling)
                              if rope_scaling else None,
                              attn_implementation="eager", **SMALL)
    torch.manual_seed(0)
    model = hf.DeepseekV2ForCausalLM(cfg).eval()
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


def reference_weights(model):
    """The model's parameters under the reference's names, each layer's
    routed experts stacked."""
    sd = {k.removeprefix("model."): v for k, v in model.state_dict().items()}
    out = {k: v for k, v in sd.items() if ".mlp.experts." not in k}
    for i in range(SMALL["num_hidden_layers"]):
        p = f"layers.{i}.mlp.experts."
        for n in ("gate_proj", "up_proj", "down_proj"):
            parts = [sd[f"{p}{e}.{n}.weight"]
                     for e in range(SMALL["n_routed_experts"])
                     if f"{p}{e}.{n}.weight" in sd]
            if parts:
                out[p + n] = torch.stack(parts)
    return out


def ref_config(rope_scaling):
    return {**SMALL, "moe_layer_freq": 1, "rope_scaling": rope_scaling,
            "bos_token_id": 1}


def logits_both(model, rope_scaling):
    x = torch.randn(2, 11, SMALL["hidden_size"],
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = model(inputs_embeds=x).logits
        want = ref.forward(ref_config(rope_scaling),
                           reference_weights(model), x)
    return got, want


def close(got, want):
    return float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_names_cover_every_parameter(hf):
    model = build(hf, None)
    got = {k: tuple(v.shape) for k, v in reference_weights(model).items()}
    want = ref.param_shapes(ref_config(None), att_dim=16)
    want = {k: v for k, v in want.items() if not k.startswith("projector.")}
    assert got == want


def test_plain_rope_logits_equal(hf):
    assert close(*logits_both(build(hf, None), None))


def test_yarn_logits_equal_with_the_published_softmax_factor(hf):
    model = build(hf, YARN)
    got, want = logits_both(model, YARN)
    assert not close(got, want)       # transformers omits mscale^2
    m = ref.yarn_get_mscale(YARN["factor"], YARN["mscale_all_dim"])
    for layer in model.model.layers:
        layer.self_attn.scaling *= m * m
    assert close(*logits_both(model, YARN))
