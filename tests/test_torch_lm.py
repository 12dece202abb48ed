"""The LM answer decoder (`models/deepseek_v2.py`, `models/lm_decoder.py`)
at small widths on seeded random weights, against the plain float32
reference `tests/plain_deepseek_v2.py`: the prefill and the cached
decode against one full causal forward, teacher-forced on the program's
tokens; the absorbed MLA step against the expanded one; the grouped
expert products against the per-expert loop; YaRN; the cache's shape;
`Trainer.evaluate` end to end with its spans and counters; and what the
decoder refuses. CPU only."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_deepseek_v2 as ref
from ekaid_torch.config import LMConfig, load_config, merge_overrides
from ekaid_torch.data.synthetic import synthetic_batch
from ekaid_torch.models import deepseek_v2 as dsv2
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.models.lm_decoder import END, LMDecoder
from ekaid_torch.train import test as ptest
from ekaid_torch.train.train import build_synthetic_trainer
from ekaid_torch.utils import observability as obs
from ekaid_torch.utils.dtypes import Policy

#: small widths; every kind of layer, YaRN, shared experts and a
#: routed-expert count that leaves some experts idle in a step
LM = {"vocab_size": 300, "hidden_size": 64, "intermediate_size": 96,
      "moe_intermediate_size": 32, "num_hidden_layers": 3,
      "num_attention_heads": 4, "num_key_value_heads": 4,
      "n_routed_experts": 8, "num_experts_per_tok": 3,
      "n_shared_experts": 2, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
      "qk_rope_head_dim": 8, "v_head_dim": 16, "bos_token_id": 290,
      "eos_token_id": 291}
B = 4


def small_cfg(dtype="float32", **lm):
    cfg = load_config("configs/smoke.yaml")
    return merge_overrides(cfg, {"decoder": "lm", "lm": {**LM, **lm},
                                 "dtypes": {"compute_dtype": dtype}})


def ref_cfg(c):
    return dataclasses.asdict(c)


def weights(lm):
    """The LM's parameters in f32, under the reference's names."""
    return {k: v.float() for k, v in lm.state_dict().items()}


def model(dtype="float32", seed=0):
    cfg = small_cfg(dtype)
    m = EkaidModel(cfg, ntoken=cfg.speaker.vocab_size - 1,
                   policy=Policy.from_config(cfg.dtypes), device="cpu",
                   seed=seed)
    return cfg, m


def forced_ids(seq, eos):
    """The tokens to feed back: END read as EOS."""
    return torch.where(seq < 0, eos, seq.long())


def live(seq):
    """Positions up to and including each row's first END."""
    ended = (seq < 0).int().cumsum(1)
    return (ended == 0) | ((ended == 1) & (seq < 0))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def decoded(request):
    cfg, m = model(request.param)
    batch = synthetic_batch(cfg, B, seed=1)
    out = m.decode(batch)
    w = weights(m.lm)
    q = torch.as_tensor(batch["question"])
    prompt = ref.prompt(ref_cfg(cfg.lm), w, *(
        out[k].float() for k in ("nodes_bef", "nodes_aft", "feat_bef",
                                 "feat_diff", "feat_aft")), q)
    ids = forced_ids(out["seq"], cfg.lm.eos_token_id)
    want = ref.forced_logprobs(ref_cfg(cfg.lm), w, prompt, ids)
    return request.param, cfg, m, batch, out, ids, want


def test_greedy_decode_against_the_reference(decoded):
    """The decode's tokens and log-probs against the reference's full
    forward, teacher-forced on those tokens. f32: only the order of the
    sums differs (log-probs of -5 to -6.3 within 5e-7 on three seeds;
    limit 1e-5), and a token may lose to the reference's best only by
    such a gap. bf16: every product and the residual stream round to 8
    bits, which moved a log-prob by up to 0.0028 (mean 0.0008-0.0009)
    and a token's gap by up to 0.0031 on three seeds; limits 0.015 and,
    for the mean, 0.003."""
    dtype, cfg, m, batch, out, ids, want = decoded
    seq = out["seq"]
    mask = live(seq)
    picked = want.gather(-1, ids[..., None])[..., 0]
    gap = want.max(-1).values - picked
    err = (out["logprobs"] - picked).abs()
    tol = 1e-5 if dtype == "float32" else 0.015
    assert float(gap[mask].max()) <= tol
    assert float(err[mask].max()) <= tol
    if dtype == "bfloat16":
        assert float(err[mask].mean()) <= 0.003
    assert seq.dtype == torch.int32 and tuple(seq.shape) == (
        B, cfg.speaker.seq_length)
    # random weights: answers run to the cap here, with no END
    assert bool(mask.all())


def test_prefill_and_cached_steps_give_the_reference_logits(decoded):
    """Logits, not tokens: the prefill, then one cached step a token fed
    back, against the reference's log-softmax at every answer position.
    f32: sum order alone (measured <= 1e-6 on three seeds; limit 1e-5);
    bf16: every activation rounds to 8 bits (measured 0.0037-0.0051;
    limit 0.015)."""
    dtype, cfg, m, batch, out, ids, want = decoded
    lm = m.lm
    x = lm.prompt(out, torch.as_tensor(batch["question"]))
    T = ids.shape[1]
    cache = lm.new_cache(B, x.shape[1] + T - 1)
    rot = lm.rope(cache.length)
    with torch.no_grad():
        got = [lm.prefill(x, cache, rot)]
        pos = torch.tensor([x.shape[1]])
        for t in range(T - 1):
            got.append(lm.step(ids[:, t], cache, pos, rot))
            pos += 1
    got = torch.log_softmax(torch.stack(got, 1), -1)
    tol = 1e-5 if dtype == "float32" else 0.015
    assert float((got - want).abs().max()) <= tol


def test_absorbed_step_equals_the_expanded_step():
    """W_UK folded into the query and W_UV applied after the attention,
    over the cached latents, against the keys and values of every head
    expanded from them: one f32 step's output, 1e-5 of its scale."""
    cfg, m = model()
    att = m.lm.layers[1].self_attn
    g = torch.Generator().manual_seed(3)
    L = 7
    x = torch.randn(B, L + 1, cfg.lm.hidden_size, generator=g)
    cache = torch.zeros(B, L + 1, cfg.lm.kv_lora_rank
                        + cfg.lm.qk_rope_head_dim)
    rot = dsv2.rope_tables(cfg.lm, L + 1, "cpu")
    with torch.no_grad():
        att.prefill(x[:, :L], cache, rot[:L])
        other = cache.clone()
        pos = torch.tensor([L])
        dead = torch.arange(L + 1) > pos
        a = att.step(x[:, L], cache, pos, dead, rot[L:])
        b = att.step_expanded(x[:, L], other, L, rot[L:])
    assert torch.equal(cache, other)
    assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def _moe_case(dtype):
    """A MoE layer and tokens whose gate leaves experts 6 and 7 with no
    token, and ties exactly for the third place in rows 0-3."""
    c = small_cfg().lm
    moe = dsv2.MoE(c)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in moe.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
        gate = torch.zeros(c.n_routed_experts, c.hidden_size)
        gate[:6, :6] = 4.0 * torch.eye(6)
        moe.gate.weight.copy_(gate)
    x = torch.randn(24, c.hidden_size, generator=g)
    x[:, :6] = x[:, :6].abs() + 0.1
    # rows 0-3: experts 0 and 1 first, 2 and 3 tied for third, 4 and 5
    # below them
    x[:4, :6] = torch.tensor([5.0, 5.0, 1.0, 1.0, 0.1, 0.1])
    return c, moe.to(getattr(torch, dtype)), x.to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_experts_equal_the_loop(dtype):
    """The grouped products (torch._grouped_mm over the rows sorted by
    expert) against the per-expert loop on the same rows: equal in f32
    to 1e-6 of the scale; in bf16 each product rounds once either way,
    so within two bf16 ulps of the output's scale."""
    c, moe, x = _moe_case(dtype)
    idx, _ = moe.routing(x)
    used = set(idx.flatten().tolist())
    assert {6, 7}.isdisjoint(used) and len(used) == 6
    # the exact tie goes to the lower index
    assert all(2 in r and 3 not in r for r in idx[:4].tolist())
    with torch.no_grad():
        a = moe(x, grouped=True).float()
        b = moe(x, grouped=False).float()
    scale = float(b.abs().max())
    tol = 1e-6 if dtype == "float32" else 2 * 2 ** -8
    assert float((a - b).abs().max()) <= tol * scale


def test_moe_against_the_reference():
    c, moe, x = _moe_case("float32")
    w = {"mlp." + k: v for k, v in moe.state_dict().items()}
    with torch.no_grad():
        got = moe(x, grouped=True)
    want = ref.moe(ref_cfg(c), w, "mlp.", x)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_route_ties_and_scores():
    s = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.1],
                      [0.2, 0.2, 0.2, 0.2, 0.2]])
    idx, w = dsv2.route(s, 2)
    assert idx.tolist() == [[1, 2], [0, 1]]
    assert torch.equal(w, torch.tensor([[0.3, 0.3], [0.2, 0.2]]))


def test_yarn_frequencies_and_mscale():
    """DeepSeek-V2-Lite's published YaRN: factor 40, original 4096,
    beta 32 / 1, mscale = mscale_all_dim = 0.707, theta 1e4, rope dim
    64."""
    c = LMConfig()
    m = 0.1 * 0.707 * np.log(40.0) + 1.0
    assert dsv2.yarn_mscale(40.0, 0.707) == pytest.approx(m, rel=1e-12)
    assert dsv2.rope_mscale(c) == 1.0
    assert dsv2.softmax_scale(c) == pytest.approx(192 ** -0.5 * m * m,
                                                  rel=1e-12)
    assert dsv2.softmax_scale(c) == pytest.approx(
        ref.softmax_scale(ref_cfg(c)), rel=1e-12)
    f = dsv2.yarn_inv_freq(c).double()
    base = 1e4 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    # correction range [floor(10.07...), ceil(22.98...)] = [10, 23]
    assert torch.allclose(f[:10], base[:10], rtol=1e-6)
    assert torch.allclose(f[23:], base[23:] / 40, rtol=1e-6)
    ramp = (torch.arange(10, 23, dtype=torch.float64) - 10) / 13
    assert torch.allclose(f[10:23], base[10:23] / 40 * ramp
                          + base[10:23] * (1 - ramp), rtol=1e-6)
    # the reference's tables: cos of the same angles, in halves
    rot = dsv2.rope_tables(c, 300, "cpu")
    rcos, rsin = ref.rotary_cos_sin(ref_cfg(c), 300)
    assert torch.allclose(rot.real, rcos[:, :32], atol=1e-5)
    assert torch.allclose(rot.imag, rsin[:, 32:], atol=1e-5)


def test_rope_on_interleaved_pairs_matches_the_published_rotation():
    """The program rotates (x[2i], x[2i+1]) in place; the published code
    de-interleaves, then rotates by halves: the same dot products."""
    c = small_cfg().lm
    g = torch.Generator().manual_seed(2)
    q, k = torch.randn(2, 5, 8, generator=g), torch.randn(2, 5, 8,
                                                          generator=g)
    rot = dsv2.rope_tables(c, 5, "cpu")
    rcos, rsin = ref.rotary_cos_sin(ref_cfg(c), 5)
    a = (dsv2.apply_rope(q, rot)[:, :, None]
         * dsv2.apply_rope(k, rot)[:, None]).sum(-1)
    b = (ref.apply_rotary_pos_emb(q, rcos, rsin)[:, :, None]
         * ref.apply_rotary_pos_emb(k, rcos, rsin)[:, None]).sum(-1)
    assert torch.allclose(a, b, atol=1e-5)


def test_the_cache_holds_latents_only():
    """576 values a token and layer at DeepSeek-V2-Lite's widths (the
    512-d latent and the 64-d rope key), never expanded keys and
    values; the LM's parameters in bf16 at the configured policy."""
    cfg = load_config("configs/mimic_dsv2lite.yaml")
    with torch.device("meta"):
        lm = LMDecoder(cfg).to(torch.bfloat16)
    cache = lm.new_cache(64, 128 + 89)
    assert tuple(cache.data.shape) == (27, 64, 217, 576)
    assert cache.data.dtype == torch.bfloat16
    n = sum(p.numel() for p in lm.parameters())
    proj = 1024 * 2048 + 2048 + 2048 * 2048 + 2048
    assert n - proj == 15_706_484_224     # DeepSeek-V2-Lite's 15.7 B
    assert cfg.decoder == "lm" and cfg.lm == LMConfig()
    assert cfg.speaker.seq_length == 90 and cfg.question.max_len == 20


def test_small_cache_in_a_decode():
    cfg, m = model()
    batch = synthetic_batch(cfg, B, seed=2)
    seen = []
    new = m.lm.new_cache

    def spy(b, n):
        c = new(b, n)
        seen.append(tuple(c.data.shape))
        return c

    m.lm.new_cache = spy
    m.decode(batch)
    L = 2 * cfg.data.num_nodes + 3 + cfg.question.max_len + 1
    assert seen == [(3, B, L + cfg.speaker.seq_length - 1, 40)]


def test_end_is_kept_and_early_exit_returns_the_whole_loop():
    """Row 0 picks EOS at step 0, the others at step 2: each row's EOS
    position and every later one read END, the EOS position keeps EOS's
    log-prob and later ones 0; the early exit stops the loop and
    returns what the whole loop returns. Where every logit is 0, id 0
    wins and is a token, not an end."""
    cfg, m = model()
    eos = cfg.lm.eos_token_id
    batch = synthetic_batch(cfg, B, seed=2)
    orig = m.lm.logits
    calls = []

    def logits(h):
        out = orig(h)
        if len(calls) == 0:
            out[0, eos] = 1e4
        if len(calls) == 2:
            out[1:, eos] = 1e4
        calls.append(1)
        return out

    m.lm.logits = logits
    early = m.decode(batch)
    n_early = len(calls)
    calls.clear()
    whole = m.decode(batch, early_exit=False)
    assert n_early < len(calls) == cfg.speaker.seq_length
    assert torch.equal(early["seq"], whole["seq"])
    assert torch.equal(early["logprobs"], whole["logprobs"])
    seq, lp = whole["seq"], whole["logprobs"]
    assert (seq[0] == END).all() and (seq[1:, 2:] == END).all()
    assert (seq[1:, :2] >= 0).all()
    assert (lp[0, 1:] == 0).all() and (lp[1:, 3:] == 0).all()
    assert float(lp[0, 0]) == pytest.approx(0.0, abs=1e-6)
    del m.lm.logits
    with torch.no_grad():
        m.lm.norm.weight.zero_()
    assert (m.decode(batch)["seq"] == 0).all()


def test_evaluate_end_to_end_with_spans_and_counters(tmp_path):
    cfg = small_cfg()
    tr = build_synthetic_trainer(cfg, str(tmp_path), n_pairs=160,
                                 device="cpu")
    obs.reset_recorded()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            scores, preds = tr.evaluate(max_batches=2)
        rec = obs.recorded()
    finally:
        obs.reset_recorded()
    T, Bt = cfg.speaker.seq_length, cfg.data.test.batch_size
    L = 2 * cfg.data.num_nodes + 3 + cfg.question.max_len + 1
    sp, cn = rec["spans"], rec["counts"]
    assert sp["ekaid.lm.connect"]["count"] == 2
    assert sp["ekaid.lm.prefill"]["count"] == 2
    assert sp["ekaid.lm.step"]["count"] == 2 * T
    assert cn["ekaid.lm.steps"] == 2 * T
    assert cn["ekaid.lm.prefill_tokens"] == 2 * Bt * L
    assert sp["ekaid.decode.sample"]["host_s"] >= \
        sp["ekaid.lm.prefill"]["host_s"]
    assert len(preds) == 2 * Bt and "Bleu_1" in scores
    # the answers are LM ids in words: w<i> past the dataset's vocabulary
    words = " ".join(preds.values()).split()
    assert len(words) == 2 * Bt * T
    assert any(int(w[1:]) >= cfg.speaker.vocab_size for w in words)


def test_refusals(tmp_path):
    cfg = small_cfg()
    tr = build_synthetic_trainer(cfg, str(tmp_path), n_pairs=160,
                                 device="cpu")
    batch = synthetic_batch(tr.cfg, 2, seed=0)
    for call in (tr.train, lambda: tr.snapshot_and_eval(1),
                 lambda: tr.evaluate(max_batches=1, beam_size=3),
                 lambda: tr.model(batch),
                 lambda: tr.model.decode(batch, sample_max=False),
                 lambda: tr.model.decode_beam(batch),
                 lambda: ptest.run_test(tr, str(tmp_path))):
        with pytest.raises(NotImplementedError, match="LM decoder"):
            call()
    assert tr.state is None
    assert tr.model.speaker is None and tr.model.decode_kernels() == ()
    for bad in ({"q_lora_rank": 1536}, {"topk_method": "noaux_tc"},
                {"rope_scaling": {"type": "linear"}}):
        with pytest.raises(ValueError):
            small_cfg(**bad)
    with pytest.raises(ValueError):
        merge_overrides(load_config(), {"decoder": "gpt"})


def test_speaker_path_keeps_its_six_encoder_outputs():
    cfg = load_config("configs/smoke.yaml")
    m = EkaidModel(cfg, ntoken=cfg.speaker.vocab_size - 1, device="cpu")
    enc = m.encode(synthetic_batch(cfg, 2, seed=0))
    assert set(enc) == {"pred", "att_bef", "att_aft", "feat_bef",
                        "feat_aft", "feat_diff"}
    assert m.lm is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch._grouped_mm's kernel and "
                    "the decode's pinned end flags run only there")
    return torch.device("cuda")


def test_grouped_experts_on_the_card(card):
    """The grouped products on the card (bf16, device offsets, no host
    read) against the per-expert loop on the same rows, at a decode
    step's 64 rows and a prefill's 8,192, DeepSeek-V2-Lite's widths:
    each product rounds once either way (two bf16 ulps of the scale)."""
    c = LMConfig()
    moe = dsv2.MoE(c).to(card, torch.bfloat16)
    g = torch.Generator(device=card).manual_seed(11)
    with torch.no_grad():
        for p in moe.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=card) * 0.02)
        for rows in (64, 8192):
            x = torch.randn(rows, c.hidden_size, generator=g, device=card,
                            dtype=torch.bfloat16)
            a = moe(x).float()
            b = moe(x, grouped=False).float()
            assert float((a - b).abs().max()) <= 2 * 2 ** -8 * float(
                b.abs().max())


def test_decode_on_the_card_matches_the_cpu(card):
    """A small LM decode in f32 on the card against the same on the CPU:
    the same tokens, log-probs within 1e-3 (TF32 off)."""
    cfg, m = model()
    batch = synthetic_batch(cfg, B, seed=1)
    want = m.decode(batch)
    m.to(card)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = m.decode(batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.equal(got["seq"].cpu(), want["seq"])
    assert float((got["logprobs"].cpu() - want["logprobs"]).abs().max()) \
        <= 1e-3
