"""ekaid_torch multinomial decode (`DynamicSpeaker.sample(sample_max=
False)`, `EkaidModel.decode`) against the JAX package's at f32 on the same
weights, inputs and Gumbel draws.

The reference draws `jax.random.categorical(keys[t], logp / temp)` with
`keys = split(rng, T)`, which is argmax(gumbel(keys[t], (B, V), f32) +
logp / temp); the port takes those draws as its `gumbel` argument."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import NTOKEN, init_flax, port_cfg, tiny_cfg, to_np
from ekaid_tpu.data.synthetic import synthetic_batch
from ekaid_tpu.models.ekaid import EkaidModel as JaxModel
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.convert import load_flax_params
from ekaid_torch.models.decoder import gumbel_draws
from ekaid_torch.models.ekaid import EkaidModel

TOL = 1e-5
B = 6
#: added to the EOS logit's bias, so that rows end at different steps
EOS_BIAS = 3.0


def _cfg(constraint=0):
    cfg = tiny_cfg()
    return cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype="float32"),
                       speaker=cfg.speaker.replace(
                           decoding_constraint=constraint))


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    batch = synthetic_batch(cfg, B, seed=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tree = init_flax(JaxModel(cfg, ntoken=NTOKEN, policy=JF32), jb,
                     train=False)
    tree["params"]["speaker"]["logit"]["bias"] = (
        tree["params"]["speaker"]["logit"]["bias"]
        + np.eye(cfg.speaker.vocab_size, dtype=np.float32)[0] * EOS_BIAS)
    return tree, batch, jb


def jax_draws(key, T, V):
    """The draws of the reference's decode: one key a step."""
    keys = jax.random.split(key, T)
    return np.stack([np.asarray(jax.random.gumbel(keys[t], (B, V),
                                                  jnp.float32))
                     for t in range(T)])


def _pair(setup, constraint):
    tree, batch, jb = setup
    cfg = _cfg(constraint)
    flax = JaxModel(cfg, ntoken=NTOKEN, policy=JF32)
    port = load_flax_params(
        EkaidModel(port_cfg(cfg), NTOKEN, device="cpu", seed=None), tree)
    return cfg, flax, jax.tree.map(jnp.asarray, tree), port, batch, jb


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("constraint", [0, 1])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_multinomial_matches_jax(setup, temperature, constraint,
                                 early_exit):
    """Tokens exact; logprobs and module weights within TOL."""
    cfg, flax, tree, port, batch, jb = _pair(setup, constraint)
    key = jax.random.PRNGKey(11)
    want = flax.apply(tree, jb, method="decode", sample_max=False,
                      temperature=temperature, rng=key,
                      early_exit=early_exit)
    draws = jax_draws(key, cfg.speaker.seq_length, cfg.speaker.vocab_size)
    got = port.decode(batch, sample_max=False, temperature=temperature,
                      gumbel=torch.from_numpy(draws), early_exit=early_exit)
    seq = to_np(got["seq"])
    np.testing.assert_array_equal(seq, np.asarray(want["seq"]))
    np.testing.assert_allclose(to_np(got["logprobs"]),
                               np.asarray(want["logprobs"]), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(to_np(got["module_weights"]),
                               np.asarray(want["module_weights"]),
                               atol=TOL, rtol=0)
    ended = (seq == 0).any(1)
    assert ended.any() and not ended.all()  # rows end at different steps
    assert (seq[:, 0] > 0).all()            # NULL banned at step 0
    if constraint:
        live = seq[:, 1:] > 0
        assert not (live & (seq[:, 1:] == seq[:, :-1])).any()


def test_early_exit_equals_full_loop(setup):
    """The early exit gives the full loop's tokens and module weights,
    and its logprobs at every step it ran; the full loop also holds a
    logprob at the steps after the last row ended."""
    cfg, _, _, port, batch, _ = _pair(setup, 0)
    with torch.no_grad():                  # every row ends before T
        port.speaker.logit.bias[0] += EOS_BIAS
    gen = torch.Generator().manual_seed(3)
    draws = gumbel_draws((cfg.speaker.seq_length, B,
                          cfg.speaker.vocab_size), gen)
    a = port.decode(batch, sample_max=False, gumbel=draws, early_exit=True)
    b = port.decode(batch, sample_max=False, gumbel=draws, early_exit=False)
    seq = to_np(a["seq"])
    np.testing.assert_array_equal(seq, to_np(b["seq"]))
    np.testing.assert_array_equal(to_np(a["module_weights"]),
                                  to_np(b["module_weights"]))
    ran = int((seq > 0).any(0).sum()) + 1       # the last row's EOS step
    assert ran < cfg.speaker.seq_length
    np.testing.assert_array_equal(to_np(a["logprobs"])[:, :ran],
                                  to_np(b["logprobs"])[:, :ran])
    assert (to_np(a["logprobs"])[:, ran:] == 0).all()


def test_draws_from_a_generator(setup):
    """Without draws the decode takes them from `gen` (finite, no
    log(0)); the same seed gives the same answers, another seed others;
    with neither it raises."""
    cfg, _, _, port, batch, _ = _pair(setup, 0)
    d = gumbel_draws((4096,), torch.Generator().manual_seed(0))
    assert torch.isfinite(d).all()
    assert abs(float(d.mean()) - 0.5772) < 0.05   # Euler-Mascheroni
    runs = [to_np(port.decode(batch, sample_max=False,
                              gen=torch.Generator().manual_seed(s))["seq"])
            for s in (1, 1, 2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="draws"):
        port.decode(batch, sample_max=False)


def test_banned_tokens_stay_banned_under_any_draw(setup):
    """An added -inf stays -inf: with huge draws on the banned tokens
    (NULL at step 0, the previous token under the constraint) neither is
    ever drawn."""
    cfg, _, _, port, batch, _ = _pair(setup, 1)
    T, V = cfg.speaker.seq_length, cfg.speaker.vocab_size
    draws = torch.zeros(T, B, V)
    draws[0, :, 0] = 1e30
    first = to_np(port.decode(batch, sample_max=False, gumbel=draws)["seq"])
    assert (first[:, 0] > 0).all()
    draws = torch.zeros(T, B, V)
    draws[1:, torch.arange(B), torch.from_numpy(first[:, 0]).long()] = 1e30
    again = to_np(port.decode(batch, sample_max=False, gumbel=draws)["seq"])
    np.testing.assert_array_equal(again[:, 0], first[:, 0])
    assert (again[:, 1] != again[:, 0]).all()


#: the reference's mid dims (tests/test_model.py), at which every large
#: core matrix crosses QUANT_MIN_ELEMS and is stored int8
MID_SPEAKER = dict(input_dim=256, rnn_size=128, embed_dim=256,
                   embed_input_dim=768)
#: int8 decodes against the reference's: logprobs on the equal prefix
QUANT_LP_TOL = 1e-4


def test_int8_multinomial_matches_jax():
    """weight_quant='int8' reaches the multinomial decode: at the mid
    dims the port's tokens equal the reference's on its Gumbel draws,
    and the logprobs agree within QUANT_LP_TOL (an unquantized step
    misses them by the int8 rounding, ~1e-3)."""
    from ekaid_tpu.models.decoder import DynamicSpeaker as JaxSpeaker
    from ekaid_torch.models.decoder import DynamicSpeaker

    cfg = tiny_cfg()
    cfg = cfg.replace(speaker=cfg.speaker.replace(
        weight_quant="int8", decode_kernel="xla", **MID_SPEAKER))
    sp = cfg.speaker
    rng = np.random.default_rng(21)
    fb, fa, fd = (rng.standard_normal((B, sp.input_dim)).astype(np.float32)
                  for _ in range(3))
    flax = JaxSpeaker(sp, policy=JF32)
    tree = init_flax(flax, *map(jnp.asarray, (fb, fa, fd)),
                     sample_max=True, method="sample")
    key = jax.random.PRNGKey(4)
    want = flax.apply(jax.tree.map(jnp.asarray, tree),
                      *map(jnp.asarray, (fb, fa, fd)), sample_max=False,
                      rng=key, method="sample")
    port = load_flax_params(DynamicSpeaker(port_cfg(cfg).speaker), tree)
    draws = jax_draws(key, sp.seq_length, sp.vocab_size)
    got = port.sample(*map(torch.from_numpy, (fb, fa, fd)),
                      sample_max=False, gumbel=torch.from_numpy(draws))
    np.testing.assert_array_equal(to_np(got["seq"]), np.asarray(want["seq"]))
    np.testing.assert_allclose(to_np(got["logprobs"]),
                               np.asarray(want["logprobs"]),
                               atol=QUANT_LP_TOL, rtol=0)
