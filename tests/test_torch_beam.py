"""ekaid_torch beam search (`DynamicSpeaker.sample_beam`,
`EkaidModel.decode_beam`, `Trainer.evaluate(beam_size > 1)`) against the
JAX package's at f32 on the same weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import NTOKEN, init_flax, port_cfg, tiny_cfg, to_np
from ekaid_tpu.data.synthetic import synthetic_batch
from ekaid_tpu.models.ekaid import EkaidModel as JaxModel
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.convert import load_flax_params
from ekaid_torch.models.ekaid import EkaidModel

#: |logprob(port) - logprob(jax)| of the returned beams
LOGPROB_ATOL = 1e-5


def _cfg():
    cfg = tiny_cfg()
    return cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype="float32"))


@pytest.fixture(scope="module")
def models():
    cfg = _cfg()
    batch = synthetic_batch(cfg, 6, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flax = JaxModel(cfg, ntoken=NTOKEN, policy=JF32)
    tree = init_flax(flax, jb, train=False)
    port = load_flax_params(
        EkaidModel(port_cfg(cfg), NTOKEN, device="cpu", seed=None), tree)
    return cfg, flax, jax.tree.map(jnp.asarray, tree), port, batch, jb


@pytest.mark.parametrize("beam_size,group_size", [
    (2, 1), (3, 1), (5, 1), (2, 2), (4, 2), (6, 2)])
def test_sample_beam_matches_jax(models, beam_size, group_size):
    """Token-exact beams, every group's too, and logprobs within
    LOGPROB_ATOL, with a nonzero diversity penalty."""
    cfg, flax, tree, port, batch, jb = models
    kw = dict(beam_size=beam_size, group_size=group_size,
              diversity_lambda=0.5)
    want = flax.apply(tree, jb, method="decode_beam", **kw)
    got = port.decode_beam(batch, **kw)
    np.testing.assert_array_equal(to_np(got["seq"]), np.asarray(want["seq"]))
    np.testing.assert_array_equal(to_np(got["group_seqs"]),
                                  np.asarray(want["group_seqs"]))
    np.testing.assert_allclose(to_np(got["logprob"]),
                               np.asarray(want["logprob"]),
                               atol=LOGPROB_ATOL, rtol=0)
    np.testing.assert_allclose(to_np(got["group_logprobs"]),
                               np.asarray(want["group_logprobs"]),
                               atol=LOGPROB_ATOL, rtol=0)
    assert got["group_seqs"].shape == (6, group_size, cfg.speaker.seq_length)
    assert (got["seq"] > 0).any()


def test_sample_beam_with_decoding_constraint(models):
    """The previous-token ban applies to every beam of every group."""
    cfg, _, tree, _, batch, jb = models
    c2 = cfg.replace(speaker=cfg.speaker.replace(decoding_constraint=1))
    flax = JaxModel(c2, ntoken=NTOKEN, policy=JF32)
    port = load_flax_params(
        EkaidModel(port_cfg(c2), NTOKEN, device="cpu", seed=None),
        jax.tree.map(np.asarray, tree))
    kw = dict(beam_size=4, group_size=2, diversity_lambda=0.5)
    want = flax.apply(tree, jb, method="decode_beam", **kw)
    got = port.decode_beam(batch, **kw)
    np.testing.assert_array_equal(to_np(got["group_seqs"]),
                                  np.asarray(want["group_seqs"]))
    seqs = to_np(got["group_seqs"])
    live = seqs[..., 1:] > 0
    assert not (live & (seqs[..., 1:] == seqs[..., :-1])).any()


def test_beam_size_must_divide_into_groups(models):
    port, batch = models[3], models[4]
    with pytest.raises(ValueError, match="divisible"):
        port.decode_beam(batch, beam_size=3, group_size=2)


def test_trainer_beam_eval_matches_jax(tmp_path):
    """`Trainer.evaluate(beam_size=3)` of both packages on one reference
    checkpoint: the same answers and scores."""
    from _torch_trainers import paired_trainers
    jtr, ptr, _ = paired_trainers(tmp_path)
    w_scores, want = jtr.evaluate(beam_size=3)
    g_scores, got = ptr.evaluate(beam_size=3)
    assert got == want and len(got) == 8
    for k, v in w_scores.items():
        assert abs(g_scores[k] - v) <= 1e-9, k
    # beam search is a decode of its own: not the greedy answers
    assert got != ptr.evaluate()[1]
