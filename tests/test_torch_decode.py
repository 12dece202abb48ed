"""ekaid_torch greedy decode against the JAX package, f32, smoke dims.

Both JAX decode paths are references: the XLA while_loop and the Pallas
kernel in interpret mode. Cases as tests/test_pallas_decode.py: plain,
a forced early exit, and the decoding constraint. Gates: seq token-exact,
logprobs atol 5e-5, module_weights atol 1e-5.
"""

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
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.models.greedy_decode import (greedy_decode,
                                              greedy_decode_plain)
from ekaid_torch.utils.dtypes import BF16, F32

CASES = ("plain", "early_exit", "constraint")
PATHS = ("xla", "pallas_interpret")


def _case(case):
    cfg = tiny_cfg()
    if case == "constraint":
        cfg = cfg.replace(speaker=cfg.speaker.replace(decoding_constraint=1))
    return cfg


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    batch = synthetic_batch(cfg, 4, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tree = init_flax(JaxModel(cfg, ntoken=NTOKEN, policy=JF32), jb,
                     train=True)
    exit_tree = jax.tree.map(np.copy, tree)
    exit_tree["params"]["speaker"]["logit"]["bias"][0] += 100.0
    trees = {"plain": tree, "early_exit": exit_tree, "constraint": tree}
    return batch, jb, trees, {}


def _jax_decode(setup, case, path):
    batch, jb, trees, cache = setup
    if (case, path) not in cache:
        cfg = _case(case)
        cfg = cfg.replace(speaker=cfg.speaker.replace(decode_kernel=path))
        out = JaxModel(cfg, ntoken=NTOKEN, policy=JF32).apply(
            jax.tree.map(jnp.asarray, trees[case]), jb, method="decode",
            sample_max=True)
        cache[(case, path)] = {k: np.asarray(v) for k, v in out.items()}
    return cache[(case, path)]


def _port_model(setup, case):
    _, _, trees, _ = setup
    model = EkaidModel(port_cfg(_case(case)), NTOKEN, device="cpu",
                       seed=None)
    return load_flax_params(model, trees[case])


def _assert_match(ref, out, case):
    seq = to_np(out["seq"])
    np.testing.assert_array_equal(seq, ref["seq"])
    np.testing.assert_allclose(to_np(out["logprobs"]), ref["logprobs"],
                               atol=5e-5, rtol=0)
    np.testing.assert_allclose(to_np(out["module_weights"]),
                               ref["module_weights"], atol=1e-5, rtol=0)
    if case == "early_exit":
        assert (seq[:, 1:] == 0).all() and (seq[:, 0] > 0).all()
        assert to_np(out["module_weights"])[:, 1:].sum() == 0.0
    if case == "constraint":
        live = seq[:, :-1] > 0
        assert not ((seq[:, 1:] == seq[:, :-1]) & live).any()


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", CASES)
def test_model_decode_matches_jax(setup, case, path):
    ref = _jax_decode(setup, case, path)
    out = _port_model(setup, case).decode(setup[0])
    _assert_match(ref, out, case)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", CASES)
def test_greedy_decode_plain_matches_jax(setup, case, path):
    """The plain loop alone, fed the reference encoder's features."""
    ref = _jax_decode(setup, case, path)
    speaker = _port_model(setup, case).speaker
    feats = {k: torch.tensor(ref[k])
             for k in ("feat_bef", "feat_aft", "feat_diff")}
    fused, stacked = speaker._fused(feats["feat_bef"], feats["feat_diff"],
                                    feats["feat_aft"])
    out = greedy_decode_plain(speaker.decode_weights(), speaker.cfg, F32,
                              fused, stacked)
    _assert_match(ref, out, case)


def test_cpu_decode_runs_the_plain_loop_and_counts_no_launch(setup):
    model = _port_model(setup, "plain")
    before = greedy_decode.launches
    model.decode(setup[0])
    assert greedy_decode.launches == before


@pytest.mark.parametrize("knob", [{"weight_quant": "int8"},
                                  {"fused_core": True}])
def test_decode_rejects_conflicting_knobs(setup, knob):
    cfg = tiny_cfg()
    cfg = cfg.replace(speaker=cfg.speaker.replace(**knob))
    model = EkaidModel(port_cfg(cfg), NTOKEN, device="cpu", seed=0)
    with pytest.raises(ValueError, match="weight_quant"):
        model.decode(setup[0])


def test_decode_weights_prepared_once_per_parameter_set(setup):
    speaker = _port_model(setup, "plain").speaker
    w = speaker.decode_weights()
    assert speaker.decode_weights() is w
    assert w["wih_x"].shape[0] == speaker.cfg.word_embed_size
    old = w["blogit"].clone()
    with torch.no_grad():
        speaker.logit.bias.add_(1.0)
    w2 = speaker.decode_weights()
    assert w2 is not w
    torch.testing.assert_close(w2["blogit"], old + 1.0)


def test_bf16_decode_is_finite(setup):
    cfg = port_cfg(tiny_cfg())
    model = EkaidModel(cfg, NTOKEN, policy=BF16, device="cpu", seed=0)
    out = model.decode(setup[0])
    assert out["seq"].dtype == torch.int32
    assert torch.isfinite(out["logprobs"]).all()
    assert torch.isfinite(out["module_weights"]).all()


def test_kernel_matches_plain_on_cuda(setup):
    """The CUDA kernel against its plain version, f32 (the card only;
    chip_smoke.py runs the same check at flagship width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _port_model(setup, "plain").to("cuda")
    enc = model.encode(setup[0])
    fused, feats = model.speaker._fused(enc["feat_bef"], enc["feat_diff"],
                                        enc["feat_aft"])
    w = model.speaker.decode_weights()
    ref = greedy_decode_plain(w, model.speaker.cfg, F32, fused, feats)
    out = greedy_decode(w, model.speaker.cfg, F32, fused, feats)
    _assert_match({k: to_np(v.cpu()) for k, v in ref.items()},
                  {k: v.cpu() for k, v in out.items()}, "plain")
