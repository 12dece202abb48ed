"""ekaid_torch full model at flagship width, the batch-1 engine, the config
copy and the device rule, against the JAX package."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import NTOKEN, init_flax, port_cfg, tiny_cfg, to_np
from ekaid_tpu.config import default_config, load_config as jax_load_config
from ekaid_tpu.data.pipeline import compact_wire, synthetic_dataset
from ekaid_tpu.data.synthetic import synthetic_batch
from ekaid_tpu.models.ekaid import EkaidModel as JaxModel
from ekaid_tpu.train.train import identity_vocab as jax_identity_vocab
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.config import LMConfig, load_config
from ekaid_torch.convert import load_flax_params
from ekaid_torch.data.vocab import identity_vocab, treebank_tokenize
from ekaid_torch.data.vocab import Vocabulary
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.serving import engine as engine_mod
from ekaid_torch.serving.engine import InferenceEngine
from ekaid_torch.train.train import build_synthetic_trainer

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_flagship_width_decode_matches_jax():
    """Default (flagship) widths, seq_length 6, B=2, f32: seq exact,
    logprobs atol 1e-4. The seed's greedy choices are clear of ties (the
    top-2 logit gap exceeds 1e-4 at every step)."""
    cfg = default_config()
    cfg = cfg.replace(speaker=cfg.speaker.replace(seq_length=6))
    batch = synthetic_batch(cfg, 2, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flax = JaxModel(cfg, ntoken=NTOKEN, policy=JF32)
    tree = init_flax(flax, jb, train=False)
    want = flax.apply(_jax_tree(tree), jb, method="decode", sample_max=True)
    port = EkaidModel(port_cfg(cfg), NTOKEN, device="cpu", seed=None)
    got = load_flax_params(port, tree).decode(batch)
    np.testing.assert_array_equal(to_np(got["seq"]), np.asarray(want["seq"]))
    np.testing.assert_allclose(to_np(got["logprobs"]),
                               np.asarray(want["logprobs"]), atol=1e-4,
                               rtol=0)


@pytest.fixture(scope="module")
def engine_setup(tmp_path_factory):
    """A tiny f32 synthetic trainer behind the port's engine, its model
    holding the reference params."""
    cfg = tiny_cfg()
    cfg = cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype="float32"))
    jb = {k: jnp.asarray(v) for k, v in synthetic_batch(cfg, 2).items()}
    flax = JaxModel(cfg, ntoken=NTOKEN, policy=JF32)
    tree = init_flax(flax, jb, train=False)
    trainer = build_synthetic_trainer(
        port_cfg(cfg), str(tmp_path_factory.mktemp("engine")), device="cpu")
    load_flax_params(trainer.model, tree)
    engine = InferenceEngine(trainer)
    return cfg, flax, _jax_tree(tree), engine


def test_pair_store_equals_jax_synthetic_dataset(engine_setup):
    cfg, _, _, engine = engine_setup
    ds = synthetic_dataset(cfg, "test")
    np.testing.assert_array_equal(engine.ds.split_idxs, ds.split_idxs)
    np.testing.assert_array_equal(engine.ds.questions, ds.questions)
    for idx in ds.split_idxs[:2]:
        want, got = ds.sample(int(idx)), engine.ds.sample(int(idx))
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("text", ["w5 w9, w12?", None])
def test_engine_answer_matches_jax_decode(engine_setup, text):
    cfg, flax, tree, engine = engine_setup
    idx = int(engine.ds.split_idxs[1])
    res = engine.answer(text, idx, detail=True)
    sample = {k: v[None] for k, v in
              compact_wire(engine.ds.sample(idx)).items()
              if k != "pair_index"}
    if text is not None:
        sample["question"] = engine.question_to_ids(text).astype(
            np.int32)[None]
        assert res["question_tokens"] == [5, 9, 12]
    out = flax.apply(tree, {k: jnp.asarray(v) for k, v in sample.items()},
                     method="decode", sample_max=True)
    seq = np.asarray(out["seq"])[0]
    vocab = jax_identity_vocab(cfg.speaker.vocab_size)
    assert res["answer"] == vocab.decode(seq)
    n = len(res["tokens"])
    assert res["tokens"] == [vocab.idx_to_word[int(i)] for i in seq[:n]]
    np.testing.assert_allclose(res["module_weights"],
                               np.asarray(out["module_weights"])[0, :n],
                               atol=1e-4)


def test_engine_caches_each_pair_once(engine_setup):
    engine = engine_setup[3]
    idx = int(engine.ds.split_idxs[2])
    first = engine._dev_sample(idx)
    assert engine._dev_sample(idx) is first
    assert first["d_feats"].dtype == torch.float16
    assert first["d_adj"].dtype == torch.int8


def test_engine_main_prints_one_json_line_per_question(capsys, tmp_path):
    engine_mod.main(["--cfg", str(CONFIGS / "smoke.yaml"), "--n", "2",
                     "--device", "cpu", "--workdir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    for line in lines:
        rec = json.loads(line)
        assert {"question", "answer", "index", "tokens"} <= set(rec)


def test_vocab_matches_jax():
    want, got = jax_identity_vocab(148), identity_vocab(148)
    assert got.word_to_idx == want.word_to_idx and got.size == want.size
    assert got.decode([5, 7, 0, 9]) == want.decode([5, 7, 0, 9])
    assert treebank_tokenize("Is there a change? It's 2.5cm-wide.") == [
        "is", "there", "a", "change", "?", "it", "'s", "2.5", "cm-wide", "."]
    assert Vocabulary({"a": 1}).decode([1, 3]) == "a <unk>"


@pytest.mark.parametrize("name", ["smoke.yaml", "mimic.yaml"])
def test_config_copy_loads_reference_yaml(name):
    got = load_config(str(CONFIGS / name)).to_dict()
    want = jax_load_config(str(CONFIGS / name)).to_dict()
    # the port's own sections, which the reference has not: the answer
    # decoder's switch and the LM decoder's section, at their defaults
    extra = {k: got.pop(k) for k in ("decoder", "lm")}
    assert got == want
    assert extra == {"decoder": "speaker",
                     "lm": dataclasses.asdict(LMConfig())}


def test_entry_points_raise_without_cuda(tmp_path):
    """Nothing falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = port_cfg(tiny_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EkaidModel(cfg, NTOKEN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine_mod.main(["--cfg", str(CONFIGS / "smoke.yaml"),
                         "--workdir", str(tmp_path)])
