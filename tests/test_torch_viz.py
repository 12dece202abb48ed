"""ekaid_torch's viz tools (`viz/draw.py`, `viz/ask.py`,
`viz/examples.py`): the port's versions of tests/test_scores.py's viz,
ask and examples tests at the same small config, and `ask_question`
against the JAX package's at f32 on the same weights and draws."""

import json

import jax
import numpy as np
import pytest
import torch
import yaml

from _torch_port import np_tree, port_cfg
from ekaid_tpu.config import default_config
from ekaid_tpu.train.train import build_synthetic_trainer as jax_trainer
from ekaid_tpu.viz.ask import ask_question as jax_ask
from ekaid_torch.convert import load_flax_params
from ekaid_torch.train.train import build_synthetic_trainer
from ekaid_torch.viz import ask, examples
from ekaid_torch.viz.draw import (draw_answer_distribution, draw_attention,
                                  draw_detections, draw_example_sheet,
                                  draw_module_weights, draw_pair)

N_SAMPLES = 16


def small_cfg(compute_dtype="bfloat16"):
    """tests/test_scores.py's ask config."""
    cfg = default_config()
    return cfg.replace(
        change_detector=cfg.change_detector.replace(
            att_dim=32, att_head=4, dim=8, pos_emb_dim=16),
        speaker=cfg.speaker.replace(
            input_dim=32, rnn_size=16, embed_input_dim=96, embed_dim=32,
            word_embed_size=8, seq_length=6),
        data=cfg.data.replace(num_nodes=6, feature_dim=24, adj_pad=10),
        question=cfg.question.replace(hidden_dim=32),
        dtypes=cfg.dtypes.replace(compute_dtype=compute_dtype))


def test_viz_panels_render(tmp_path):
    img = np.random.default_rng(0).random((32, 32))
    boxes = np.array([[2, 2, 12, 12], [15, 5, 28, 20]], np.float32)
    for fn, args in [
        (draw_detections, (img, boxes)),
        (draw_attention, (img, boxes, [0.9, 0.1])),
    ]:
        p = tmp_path / f"{fn.__name__}.png"
        fn(*args, save=str(p))
        assert p.stat().st_size > 1000
    p = tmp_path / "pair.png"
    draw_pair(img, img, "q?", "a", "gt", att_bef=[0.5, 0.5],
              boxes_bef=boxes, save=str(p))
    assert p.stat().st_size > 1000


def test_viz_sheet_and_module_weight_panels(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.random((32, 32))
    boxes = np.array([[2, 2, 12, 12]], np.float32)
    rows = [{"image_bef": img, "image_aft": img,
             "question": "what has changed?",
             "answer": "nothing has changed", "gt_answer": "nothing",
             "boxes_bef": boxes, "boxes_aft": boxes}
            for _ in range(2)]
    p = tmp_path / "sheet.png"
    draw_example_sheet(rows, save=str(p))
    assert p.stat().st_size > 1000

    w = rng.dirichlet([1, 1, 1], size=8)
    p = tmp_path / "mw.png"
    draw_module_weights(w, tokens=list("abcdefgh"), save=str(p))
    assert p.stat().st_size > 1000

    p = tmp_path / "dist.png"
    draw_answer_distribution({"yes": 20, "no": 8, "maybe": 1},
                             save=str(p))
    assert p.stat().st_size > 1000


def test_ask_question_synthetic(tmp_path):
    """A free-form question over a synthetic trainer: the multinomial
    answer histogram, the greedy answer and its module weights."""
    trainer = build_synthetic_trainer(port_cfg(small_cfg()), str(tmp_path),
                                      device="cpu")
    res = ask.ask_question(trainer, 0, "what has changed ?", n_samples=4,
                           seed=0)
    assert sum(res["counts"].values()) == 4
    assert isinstance(res["greedy"], str)
    assert isinstance(res["gt_answer"], str)
    mw = res["module_weights"]
    assert mw is not None and mw.shape[-1] == 3
    sums = mw.sum(-1)
    assert np.all((np.abs(sums - 1.0) < 1e-3) | (np.abs(sums) < 1e-6))
    assert (np.abs(sums - 1.0) < 1e-3).any()


@pytest.fixture(scope="module")
def paired(tmp_path_factory):
    """The JAX and the port synthetic trainers at f32 on one param set,
    the answer head's EOS bias raised so that answers vary in length."""
    cfg = small_cfg("float32")
    jtr = jax_trainer(cfg, str(tmp_path_factory.mktemp("jax")), n_pairs=16)
    params = jax.tree.map(lambda x: x, jtr.state.params)
    bias = params["params"]["speaker"]["logit"]["bias"]
    params["params"]["speaker"]["logit"]["bias"] = bias.at[0].add(2.0)
    jtr.state = jtr.state.replace(params=params)
    ptr = build_synthetic_trainer(port_cfg(cfg),
                                  str(tmp_path_factory.mktemp("port")),
                                  n_pairs=16, device="cpu")
    load_flax_params(ptr.model, np_tree(params))
    return cfg, jtr, ptr


@pytest.mark.parametrize("index,question", [
    (0, "what has changed ?"), (3, "w5 w9 w17 ?")])
def test_ask_question_matches_jax(paired, index, question):
    """Equal draws (the reference's key chain) give the same sampled
    answers, greedy answer and ground truth; module weights 1e-5."""
    cfg, jtr, ptr = paired
    want = jax_ask(jtr, index, question, n_samples=N_SAMPLES, seed=7)
    keys = jax.random.split(jax.random.PRNGKey(7), cfg.speaker.seq_length)
    draws = np.stack([np.asarray(jax.random.gumbel(
        k, (N_SAMPLES, cfg.speaker.vocab_size), np.float32)) for k in keys])
    got = ask.ask_question(ptr, index, question, n_samples=N_SAMPLES,
                           gumbel=torch.from_numpy(draws))
    for key in ("answers", "counts", "greedy", "gt_answer",
                "question_ids"):
        assert got[key] == want[key], key
    assert len(got["counts"]) > 1
    np.testing.assert_allclose(got["module_weights"],
                               np.asarray(want["module_weights"]),
                               atol=1e-5, rtol=0)


def test_find_examples_filters(tmp_path):
    gt = {"annotations": [
        {"id": "0", "image_id": "0", "caption": "nothing has changed",
         "question": "what has changed ?",
         "question_type": "difference"},
        {"id": "1", "image_id": "1", "caption": "yes",
         "question": "is there pneumonia ?",
         "question_type": "presence"},
        {"id": "2", "image_id": "2", "caption": "left lung",
         "question": "where is the effusion ?",
         "question_type": "location"},
    ], "images": [{"id": str(i)} for i in range(3)]}
    p = tmp_path / "gt.json"
    p.write_text(json.dumps(gt))

    rows = examples.find_examples(str(p), question_type="presence")
    assert [r["id"] for r in rows] == ["1"]
    rows = examples.find_examples(str(p), keyword="effusion")
    assert [r["id"] for r in rows] == ["2"]
    rows = examples.find_examples(str(p), n=2)
    assert len(rows) == 2

    img = np.random.default_rng(2).random((24, 24))
    out = tmp_path / "sheet.png"
    examples.render_sheet(rows, lambda i: (img, img), save=str(out))
    assert out.stat().st_size > 1000


def test_ask_and_examples_clis(tmp_path, monkeypatch, capsys):
    """`viz.ask.main` on the CPU writes its figure, and its counts sum to
    --n_samples; `viz.examples.main` prints the matching rows; the CUDA
    default raises without a card."""
    monkeypatch.chdir(tmp_path)
    cfg_path = tmp_path / "small.yaml"
    c = small_cfg("float32").to_dict()
    cfg_path.write_text(yaml.safe_dump({k: c[k] for k in (
        "change_detector", "speaker", "data", "question", "dtypes")}))
    png = tmp_path / "dist.png"
    res = ask.main(["--synthetic", "--device", "cpu", "--cfg",
                    str(cfg_path), "--question", "what has changed ?",
                    "--n_samples", "8", "--out", str(png)])
    assert sum(res["counts"].values()) == 8
    assert png.stat().st_size > 1000
    assert "greedy:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ask.main(["--synthetic", "--question", "what"])

    gt = tmp_path / "gt.json"
    gt.write_text(json.dumps({"annotations": [
        {"id": "4", "image_id": "4", "caption": "yes",
         "question": "is there edema ?", "question_type": "presence"}]}))
    examples.main(["--gt_json", str(gt), "--question_type", "presence"])
    assert "[4] (presence) Q: is there edema ?  A: yes" in \
        capsys.readouterr().out
