"""ekaid_torch Trainer on the CPU at tiny dims: steps and evals with their
files, an overfit run that reproduces its answers, an exact mid-epoch
resume, preemption, the CLI, and the device rule."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ekaid_torch.config import load_config
from ekaid_torch.data.pipeline import DiffVQADataset, SyntheticFeatureStore
from ekaid_torch.data.vocab import Vocabulary
from ekaid_torch.train import train as train_mod
from ekaid_torch.train.train import Trainer, build_synthetic_trainer

ROOT = Path(__file__).resolve().parent.parent


def _cfg(**train):
    """Narrower than configs/smoke.yaml (the preemption test's dims)."""
    cfg = load_config(str(ROOT / "configs" / "smoke.yaml"))
    return cfg.replace(
        change_detector=cfg.change_detector.replace(
            att_dim=32, att_head=4, dim=8, pos_emb_dim=16),
        speaker=cfg.speaker.replace(
            input_dim=32, rnn_size=16, embed_input_dim=96, embed_dim=32,
            word_embed_size=8, seq_length=8),
        data=cfg.data.replace(num_nodes=6, feature_dim=24, adj_pad=10,
                              num_workers=2),
        question=cfg.question.replace(hidden_dim=32),
        train=cfg.train.replace(**train))


def _params(trainer):
    return {n: p.detach().clone() for n, p in
            trainer.model.named_parameters()}


def test_steps_and_evals_write_their_files(tmp_path):
    cfg = _cfg(max_iter=4, snapshot_interval=2, log_interval=1)
    tr = build_synthetic_trainer(cfg, str(tmp_path), n_pairs=48,
                                 device="cpu")
    last = tr.train(eval_fraction=2)
    assert tr.state.step == 4
    assert set(last) >= {"total_loss", "speaker_loss", "att_reg",
                         "grad_norm", "iter_time"}
    assert all(np.isfinite(v) for v in last.values())
    rows = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "train/total_loss" in r] == \
        [1, 2, 3, 4]
    assert sum("eval/Bleu_1" in r for r in rows) == 2
    assert sorted(os.listdir(tmp_path / "eval_sents")) == [
        "eval_results_2.json", "eval_results_4.json"]
    assert tr.ckpt.steps() == [2, 4]
    assert "total parameters" in (tmp_path / "model_print").read_text()
    assert json.loads((tmp_path / "cfg.json").read_text())["speaker"][
        "vocab_size"] == tr.vocab.size
    # the image cache and the compact wire decode the same tokens
    s1, p1 = tr.evaluate(max_batches=2, use_cache=True)
    s2, p2 = tr.evaluate(max_batches=2, use_cache=False)
    assert p1 == p2 and s1 == s2 and len(p1) == len(tr.eval_ds) == 4
    assert tr._eval_cache.stats()["misses"] > 0
    # beam search decodes the same pairs from the wire batches
    s3, p3 = tr.evaluate(max_batches=2, beam_size=3)
    assert set(p3) == set(p1) and set(s3) == set(s1)


CORPUS = [
    ("is there any change", "yes"),
    ("is the heart normal", "no"),
    ("what abnormality is seen", "pleural effusion in the left lobe"),
    ("what has improved", "the edema has resolved"),
    ("where is the opacity", "right lower lung zone"),
    ("what is the main finding", "enlarged cardiac silhouette"),
    ("what disease is present", "atelectasis near the diaphragm"),
    ("what level of difference", "significant change"),
]


def _corpus(cfg, vocab, n_pairs=16):
    t, qmax = cfg.speaker.seq_length, cfg.question.max_len
    questions = np.zeros((n_pairs, qmax), np.int32)
    answers = np.zeros((n_pairs, t), np.int32)
    for i in range(n_pairs):
        q, a = CORPUS[i % len(CORPUS)]
        questions[i] = vocab.encode(q.split(), qmax)
        answers[i, 0] = 1                       # <start>
        answers[i, 1:] = vocab.encode(a.split(), t - 1)
    rng = np.random.default_rng(7)
    arrays = {"questions": questions, "answers": answers,
              "pos": (answers > 0).astype(np.int32),
              "feature_idx": rng.integers(0, 16, (n_pairs, 2))}
    return DiffVQADataset(cfg, SyntheticFeatureStore(cfg, n_images=16),
                          "all", arrays=arrays)


def test_overfit_tiny_corpus(tmp_path):
    """Dropout off, a fixed 8-mapping corpus: the teacher-forced loss goes
    to ~0, the greedy decode reproduces every answer, and the best
    checkpoint is the converged one. The decode primes with <start>
    (bos_token 1), the token every training row starts with; the default
    2 is the reference model's priming, which this corpus's vocab maps
    to a word."""
    vocab = Vocabulary.build([q.split() for q, _ in CORPUS]
                             + [a.split() for _, a in CORPUS])
    cfg = _cfg(max_iter=240, snapshot_interval=40, log_interval=40,
               optim=load_config().train.optim.replace(lr=1e-2,
                                                       step_size=10 ** 6))
    cfg = cfg.replace(
        speaker=cfg.speaker.replace(vocab_size=vocab.size, drop_prob_lm=0.0,
                                    bos_token=1),
        question=cfg.question.replace(dropout_att=0.0),
        data=cfg.data.replace(test=cfg.data.test.replace(batch_size=16),
                              train=cfg.data.train.replace(batch_size=16)))
    ds = _corpus(cfg, vocab)
    tr = Trainer(cfg, str(tmp_path), ds, ds, vocab, device="cpu")
    last = tr.train()
    assert last["speaker_loss"] < 0.05, last
    scores, predictions = tr.evaluate()
    assert scores["Bleu_1"] >= 0.95 and scores["acc_total"] >= 0.95, scores
    exact = sum(predictions[str(i)] == CORPUS[i % len(CORPUS)][1]
                for i in range(len(ds)))
    assert exact >= 0.9 * len(ds), predictions
    final = tr.snapshot_and_eval(tr.state.step)
    assert tr.best >= 0.95 and tr.best >= final["Bleu_1"] - 1e-9
    best = json.loads((tmp_path / "snapshots" / "best_metric.json")
                      .read_text())
    assert best["Bleu_1"] == tr.best and best["step"] > 40
    evals = [json.loads(line) for line in
             (tmp_path / "metrics.jsonl").read_text().splitlines()
             if "eval/Bleu_1" in line]
    assert evals[0]["eval/Bleu_1"] < tr.best
    losses = [json.loads(line)["train/speaker_loss"] for line in
              (tmp_path / "metrics.jsonl").read_text().splitlines()
              if "train/speaker_loss" in line]
    assert losses[-1] < losses[0]


def test_mid_epoch_resume_equals_uninterrupted_run(tmp_path):
    """Dropout and scheduled sampling on, 6 steps an epoch: a run stopped
    at step 4 and restored into a fresh trainer reaches step 8 with the
    uninterrupted run's parameters and optimizer state, bit for bit."""
    cfg = _cfg(max_iter=8, snapshot_interval=4, log_interval=100,
               scheduled_sampling_start=0,
               scheduled_sampling_increase_every=1,
               scheduled_sampling_increase_prob=0.25)
    full = build_synthetic_trainer(cfg, str(tmp_path / "a"), n_pairs=60,
                                   device="cpu")
    assert full.steps_per_epoch == 6
    full.train(eval_fraction=1)
    first = build_synthetic_trainer(
        cfg.replace(train=cfg.train.replace(max_iter=4)),
        str(tmp_path / "b"), n_pairs=60, device="cpu")
    first.train(eval_fraction=1)
    resumed = build_synthetic_trainer(cfg, str(tmp_path / "b"), n_pairs=60,
                                      device="cpu")
    assert not torch.equal(resumed.model.speaker.logit.kernel,
                           first.model.speaker.logit.kernel)
    resumed.ckpt.restore(resumed.state)
    assert resumed.state.step == 4 and resumed.state.opt.count == 4
    resumed.train(eval_fraction=1)
    want, got = _params(full), _params(resumed)
    for n in want:
        assert torch.equal(got[n], want[n]), n
    for k, slots in full.state.opt.slots.items():
        for a, b in zip(slots, resumed.state.opt.slots[k]):
            assert torch.equal(a, b)


def test_preemption_flag_checkpoints_and_returns(tmp_path):
    cfg = _cfg(max_iter=6, snapshot_interval=10 ** 6, log_interval=100)
    tr = build_synthetic_trainer(cfg, str(tmp_path), n_pairs=48,
                                 device="cpu")
    step = train_mod.train_step

    def stop_after_two(state, *a, **k):
        out = step(state, *a, **k)
        if state.step == 2:
            tr.stop_requested = True
        return out

    train_mod.train_step = stop_after_two
    try:
        tr.train()
    finally:
        train_mod.train_step = step
    assert tr.state.step == 2 and tr.ckpt.latest_step() == 2
    tr.stop_requested = False
    tr.train()
    assert tr.state.step == 6


def test_signal_handler_sets_the_flag_then_interrupts(tmp_path):
    tr = build_synthetic_trainer(_cfg(max_iter=1), str(tmp_path),
                                 n_pairs=16, device="cpu")
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        tr.install_preemption_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        assert tr.stop_requested
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def test_cli_runs_on_the_cpu(tmp_path):
    cmd = [sys.executable, "-m", "ekaid_torch.train.train", "--synthetic",
           "--device", "cpu", "--cfg", "configs/smoke.yaml", "--max_iter",
           "4", "--snapshot_interval", "2", "--eval_batches", "1",
           "--workdir", str(tmp_path), "data.num_workers", "1"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "eval @ 4" in proc.stdout
    for name in ("snapshots", "eval_sents", "model_print", "metrics.jsonl"):
        assert (tmp_path / name).exists(), name
    assert sorted(os.listdir(tmp_path / "snapshots"))[:2] == ["2.pt", "4.pt"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_trainer_and_main_need_a_card_unless_asked_for_the_cpu(tmp_path):
    cfg = _cfg(max_iter=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_synthetic_trainer(cfg, str(tmp_path), n_pairs=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.main(["--synthetic", "--cfg", "configs/smoke.yaml",
                        "--workdir", str(tmp_path)])


@pytest.mark.parametrize("axes,msg", [
    ({"model": 2}, "mesh.model=2: the port has no model axis"),
    ({"data": 2}, "mesh.data=2 but the data axis has 1")])
def test_trainer_refuses_a_mesh(tmp_path, axes, msg):
    """A model axis over 1 (the port has none) or a data axis that the
    process group does not have (one process here) raises."""
    cfg = _cfg(max_iter=1)
    cfg = cfg.replace(mesh=cfg.mesh.replace(**axes))
    with pytest.raises(ValueError, match=msg):
        build_synthetic_trainer(cfg, str(tmp_path), n_pairs=16, device="cpu")


def test_train_entry_point_refuses_a_model_axis(tmp_path):
    """`python -m ekaid_torch.train.train ... mesh.model 2` raises before
    any step or file of the run."""
    with pytest.raises(ValueError, match="mesh.model=2"):
        train_mod.main(["--synthetic", "--device", "cpu", "--cfg",
                        str(ROOT / "configs" / "smoke.yaml"), "--workdir",
                        str(tmp_path / "run"), "mesh.model", "2"])
    assert not (tmp_path / "run").exists()
