"""ekaid_torch's eval driver (`train/test.py`) and score analysis
(`train/score.py`) against the JAX package's: the same predictions,
scores and results file from one reference checkpoint, the CLIs, and
each score function on the reference tests' fixtures."""

import json

import numpy as np
import pytest

from _torch_trainers import paired_trainers, small_cfg, STEP
from ekaid_tpu.train import score as jscore
from ekaid_tpu.train import test as jtest
from ekaid_torch.train import score as pscore
from ekaid_torch.train import test as ptest

SCORE_ATOL = 1e-9


@pytest.fixture(scope="module")
def driven(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("driver")
    jtr, ptr, snaps = paired_trainers(tmp)
    want = jtest.run_test(jtr, str(snaps), STEP, str(tmp / "jax.json"))
    got = ptest.run_test(ptr, str(snaps), STEP, str(tmp / "port.json"))
    return tmp, want, got


def test_run_test_matches_jax(driven):
    tmp, (w_scores, w_pred), (g_scores, g_pred) = driven
    assert g_pred == w_pred and len(g_pred) == 8
    assert set(g_scores) == set(w_scores)
    for k, v in w_scores.items():
        assert abs(g_scores[k] - v) <= SCORE_ATOL, k
    # answers end at varying lengths, as trained ones do
    assert len({len(s.split()) for s in g_pred.values()}) > 1


def test_results_file_equals_jax(driven):
    tmp = driven[0]
    assert (tmp / "port.json").read_text() == (tmp / "jax.json").read_text()


def test_cli_runs_synthetic(tmp_path, capsys):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("speaker:\n  seq_length: 6\n"
                   "data:\n  test:\n    batch_size: 4\n")
    ptest.main(["--synthetic", "--max_batches", "2", "--device", "cpu",
                "--cfg", str(cfg), "--workdir", str(tmp_path / "w"),
                "speaker.rnn_size", "16", "speaker.input_dim", "32",
                "speaker.embed_input_dim", "96", "speaker.embed_dim", "32",
                "speaker.word_embed_size", "8",
                "change_detector.att_dim", "32", "change_detector.dim", "8",
                "change_detector.pos_emb_dim", "16",
                "question.hidden_dim", "32", "data.num_nodes", "6",
                "data.feature_dim", "24", "data.adj_pad", "10"])
    out = capsys.readouterr().out
    assert "Test took" in out and "(8 pairs," in out and "Bleu_1:" in out
    rows = json.loads((tmp_path / "w" / "test_results_test.json")
                      .read_text())
    assert len(rows) == 8 and set(rows[0]) == {"caption", "image_id"}


def test_cli_raises_without_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptest.main(["--synthetic", "--workdir", str(tmp_path)])


# ---- score.py, on the fixtures of tests/test_scores.py -----------------

GT = {"annotations": [
    {"image_id": "0", "caption": "yes", "question": "is there x?",
     "question_type": "presence"},
    {"image_id": "1", "caption": "no", "question": "is there y?",
     "question_type": "presence"},
    {"image_id": "2", "caption": "left lung", "question": "where is x?",
     "question_type": "location"},
    {"image_id": "3", "caption": "the main image has an additional "
     "finding of edema than the reference image.",
     "question": "what has changed compared to the reference image?",
     "question_type": "difference"},
]}
RES = [{"image_id": "0", "caption": "yes"},
       {"image_id": "1", "caption": "yes"},
       {"image_id": "2", "caption": "left lung"},
       {"image_id": "3", "caption": "anything"}]
DISEASES = ["edema", "effusion", "atelectasis"]
Q = pscore.ABNORMALITY_QUESTION
ABN_GT = {"annotations": [
    {"image_id": "0", "question": Q, "caption": "edema, effusion"},
    {"image_id": "1", "question": Q, "caption": "edema"},
    {"image_id": "2", "question": Q, "caption": "atelectasis"},
    {"image_id": "3", "question": "other", "caption": "edema"}]}
ABN_RES = [{"image_id": "0", "caption": "edema"},
           {"image_id": "1", "caption": "effusion"},
           {"image_id": "2", "caption": "atelectasis"},
           {"image_id": "3", "caption": "edema"}]


def test_accuracy_matches_jax():
    assert pscore.accuracy(GT, RES) == jscore.accuracy(GT, RES)


@pytest.mark.parametrize("qtype", ["presence", "location", "none"])
def test_metrics_by_question_type_matches_jax(qtype):
    got = pscore.metrics_by_question_type(GT, RES, qtype)
    want = jscore.metrics_by_question_type(GT, RES, qtype)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= SCORE_ATOL, k


def test_question_types_from_csv_match_jax(tmp_path):
    csv = tmp_path / "q.csv"
    csv.write_text("question_type\npresence\nlocation\npresence\n"
                   "difference\n")
    assert pscore._question_types(GT, str(csv)) == \
        jscore._question_types(GT, str(csv))


def _abn(n, k, seed, p_true=0.4, p_pred=0.5):
    """n abnormality questions over k diseases, answers drawn from a
    seed: ground truth and predictions as finding lists."""
    rng = np.random.default_rng(seed)
    names = [f"d{i}" for i in range(k)]
    g = rng.random((n, k)) < p_true
    p = rng.random((n, k)) < p_pred
    gt = {"annotations": [{"image_id": str(i), "question": Q,
                           "caption": ", ".join(np.array(names)[g[i]])}
                          for i in range(n)]}
    res = [{"image_id": str(i), "caption": ",".join(np.array(names)[p[i]])}
           for i in range(n)]
    return gt, res, names


@pytest.mark.parametrize("case", ["fixture", "ties", "one_class",
                                  "none_kept"])
def test_per_abnormality_matches_sklearn_reference(case, capsys):
    """Per-disease accuracy and the macro ROC-AUC against the reference,
    whose AUC is sklearn's: binary predictions (every score is tied with
    many others); a kept column whose every row is positive, whose AUC
    sklearn gives as nan; and no positive finding at all, where no column
    is kept and no auc_mean is returned."""
    if case == "fixture":
        gt, res, names = ABN_GT, ABN_RES, DISEASES
    elif case == "ties":
        gt, res, names = _abn(40, 5, seed=0)
    elif case == "one_class":
        gt, res, names = _abn(12, 3, seed=1)
        for a in gt["annotations"]:
            a["caption"] = "d0, " + a["caption"]
    else:
        gt, res, names = _abn(12, 3, seed=1, p_true=0.0)
    want = jscore.per_abnormality(gt, res, names)
    want_out = capsys.readouterr().out
    got = pscore.per_abnormality(gt, res, names)
    got_out = capsys.readouterr().out
    assert got.keys() == want.keys()
    for k in want:
        assert np.isclose(got[k], want[k], rtol=0, atol=1e-12,
                          equal_nan=True), k
    assert ("auc_mean" in got) == (case != "none_kept")
    assert np.isnan(got.get("auc_mean", 0.0)) == (case == "one_class")
    assert ("auc unavailable" in got_out) == ("auc unavailable" in want_out)


def test_roc_auc_equals_sklearn_on_scores_with_ties():
    from sklearn.metrics import roc_auc_score
    rng = np.random.default_rng(2)
    y = (rng.random((50, 4)) < 0.3).astype(int)
    y[0] = 1
    y[1] = 0
    s = np.round(rng.random((50, 4)) * 4) / 4          # five levels: ties
    np.testing.assert_allclose(pscore.roc_auc(y, s),
                               roc_auc_score(y, s, average=None),
                               rtol=0, atol=1e-12)


def _eval_dir(tmp_path):
    for step, caps in ((2, ["no", "no", "x", "y"]),
                       (4, ["yes", "no", "left lung", "y"]),
                       (6, ["yes", "yes", "left lung", "y"])):
        (tmp_path / f"eval_results_{step}.json").write_text(json.dumps(
            [{"image_id": str(i), "caption": c}
             for i, c in enumerate(caps)]))
    (tmp_path / "notes.txt").write_text("skipped")
    gt = tmp_path / "gt.json"
    gt.write_text(json.dumps(GT))
    return gt


@pytest.mark.parametrize("by", ["accuracy", "bleu"])
def test_find_best_checkpoint_matches_jax(tmp_path, by):
    gt = _eval_dir(tmp_path)
    got = pscore.find_best_checkpoint(str(tmp_path), str(gt), by=by)
    assert got == jscore.find_best_checkpoint(str(tmp_path), str(gt), by=by)
    assert got[0] == 4


@pytest.mark.parametrize("flags", [["-a"], ["-t", "presence"],
                                   ["-t", "location", "--question_csv"],
                                   ["--sweep"], ["--sweep", "--sweep_by",
                                                 "bleu"], []])
def test_score_main_matches_jax(tmp_path, capsys, flags):
    gt = _eval_dir(tmp_path)
    if "--question_csv" in flags:
        csv = tmp_path / "q.csv"
        csv.write_text("question_type\nlocation\nlocation\npresence\n"
                       "difference\n")
        flags = flags + [str(csv)]
    target = (str(tmp_path) if "--sweep" in flags
              else str(tmp_path / "eval_results_4.json"))
    argv = ["-d", target, "-g", str(gt)] + flags
    jscore.main(argv)
    want = capsys.readouterr().out
    pscore.main(argv)
    assert capsys.readouterr().out == want
