"""Post-hoc score analysis (counterpart of `ekaid_tpu/train/score.py`,
`ekaid-score`).

  * `accuracy`: exact-string answer accuracy, total / open / closed,
    skipping 'what has changed' questions; closed means a yes/no answer
    (`Trainer.evaluate` calls it too).
  * `metrics_by_question_type`: the caption metrics over the results of
    one question type, the type from the ground-truth annotations or a
    question CSV (pandas, imported only then).
  * `per_abnormality`: per-disease accuracy and the macro ROC-AUC over
    the "what abnormalities are seen in this image?" answers.
  * `find_best_checkpoint`: the best eval_results_<step>.json of a
    directory, by accuracy or by Bleu_1.

    python -m ekaid_torch.train.score -d results.json -g gt.json -a
    python -m ekaid_torch.train.score -d eval_sents -g gt.json --sweep

The ROC-AUC is the port's own, in the rank (Mann-Whitney) form with
average ranks for ties, which is what `sklearn.metrics.roc_auc_score`
computes on binary columns; sklearn is not needed. As sklearn 1.9 does, a
column that holds one class only has an AUC of nan, with a warning (so
`auc_mean` is nan), and with no column kept there is no AUC and no
`auc_mean`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ekaid_torch.metrics.coco import (CaptionEvaluator, CocoCaptions,
                                      evaluate_files)


def _load(path_or_obj):
    if isinstance(path_or_obj, str):
        with open(path_or_obj) as f:
            return json.load(f)
    return path_or_obj


def accuracy(gt_file, results_file, verbose: bool = True
             ) -> Tuple[float, float, float]:
    """Exact-match answer accuracy (total, open, closed), matching
    results to ground truth by image_id; 'what has changed' questions are
    skipped, and closed questions are those answered yes or no."""
    gt = _load(gt_file)["annotations"]
    pr = _load(results_file)
    pr_by_id = {str(r["image_id"]): r["caption"] for r in pr}

    totals = np.zeros(3)      # total, open, closed counts
    correct = np.zeros(3)
    for ann in gt:
        img = str(ann["image_id"])
        if img not in pr_by_id:
            continue
        if "what has changed" in ann.get("question", ""):
            continue
        gt_ans = ann["caption"]
        pr_ans = pr_by_id[img]
        closed = gt_ans in ("yes", "no")
        totals[0] += 1
        totals[2 if closed else 1] += 1
        if gt_ans == pr_ans:
            correct[0] += 1
            correct[2 if closed else 1] += 1
    with np.errstate(invalid="ignore"):
        out = np.where(totals > 0, correct / np.maximum(totals, 1), 0.0)
    if verbose:
        print("total", out[0])
        print("open", out[1])
        print("closed", out[2])
    return float(out[0]), float(out[1]), float(out[2])


def _question_types(gt_annotations, question_csv: Optional[str] = None
                    ) -> Dict[str, str]:
    """image_id -> question_type, from the ground truth or the CSV (row
    i is image_id i)."""
    if question_csv:
        import pandas as pd
        df = pd.read_csv(question_csv)
        return {str(i): df.iloc[i]["question_type"]
                for i in range(len(df))}
    types = {}
    for a in gt_annotations["annotations"]:
        if "question_type" in a:
            types[str(a["image_id"])] = a["question_type"]
    return types


def metrics_by_question_type(gt_file, results_file, target_type: str,
                             question_csv: Optional[str] = None
                             ) -> Dict[str, float]:
    """The caption metrics over the results of one question type."""
    gt = _load(gt_file)
    results = _load(results_file)
    types = _question_types(gt, question_csv)
    subset = [r for r in results
              if types.get(str(r["image_id"])) == target_type]
    if not subset:
        print(f"no results of type {target_type!r}")
        return {}
    coco = CocoCaptions(annotations=gt)
    scores = CaptionEvaluator(coco, coco.load_res(subset)).evaluate()
    for k, v in scores.items():
        print(f"{k}: {v:.3f}")
    return scores


ABNORMALITY_QUESTION = "what abnormalities are seen in this image?"


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> np.ndarray:
    """ROC-AUC of each column of binary labels `y_true` [n, k] under the
    scores `y_score` [n, k]: the Mann-Whitney U of the positives' average
    ranks over n_pos * n_neg; nan, with a warning, for a column with one
    class only. Raises ValueError when there is no column."""
    import warnings
    from scipy.stats import rankdata
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score, np.float64)
    if y_true.ndim != 2 or y_true.shape[1] == 0:
        raise ValueError(f"no label column to score (shape "
                         f"{y_true.shape})")
    out = np.empty(y_true.shape[1])
    for j in range(y_true.shape[1]):
        pos = y_true[:, j] == 1
        n_pos, n_neg = int(pos.sum()), int((~pos).sum())
        if n_pos == 0 or n_neg == 0:
            warnings.warn("Only one class is present in y_true. ROC AUC "
                          "score is not defined in that case.")
            out[j] = np.nan
            continue
        ranks = rankdata(y_score[:, j])               # ties: average rank
        out[j] = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos
                                                                * n_neg)
    return out


def per_abnormality(gt_file, results_file, disease_names: List[str]
                    ) -> Dict[str, float]:
    """Per-disease accuracy and the macro ROC-AUC over the abnormality
    questions. Answers are comma-separated finding lists; a finding
    counts when it is exactly a disease name."""
    gt = _load(gt_file)["annotations"]
    pr_by_id = {str(r["image_id"]): r["caption"]
                for r in _load(results_file)}
    d2i = {d: i for i, d in enumerate(disease_names)}
    preds, gts = [], []
    for ann in gt:
        img = str(ann["image_id"])
        if ann.get("question") != ABNORMALITY_QUESTION or \
                img not in pr_by_id:
            continue
        g = np.zeros(len(disease_names))
        p = np.zeros(len(disease_names))
        for dis in str(ann["caption"]).split(","):
            if dis.strip() in d2i:
                g[d2i[dis.strip()]] = 1
        for dis in pr_by_id[img].split(","):
            if dis.strip() in d2i:
                p[d2i[dis.strip()]] = 1
        gts.append(g)
        preds.append(p)
    if not gts:
        print("no abnormality questions found")
        return {}
    gts_a = np.asarray(gts)
    preds_a = np.asarray(preds)
    out = {}
    for i, name in enumerate(disease_names):
        n = gts_a[:, i].sum()
        if n > 0:
            acc = float(((gts_a[:, i] == 1)
                         & (preds_a[:, i] == 1)).sum() / n)
            out[name] = acc
            print(name, acc)
    keep = gts_a.sum(0) > 0
    try:
        auc = roc_auc(gts_a[:, keep], preds_a[:, keep])
        out["auc_mean"] = float(np.mean(auc))
        print("auc", auc)
    except ValueError as e:
        print("auc unavailable:", e)
    return out


def find_best_checkpoint(eval_dir: str, gt_file: str,
                         by: str = "accuracy") -> Tuple[int, float]:
    """The best eval_results_<step>.json in `eval_dir`, by total
    accuracy or by Bleu_1: (step, score); (-1, 0.0) when none scores
    above 0."""
    best, best_step = 0.0, -1
    for fname in sorted(os.listdir(eval_dir)):
        m = re.match(r"eval_results_(\d+)\.json$", fname)
        if not m:
            continue
        path = os.path.join(eval_dir, fname)
        if by == "accuracy":
            score, _, _ = accuracy(gt_file, path)
        else:
            coco = CocoCaptions(gt_file)
            score = CaptionEvaluator(coco, coco.load_res(path)
                                     ).evaluate()["Bleu_1"]
        if score > best:
            best, best_step = score, int(m.group(1))
    print("final", best_step, best)
    return best_step, best


def main(argv=None):
    p = argparse.ArgumentParser(description="ekaid_torch score analysis")
    p.add_argument("-d", "--eval_dir", required=True,
                   help="a results json, or a directory of "
                        "eval_results_*.json with --sweep")
    p.add_argument("-g", "--gt", required=True, help="GT captions json")
    p.add_argument("-a", "--acc", action="store_true")
    p.add_argument("-t", "--target_type", default="",
                   help="question type filter for the caption metrics")
    p.add_argument("--question_csv", default=None)
    p.add_argument("--sweep", action="store_true",
                   help="best-checkpoint sweep over a directory")
    p.add_argument("--sweep_by", default="accuracy",
                   choices=["accuracy", "bleu"])
    a = p.parse_args(argv)
    if a.sweep:
        return find_best_checkpoint(a.eval_dir, a.gt, by=a.sweep_by)
    if a.acc:
        return accuracy(a.gt, a.eval_dir)
    if a.target_type:
        return metrics_by_question_type(a.gt, a.eval_dir, a.target_type,
                                        a.question_csv)
    return evaluate_files(a.gt, a.eval_dir)


if __name__ == "__main__":
    main()
