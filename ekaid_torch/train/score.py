"""Answer accuracy (counterpart of `ekaid_tpu/train/score.py::accuracy`,
the one function of it that `Trainer.evaluate` calls).
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np


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
