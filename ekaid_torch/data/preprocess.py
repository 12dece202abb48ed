"""QA-text preprocessing: question CSV -> packed arrays, vocab, splits and
GT caption JSONs (counterpart of `ekaid_tpu/data/preprocess.py`).

`transform_questions` reads a CSV with question, answer, question_type,
study_id and ref_id columns and writes into out_dir:
  * `vqa_dataset.npz`: questions [n, 20] and answers [n, 90] (answers
    start with '<start>'), the answers' POS ids [n, 90], and
    feature_idx [n, 2], the two feature rows of each pair. With both
    dicom2id and study2dicom given, a row's ids map study -> dicom ->
    row; without them row i is self-indexed as (2i, 2i + 1), which the
    pipeline's preprocess stage relies on;
  * `vocab_mimic_VQA.json`: the insertion-ordered vocab; an existing
    vocab file is extended with each unknown word, appended at the end;
  * `splits_mimic_VQA.json`: contiguous 80/10/10 splits, cut at ceil;
  * `mimic_gt_captions_{train,val,test}.json`: COCO-style captions whose
    image_id is the question row, with the question and its type.

`difference_only` keeps the 'difference' questions. pandas is imported
when a CSV is read. This is what `data/pipeline.py::DiffVQADataset` and
`train/train.py::build_trainer` read.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Optional

import numpy as np

from ekaid_torch.data.vocab import Vocabulary, pos_tag, treebank_tokenize

Q_LEN = 20
A_LEN = 90


def transform_questions(question_csv: str, out_dir: str,
                        dicom2id_pkl: Optional[str] = None,
                        study2dicom_pkl: Optional[str] = None,
                        vocab_path: Optional[str] = None,
                        difference_only: bool = False) -> Dict[str, str]:
    """Build the packed QA dataset. Returns the paths written."""
    import pandas as pd
    os.makedirs(out_dir, exist_ok=True)
    df = pd.read_csv(question_csv)
    if difference_only:
        df = df[df["question_type"] == "difference"].reset_index(drop=True)

    dicom2id = study2dicom = None
    if dicom2id_pkl and study2dicom_pkl:
        with open(dicom2id_pkl, "rb") as f:
            dicom2id = pickle.load(f)
        with open(study2dicom_pkl, "rb") as f:
            study2dicom = pickle.load(f)

    q_tokens = [treebank_tokenize(q) for q in df["question"]]
    a_tokens = [["<start>"] + treebank_tokenize(a) for a in df["answer"]]

    if vocab_path and os.path.exists(vocab_path):
        vocab = Vocabulary.load(vocab_path)
        for toks in q_tokens + a_tokens:
            for t in toks:
                if t not in vocab.word_to_idx:
                    vocab.word_to_idx[t] = len(vocab.word_to_idx) + 1
        vocab = Vocabulary(vocab.word_to_idx)
    else:
        vocab = Vocabulary.build(q_tokens + a_tokens)

    n = len(df)
    questions = np.zeros((n, Q_LEN), np.int32)
    answers = np.zeros((n, A_LEN), np.int32)
    pos = np.zeros((n, A_LEN), np.int32)
    feature_idx = np.zeros((n, 2), np.int64)
    for i in range(n):
        questions[i] = vocab.encode(q_tokens[i], Q_LEN)
        answers[i] = vocab.encode(a_tokens[i], A_LEN)
        tags = pos_tag(a_tokens[i])[:A_LEN]
        pos[i, :len(tags)] = tags
        if dicom2id is not None:
            feature_idx[i, 0] = dicom2id[study2dicom[df.iloc[i]["study_id"]]]
            feature_idx[i, 1] = dicom2id[study2dicom[df.iloc[i]["ref_id"]]]
        else:
            feature_idx[i] = (2 * i, 2 * i + 1)

    npz_path = os.path.join(out_dir, "vqa_dataset.npz")
    np.savez_compressed(npz_path, questions=questions, answers=answers,
                        pos=pos, feature_idx=feature_idx)

    idx = np.arange(n).tolist()
    splits = {
        "train": idx[:int(np.ceil(0.8 * n))],
        "val": idx[int(np.ceil(0.8 * n)):int(np.ceil(0.9 * n))],
        "test": idx[int(np.ceil(0.9 * n)):],
    }
    splits_path = os.path.join(out_dir, "splits_mimic_VQA.json")
    with open(splits_path, "w") as f:
        json.dump(splits, f)
    vocab_out = os.path.join(out_dir, "vocab_mimic_VQA.json")
    vocab.save(vocab_out)

    gt_paths = save_coco_format(df, splits, out_dir)
    return {"npz": npz_path, "splits": splits_path, "vocab": vocab_out,
            **gt_paths}


def save_coco_format(df, splits: Dict, out_dir: str) -> Dict[str, str]:
    """One COCO-style GT caption JSON a split; image_id is the global
    question row. Each annotation keeps its question and, where the CSV
    has it, its question_type."""
    out = {}
    for name, split in splits.items():
        annos, images = [], []
        for index in split:
            anno = {
                "id": str(index), "image_id": str(index), "category_id": 0,
                "caption": df["answer"][index],
                "question": df["question"][index],
            }
            if "question_type" in df.columns:
                anno["question_type"] = df["question_type"][index]
            annos.append(anno)
            images.append({"id": str(index)})
        path = os.path.join(out_dir, f"mimic_gt_captions_{name}.json")
        with open(path, "w") as f:
            json.dump({"info": [], "licenses": [], "categories": [],
                       "images": images, "annotations": annos}, f)
        out[f"gt_{name}"] = path
    return out


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="MIMIC-Diff-VQA text preprocessing")
    p.add_argument("-q", "--question_csv", required=True)
    p.add_argument("-o", "--out_dir", default="data")
    p.add_argument("--dicom2id")
    p.add_argument("--study2dicom")
    p.add_argument("--vocab")
    p.add_argument("--difference_only", action="store_true")
    a = p.parse_args(argv)
    paths = transform_questions(a.question_csv, a.out_dir, a.dicom2id,
                                a.study2dicom, a.vocab, a.difference_only)
    for k, v in paths.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
