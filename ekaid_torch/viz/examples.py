"""Dataset-example browsing and presentation sheets (counterpart of
`ekaid_tpu/viz/examples.py`).

    python -m ekaid_torch.viz.examples --gt_json \
        <root>/mimic_gt_captions_test.json --question_type difference

`find_examples` picks study pairs whose QA matches a question type or a
keyword, from the GT caption JSONs that `data/preprocess.py` writes
(question, question_type and caption a row), and `render_sheet` draws
them with `viz/draw.py::draw_example_sheet`. Host only.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional


def find_examples(gt_captions_json: str,
                  question_type: Optional[str] = None,
                  keyword: Optional[str] = None,
                  n: int = 6) -> List[Dict[str, str]]:
    """Rows {id, question, answer, question_type} matching the filters
    (keyword is a case-insensitive substring of question or answer)."""
    with open(gt_captions_json) as f:
        gt = json.load(f)
    out = []
    for anno in gt["annotations"]:
        if question_type is not None and \
                anno.get("question_type") != question_type:
            continue
        if keyword is not None:
            kw = keyword.lower()
            if kw not in anno.get("caption", "").lower() and \
                    kw not in anno.get("question", "").lower():
                continue
        out.append({"id": anno["image_id"],
                    "question": anno.get("question", ""),
                    "answer": anno["caption"],
                    "question_type": anno.get("question_type", "")})
        if len(out) >= n:
            break
    return out


def render_sheet(rows: List[Dict[str, str]], image_lookup,
                 save: str):
    """rows from find_examples + image_lookup(id) -> (img_bef, img_aft)
    numpy arrays; writes the presentation sheet."""
    from ekaid_torch.viz.draw import draw_example_sheet
    examples = []
    for r in rows:
        bef, aft = image_lookup(r["id"])
        examples.append({"image_bef": bef, "image_aft": aft,
                         "question": r["question"],
                         "answer": r["answer"]})
    return draw_example_sheet(examples, save=save)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Find dataset examples by type/keyword "
                    "(draw_dataset_examples_for_presentation parity)")
    p.add_argument("--gt_json", required=True)
    p.add_argument("--question_type", default=None)
    p.add_argument("--keyword", default=None)
    p.add_argument("--n", type=int, default=6)
    a = p.parse_args(argv)
    for r in find_examples(a.gt_json, a.question_type, a.keyword, a.n):
        print(f"[{r['id']}] ({r['question_type']}) Q: {r['question']}"
              f"  A: {r['answer']}")


if __name__ == "__main__":
    main()
