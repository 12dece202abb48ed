"""COCO-caption containers and the caption evaluator (counterpart of
`ekaid_tpu/metrics/coco.py`): ground truth {'annotations': [{image_id,
caption, ...}]}, results [{image_id, caption}], and Bleu_1..4, METEOR,
ROUGE_L and CIDEr into `.eval` in that order.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from ekaid_torch.metrics.caption import (WordTable, bleu, cider, meteor15,
                                         pack, rouge_l)
from ekaid_torch.utils.observability import span


class CocoCaptions:
    """Minimal COCO captions container."""

    def __init__(self, annotation_file: Optional[str] = None,
                 annotations: Optional[dict] = None):
        if annotation_file is not None:
            with open(annotation_file) as f:
                annotations = json.load(f)
        assert annotations is not None
        self.dataset = annotations
        self.img_to_anns: Dict[str, List[dict]] = {}
        for ann in annotations.get("annotations", []):
            self.img_to_anns.setdefault(str(ann["image_id"]),
                                        []).append(ann)

    def get_img_ids(self) -> List[str]:
        return list(self.img_to_anns.keys())

    def load_res(self, results) -> "CocoCaptions":
        """results: path or list of {image_id, caption}."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        anns = [{"image_id": str(r["image_id"]), "caption": r["caption"],
                 "id": str(r.get("id", r["image_id"]))} for r in results]
        return CocoCaptions(annotations={"annotations": anns})


class CaptionEvaluator:
    """The seven caption scores of a result set against its ground
    truth, overall (`eval`) and per image (`img_to_eval`)."""

    METRICS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
               "ROUGE_L", "CIDEr")

    def __init__(self, coco: CocoCaptions, coco_res: CocoCaptions,
                 vocab=None):
        """vocab: optional answer-vocabulary iterable; when given, the
        METEOR synonym table is derived for it
        (meteor_resources.derive_vocab_synonyms) instead of using the
        general bundled table."""
        self.coco = coco
        self.coco_res = coco_res
        self.params = {"image_id": coco_res.get_img_ids()}
        self.eval: Dict[str, float] = {}
        self.img_to_eval: Dict[str, Dict[str, float]] = {}
        self.synonyms = None
        if vocab is not None:
            from ekaid_torch.metrics.meteor_resources import \
                derive_vocab_synonyms
            self.synonyms = derive_vocab_synonyms(vocab)

    def evaluate(self, verbose: bool = False) -> Dict[str, float]:
        """The seven scores, each metric in a span of its own; the
        captions are tokenized once into token ids (and, for METEOR,
        their words), packed once for BLEU, ROUGE-L and CIDEr."""
        img_ids = [str(i) for i in self.params["image_id"]]
        with span("ekaid.score.tokenize"):
            table = WordTable()
            gts = {i: [table(a["caption"])
                       for a in self.coco.img_to_anns[i]] for i in img_ids}
            res = {i: table(self.coco_res.img_to_anns[i][0]["caption"])
                   for i in img_ids}
            packed = pack(gts, res)
            word = table.words.__getitem__
            gts_words = {i: [list(map(word, r)) for r in refs]
                         for i, refs in gts.items()}
            res_words = {i: list(map(word, c)) for i, c in res.items()}

        with span("ekaid.score.bleu"):
            bleu_scores, bleu_img = bleu(gts, res, packed=packed)
        for k in range(4):
            self._set(f"Bleu_{k + 1}", bleu_scores[k],
                      {i: s[k] for i, s in bleu_img.items()})
        with span("ekaid.score.meteor"):
            m, m_img = meteor15(gts_words, res_words, synonyms=self.synonyms)
        self._set("METEOR", m, m_img)
        with span("ekaid.score.rouge"):
            r, r_img = rouge_l(gts, res, packed=packed)
        self._set("ROUGE_L", r, r_img)
        with span("ekaid.score.cider"):
            c, c_img = cider(gts, res, packed=packed)
        self._set("CIDEr", c, c_img)
        if verbose:
            for k, v in self.eval.items():
                print(f"{k}: {v:.3f}")
        return self.eval

    def _set(self, name: str, score: float, per_img: Dict[str, float]):
        self.eval[name] = score
        for img, s in per_img.items():
            self.img_to_eval.setdefault(img, {"image_id": img})[name] = s


def evaluate_files(annotation_file: str, results_file: str,
                   verbose: bool = True) -> Dict[str, float]:
    coco = CocoCaptions(annotation_file)
    coco_res = coco.load_res(results_file)
    ev = CaptionEvaluator(coco, coco_res)
    return ev.evaluate(verbose=verbose)
