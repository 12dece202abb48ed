"""ekaid_torch's scoring over interned token ids
(`metrics/caption.py::WordTable`, `pack`; `metrics/coco.py::
CaptionEvaluator.evaluate`): the table's tokens equal `ptb_tokenize`'s,
and the evaluator's seven scores and per-image values with the native
library equal its plain Python path within 1e-12 relative (BLEU and
ROUGE-L exactly)."""

import random

import numpy as np
import pytest

from ekaid_torch.metrics import caption as cap
from ekaid_torch.metrics.coco import CaptionEvaluator, CocoCaptions

CAPTIONS = [
    "The Left LUNG has CHANGED",
    "(left) lung, \"effusion\" 'worse' `nodule`.",
    "is it worse?! no... yes; [maybe] {none}:",
    "- -- ... ! ? , ; : & * # $ % @ + = / \\ ~ ^ _ | < >",
    "  many   spaces\tand\ttabs\n\nand  newlines  ",
    "''quoted'' ``twice`` \"'nested'\"",
    "mid-word.punct stays, e.g. x.y and a/b",
    "",
    "   ",
    "ALL CAPS. All Caps! all caps?",
]


@pytest.mark.parametrize("text", CAPTIONS)
def test_word_table_tokens_equal_ptb_tokenize(text):
    table = cap.WordTable()
    for other in CAPTIONS:         # a table that has seen every caption
        table(other)
    for t in (table, cap.WordTable()):
        assert [t.words[k] for k in t(text)] == cap.ptb_tokenize(text)


def test_word_table_numbers_tokens_once_for_the_corpus():
    table = cap.WordTable()
    a = table("Lung, lung. LUNG effusion")
    b = table("effusion (lung)")
    assert a == [0, 0, 0, 1] and b == [1, 0]
    assert table.words == ["lung", "effusion"]


def _evaluator(n=512, words=90, seed=0):
    rng = random.Random(seed)
    vocab = [f"w{i}" for i in range(148)] + ["Effusion,", "(left)", "."]
    gts = {"annotations": [
        {"image_id": str(k), "id": f"{k}-{j}",
         "caption": " ".join(rng.choice(vocab)
                             for _ in range(rng.randint(1, 12)))}
        for k in range(n) for j in range(rng.randint(1, 3))]}
    res = [{"image_id": str(k),
            "caption": " ".join(rng.choice(vocab)
                                for _ in range(rng.randint(words - 10,
                                                           words)))}
           for k in range(n)]
    coco = CocoCaptions(annotations=gts)
    return CaptionEvaluator(coco, coco.load_res(res))


def test_evaluator_native_equals_plain(monkeypatch):
    """512 hypotheses of 80-90 words: the seven scores and img_to_eval,
    native against `_native` replaced by `lambda: None`."""
    native = _evaluator()
    got = native.evaluate()
    monkeypatch.setattr(cap, "_native", lambda: None)
    plain = _evaluator()
    want = plain.evaluate()
    assert list(got) == list(want) == list(CaptionEvaluator.METRICS)
    assert list(native.img_to_eval) == list(plain.img_to_eval)
    for k in CaptionEvaluator.METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0,
                                   err_msg=k)
        np.testing.assert_allclose(
            [s[k] for s in native.img_to_eval.values()],
            [s[k] for s in plain.img_to_eval.values()], rtol=1e-12, atol=0,
            err_msg=k)
        if k != "CIDEr":
            assert got[k] == want[k], k
    assert got["CIDEr"] > 0 and got["Bleu_1"] > 0


def test_cider_counts_images_only_the_references_have(monkeypatch):
    """CIDEr's document frequency and corpus size take every image of
    gts, scored or not: native equals plain where res is a subset."""
    table = cap.WordTable()
    rng = random.Random(1)
    vocab = [f"w{i}" for i in range(12)]

    def sent(n):
        return table(" ".join(rng.choice(vocab) for _ in range(n)))

    gts = {str(k): [sent(rng.randint(1, 8)) for _ in range(2)]
           for k in range(30)}
    res = {str(k): sent(rng.randint(0, 10)) for k in range(0, 30, 3)}
    got = cap.cider(gts, res)
    monkeypatch.setattr(cap, "_native", lambda: None)
    want = cap.cider(gts, res)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=0)
    np.testing.assert_allclose(list(got[1].values()),
                               list(want[1].values()), rtol=1e-12, atol=0)
    assert list(got[1]) == list(res) and got[0] > 0
