"""Vocabulary and tokenization (counterpart of `ekaid_tpu/data/vocab.py`).

Word -> id from 1 ('<start>' = 1); id 0 is NULL/pad/EOS, so the vocab
size is len(words) + 1. `treebank_tokenize` splits the way the corpus
was tokenized: lowercase, punctuation as its own tokens, contraction
tails split off.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List

_TOKEN_RE = re.compile(
    r"n't|'(?:s|re|ve|ll|d|m)\b"           # contraction tails
    r"|\d+\.\d+"                           # decimals
    r"|[a-zA-Z0-9]+(?:-[a-zA-Z0-9]+)*"     # words/alphanumerics/hyphenated
    r"|[^\w\s]"                            # each punctuation char
)


def treebank_tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


class Vocabulary:
    def __init__(self, word_to_idx: Dict[str, int]):
        self.word_to_idx = dict(word_to_idx)
        self.idx_to_word = {i: w for w, i in self.word_to_idx.items()}
        self.size = len(self.word_to_idx) + 1

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        with open(path) as f:
            return cls(json.load(f))

    def decode(self, ids) -> str:
        """ids -> space-joined words, stopping at the first 0."""
        words = []
        for i in ids:
            i = int(i)
            if i <= 0:
                break
            words.append(self.idx_to_word.get(i, "<unk>"))
        return " ".join(words)


def identity_vocab(vocab_size: int) -> Vocabulary:
    """Synthetic vocab: token i <-> 'w<i>' (plus '<start>' at 1)."""
    words = {"<start>": 1}
    for i in range(2, vocab_size):
        words[f"w{i}"] = i
    return Vocabulary(words)
