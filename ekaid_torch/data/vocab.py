"""Vocabulary and tokenization (counterpart of `ekaid_tpu/data/vocab.py`).

Word -> id from 1 ('<start>' = 1); id 0 is NULL/pad/EOS, so the vocab
size is len(words) + 1. `treebank_tokenize` splits the way the corpus
was tokenized: lowercase, punctuation as its own tokens, contraction
tails split off. `pos_tag` uses nltk's perceptron tagger when its model
is installed and the rule-based `pos_tag_lite` otherwise; the POS ids
never reach a loss.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List

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

    @classmethod
    def build(cls, token_streams: Iterable[List[str]],
              start_token: str = "<start>") -> "Vocabulary":
        """Insertion-ordered vocab from 1: start_token, then each new
        token in stream order."""
        vocab = {start_token: 1}
        for tokens in token_streams:
            for tok in tokens:
                if tok not in vocab:
                    vocab[tok] = len(vocab) + 1
        return cls(vocab)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.word_to_idx, f, indent=4)

    def encode(self, tokens: List[str], max_len: int) -> List[int]:
        ids = [self.word_to_idx[t] for t in tokens if t in self.word_to_idx]
        ids = ids[:max_len]
        return ids + [0] * (max_len - len(ids))

    def decode(self, ids) -> str:
        """ids -> space-joined words, stopping at the first 0."""
        words = []
        for i in ids:
            i = int(i)
            if i <= 0:
                break
            words.append(self.idx_to_word.get(i, "<unk>"))
        return " ".join(words)

    def decode_batch(self, seqs) -> List[str]:
        return [self.decode(row) for row in seqs]


# Rule-based POS tagger, used when nltk's tagger model is absent: a
# suffix heuristic that keeps the data format populated. Tag ids follow
# the corpus's POS table.
_POS_IDS = {"CC": 1, "CD": 2, "DT": 3, "IN": 6, "JJ": 7, "NN": 12,
            "NNS": 13, "PRP": 18, "RB": 20, "VB": 27, "VBD": 28,
            "VBG": 29, "VBN": 30, "VBZ": 32, ",": 37, ".": 38, "?": 39}

_DT = {"the", "a", "an", "this", "that", "these", "those"}
_IN = {"in", "of", "on", "at", "than", "with", "from", "to", "by"}
_CC = {"and", "or", "but"}
_PRP = {"it", "there", "image"}


def pos_tag_lite(tokens: List[str]) -> List[int]:
    out = []
    for t in tokens:
        if t in (",", ".", "?"):
            tag = t
        elif t.isdigit():
            tag = "CD"
        elif t in _DT:
            tag = "DT"
        elif t in _IN:
            tag = "IN"
        elif t in _CC:
            tag = "CC"
        elif t.endswith("ing"):
            tag = "VBG"
        elif t.endswith("ed"):
            tag = "VBN"
        elif t.endswith("s") and not t.endswith("ss"):
            tag = "NNS"
        elif t in ("is", "has", "appears", "shows"):
            tag = "VBZ"
        else:
            tag = "NN"
        out.append(_POS_IDS.get(tag, 12))
    return out


def pos_tag(tokens: List[str]) -> List[int]:
    """nltk perceptron tagger when its model exists, else the fallback."""
    try:
        import nltk
        tagged = nltk.pos_tag(tokens)
        # map tag strings through the POS table's ids where known
        return [_POS_IDS.get(tag, 12) for _, tag in tagged]
    except Exception:
        return pos_tag_lite(tokens)


class AnswerIds(Vocabulary):
    """The words of an LM decoder's answer ids: the ids are the dataset
    vocabulary's where it has them (id i is its word i), and 'w<i>' for
    the LM's other ids. An answer ends at its first negative id (the
    decoder's END); 0 is a token of the LM, not an end."""

    def __init__(self, vocab: Vocabulary, size: int):
        super().__init__(vocab.word_to_idx)
        self.size = size

    def decode(self, ids) -> str:
        words = []
        for i in ids:
            i = int(i)
            if i < 0:
                break
            words.append(self.idx_to_word.get(i, f"w{i}"))
        return " ".join(words)


def identity_vocab(vocab_size: int) -> Vocabulary:
    """Synthetic vocab: token i <-> 'w<i>' (plus '<start>' at 1)."""
    words = {"<start>": 1}
    for i in range(2, vocab_size):
        words[f"w{i}"] = i
    return Vocabulary(words)
