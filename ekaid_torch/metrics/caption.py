"""Caption metrics: BLEU 1-4, ROUGE-L, CIDEr, METEOR-1.5 (counterpart of
`ekaid_tpu/metrics/caption.py`, its pure-Python path).

  * BLEU: corpus-level clipped n-gram precision, 'closest' effective
    reference length for the brevity penalty (ties prefer the shorter).
  * ROUGE-L: per-image max LCS precision/recall over the references,
    F-beta with beta 1.2, averaged over images.
  * CIDEr: tf-idf n-gram cosine for n = 1..4, idf from the reference
    corpus, Gaussian length penalty sigma 6, scaled by 10.
  * METEOR: `meteor15` scores as METEOR-1.5 does (exact / stem /
    synonym / paraphrase stages weighted 1.0 / 0.6 / 0.8 / 0.6,
    content/function delta weighting, the rank-task parameters), with
    its aligner's beam search (beam 40) over the resources of
    `metrics/meteor_resources.py`; `meteor_lite` (exact + stem, the
    2005 parameters) is the fast fallback.

Tokenization: lowercase, split, drop punctuation-only tokens. A
`WordTable` tokenizes a scoring call's captions as `ptb_tokenize` does,
each distinct word once, and numbers the tokens for the whole call; BLEU,
ROUGE-L and CIDEr then compare token ids, METEOR the table's words.

BLEU's clipped counts, ROUGE-L's LCS and CIDEr-D run in the native host
library (`native/bindings.py`), one call a metric for the whole eval, on
token ids packed once (`pack`); the Python code beside each is its plain
version (the tests run it with `_native` replaced by `lambda: None`).
The counters `ekaid.score.native` and `ekaid.score.plain` count the
three metrics' calls by the path they took. METEOR's alignment is all
that stays in Python (~55 ms of a 512-answer call at 90-token answers,
on a CPU).
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from ekaid_torch.native.bindings import Segments, pack_segments
from ekaid_torch.native.bindings import native as _native
from ekaid_torch.utils.observability import count

PUNCT = {"{", "}", "(", ")", "[", "]", ".", ",", ";", ":", "-", "--",
         "...", "!", "?", "'", "`", '"', "''", "``", "&", "*", "#", "$",
         "%", "@", "+", "=", "/", "\\", "~", "^", "_", "|", "<", ">"}

_WORD_RE = re.compile(r"[^\s]+")
_CORE_RE = re.compile(r"^([\"'`(\[{]*)(.*?)([\"'`)\]}.,;:!?]*)$")


def _core(word: str) -> Optional[str]:
    """A lowercased word's token, or None where it is punctuation."""
    # split leading/trailing punctuation clusters
    m = _CORE_RE.match(word)
    core = m.group(2) if m else word
    return core if core and core not in PUNCT else None


def ptb_tokenize(text: str) -> List[str]:
    """Lowercase, whitespace-split, separate trailing punctuation, then
    drop punctuation-only tokens (PTBTokenizer-equivalent for this
    corpus's already-space-separated captions)."""
    return [c for c in map(_core, _WORD_RE.findall(text.lower()))
            if c is not None]


class WordTable:
    """`ptb_tokenize` with each distinct lowercased word cleaned once:
    `table(text)` gives the ids of `ptb_tokenize(text)`'s tokens, which
    `words` lists, numbered in order of first sight over every caption
    the table has seen (one numbering for a scoring call). The words of
    a caption are cleaned one by one, so a table of them gives the same
    tokens as cleaning the whole caption (`str.split` splits where
    `_WORD_RE` does: on the characters `str.isspace` names)."""

    def __init__(self):
        self.words: List[str] = []
        self._ids: Dict[str, int] = {}     # token -> id
        self._word: Dict[str, int] = {}    # word -> its token's id, or -1

    def __call__(self, text: str) -> List[int]:
        words = text.lower().split()
        word = self._word
        try:
            ids = list(map(word.__getitem__, words))
        except KeyError:
            for w in words:
                if w not in word:
                    word[w] = self._number(_core(w))
            ids = list(map(word.__getitem__, words))
        return [k for k in ids if k >= 0] if -1 in ids else ids

    def _number(self, token: Optional[str]) -> int:
        if token is None:
            return -1
        k = self._ids.get(token)
        if k is None:
            k = self._ids[token] = len(self.words)
            self.words.append(token)
        return k


def pack(gts: Dict[str, List[List[int]]],
         res: Dict[str, List[int]]) -> Segments:
    """The native library's layout of a scoring call over token ids: a
    segment [candidate, *references] for each image of res, in its
    order, then one with an empty candidate for each image only gts has
    (CIDEr's document frequency counts them)."""
    imgs = [*res, *(i for i in gts if i not in res)]
    return pack_segments([[res.get(i, ()), *gts[i]] for i in imgs])


def _packed(gts, res, packed: Optional[Segments]) -> Segments:
    """`packed`, or gts and res over any tokens packed."""
    if packed is not None:
        return packed
    ids: Dict[object, int] = {}

    def number(toks):
        return [ids.setdefault(w, len(ids)) for w in toks]

    return pack({i: [number(r) for r in refs] for i, refs in gts.items()},
                {i: number(c) for i, c in res.items()})


def _counted(nat):
    """Count a metric's call by its path; give the library or None."""
    count("ekaid.score.plain" if nat is None else "ekaid.score.native")
    return nat


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n])
                   for i in range(len(tokens) - n + 1))


# ------------------------------------------------------------------ BLEU ---

def _bleu_counts(segments, max_n: int):
    """Clipped n-gram matches and totals [n][max_n] of each segment
    [candidate, *references]: the plain version of
    `bindings.bleu_counts_batch`."""
    matches, totals = [], []
    for cand, *refs in segments:
        m, t = [], []
        for n in range(1, max_n + 1):
            cnt = _ngrams(cand, n)
            maxref: Counter = Counter()
            for r in refs:
                for ng, k in _ngrams(r, n).items():
                    maxref[ng] = max(maxref[ng], k)
            m.append(sum(min(k, maxref[ng]) for ng, k in cnt.items()))
            t.append(max(0, len(cand) - n + 1))
        matches.append(m)
        totals.append(t)
    return matches, totals


def bleu(gts: Dict[str, List[List[str]]], res: Dict[str, List[str]],
         max_n: int = 4, packed: Optional[Segments] = None
         ) -> Tuple[List[float], Dict[str, List[float]]]:
    """Corpus BLEU_1..max_n. gts: id -> list of reference token lists;
    res: id -> candidate token list; packed: `pack(gts, res)` where the
    caller has it. Returns (corpus scores, per-image)."""
    tiny, small = 1e-15, 1e-9
    correct = [0.0] * max_n
    guess = [0.0] * max_n
    cand_len = 0
    eff_ref_len = 0
    per_image: Dict[str, List[float]] = {}
    nat = _counted(_native())
    if nat is None:
        matches, totals = _bleu_counts(
            [[cand, *gts[img]] for img, cand in res.items()], max_n)
    else:
        matches, totals = (x.tolist() for x in nat.bleu_counts_batch(
            _packed(gts, res, packed), len(res), max_n))

    for (img, cand), img_correct, img_guess in zip(res.items(), matches,
                                                   totals):
        refs = gts[img]
        c = len(cand)
        cand_len += c
        # closest ref length; ties -> shorter
        eff = min((abs(len(r) - c), len(r)) for r in refs)[1]
        eff_ref_len += eff
        for n in range(max_n):
            correct[n] += img_correct[n]
            guess[n] += img_guess[n]
        # per-image score (with its own BP)
        scores = []
        bp_i = 1.0 if c > eff else math.exp(1 - eff / max(c, 1))
        logp = 0.0
        for n in range(max_n):
            p = (img_correct[n] + tiny) / (img_guess[n] + small)
            logp += math.log(p)
            scores.append(math.exp(logp / (n + 1)) * bp_i)
        per_image[img] = scores

    bp = 1.0 if cand_len > eff_ref_len else (
        math.exp(1 - eff_ref_len / max(cand_len, 1)))
    out = []
    logp = 0.0
    for n in range(max_n):
        p = (correct[n] + tiny) / (guess[n] + small)
        logp += math.log(p)
        out.append(math.exp(logp / (n + 1)) * bp)
    return out, per_image


# --------------------------------------------------------------- ROUGE-L ---

def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l(gts, res, beta: float = 1.2,
            packed: Optional[Segments] = None):
    """Mean ROUGE-L F-beta; per-image max precision/recall over refs."""
    nat = _counted(_native())
    if nat is None:
        lcs_all = [_lcs_len(ref, cand) for img, cand in res.items()
                   for ref in gts[img]]
    else:
        lcs_all = nat.lcs_len_batch(_packed(gts, res, packed),
                                    len(res)).tolist()
    lcs_of = iter(lcs_all)
    scores = {}
    for img, cand in res.items():
        lcs_img = [next(lcs_of) for _ in gts[img]]
        if not cand:
            scores[img] = 0.0
            continue
        precs, recs = [], []
        for ref, lcs in zip(gts[img], lcs_img):
            precs.append(lcs / len(cand))
            recs.append(lcs / len(ref) if ref else 0.0)
        p, r = max(precs), max(recs)
        scores[img] = ((1 + beta ** 2) * p * r / (r + beta ** 2 * p)
                       if p and r else 0.0)
    mean = sum(scores.values()) / max(len(scores), 1)
    return mean, scores


# ----------------------------------------------------------------- CIDEr ---

def cider(gts, res, max_n: int = 4, sigma: float = 6.0,
          packed: Optional[Segments] = None):
    """CIDEr-D-style tf-idf n-gram similarity (Vedantam et al.)."""
    nat = _counted(_native())
    if nat is not None:
        per_img = nat.cider_batch(_packed(gts, res, packed), len(res),
                                  max_n, sigma).tolist()
        scores = dict(zip(res, per_img))
        return sum(scores.values()) / max(len(scores), 1), scores
    # document frequency over the reference corpus
    df: Counter = Counter()
    for refs in gts.values():
        seen = set()
        for r in refs:
            for n in range(1, max_n + 1):
                seen.update(_ngrams(r, n).keys())
        df.update(seen)
    log_n_imgs = math.log(max(len(gts), 1))

    def vec(tokens):
        vecs, norms = [], []
        for n in range(1, max_n + 1):
            v = {}
            sq = 0.0
            for ng, k in _ngrams(tokens, n).items():
                idf = log_n_imgs - math.log(max(1.0, df[ng]))
                v[ng] = k * idf
                sq += v[ng] ** 2
            vecs.append(v)
            norms.append(math.sqrt(sq))
        return vecs, norms, len(tokens)

    scores = {}
    for img, cand in res.items():
        hv, hn, hl = vec(cand)
        total = 0.0
        for ref in gts[img]:
            rv, rn, rl = vec(ref)
            delta = float(hl - rl)
            sim = 0.0
            for n in range(max_n):
                val = sum(min(hv[n].get(ng, 0.0), rv[n][ng]) * rv[n][ng]
                          for ng in rv[n])
                if hn[n] and rn[n]:
                    val /= hn[n] * rn[n]
                val *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                sim += val
            total += sim / max_n
        scores[img] = 10.0 * total / max(len(gts[img]), 1)
    mean = sum(scores.values()) / max(len(scores), 1)
    return mean, scores


# ---------------------------------------------------------- METEOR-lite ---

class _Stem:
    """Memoized Porter stemmer (nltk's algorithm is pure code, no data),
    loaded at its first call: importing nltk is slow and pulls in pandas.
    Without nltk, words stem to themselves."""

    def __init__(self):
        self.cache: Dict[str, str] = {}
        self._s = None

    def __call__(self, w: str) -> str:
        if w not in self.cache:
            if self._s is None:
                try:
                    from nltk.stem.porter import PorterStemmer
                    self._s = PorterStemmer().stem
                except Exception:
                    self._s = lambda x: x
            self.cache[w] = self._s(w)
        return self.cache[w]


_STEM = _Stem()


def _meteor_align(hyp: List[str], ref: List[str]) -> Tuple[int, int]:
    """(matches, chunks) via exact then stemmed greedy alignment."""
    ref_used = [False] * len(ref)
    align = [-1] * len(hyp)
    # stage 1: exact
    for i, h in enumerate(hyp):
        for j, r in enumerate(ref):
            if not ref_used[j] and h == r:
                align[i] = j
                ref_used[j] = True
                break
    # stage 2: stem
    hs = [_STEM(h) for h in hyp]
    rs = [_STEM(r) for r in ref]
    for i, h in enumerate(hs):
        if align[i] >= 0:
            continue
        for j, r in enumerate(rs):
            if not ref_used[j] and h == r:
                align[i] = j
                ref_used[j] = True
                break
    pairs = [(i, j) for i, j in enumerate(align) if j >= 0]
    m = len(pairs)
    chunks = 0
    prev = None
    for i, j in pairs:
        if prev is None or j != prev + 1:
            chunks += 1
        prev = j
    return m, chunks


_METEOR_BEAM = 40                     # the jar's partial-alignment beam
_EMPTY: frozenset = frozenset()


def _meteor_candidates(hyp, ref, syn_idx):
    """Per-hyp-index candidate matches [(ref_j, stage)], stage = first
    matching module in METEOR order (0 exact, 1 stem, 2 synonym) — the
    highest-weight module for that pair, as the jar keeps."""
    hs = [_STEM(h) for h in hyp]
    rs = [_STEM(r) for r in ref]
    cands = []
    for i, h in enumerate(hyp):
        row = []
        hsyn = syn_idx.get(h, _EMPTY) if syn_idx else _EMPTY
        for j, r in enumerate(ref):
            if h == r:
                row.append((j, 0))
            elif hs[i] == rs[j]:
                row.append((j, 1))
            elif hsyn and hsyn & syn_idx.get(r, _EMPTY):
                row.append((j, 2))
        cands.append(row)
    return cands


def _meteor15_align(hyp: List[str], ref: List[str], syn_idx):
    """One-to-one alignment by the jar's search (Meteor-1.5 Aligner
    resolution criteria, in priority order: maximize covered words,
    minimize chunk count, minimize the sum of absolute match-position
    distances), via the jar's own beam search over partial alignments
    (beam 40). Stages in module order: 0 exact, 1 stem, 2 synonym.
    Returns (pairs [(hyp_i, ref_j, stage)], chunks).

    Word modules only: every match is 1-1, which this search requires;
    the paraphrase module's span matches live in _meteor15_align_spans,
    which defers here when no phrase candidates fire.
    """
    cands = _meteor_candidates(hyp, ref, syn_idx)
    # state: (matches, chunks, dist, prev_i, prev_j, used_mask, pairs)
    states = [(0, 0, 0, -2, -2, 0, ())]
    for i, row in enumerate(cands):
        nxt = []
        for st in states:
            m, ch, dist, pi, pj, used, pairs = st
            nxt.append(st)                       # leave hyp[i] unmatched
            for j, stage in row:
                if used >> j & 1:
                    continue
                contiguous = (pi == i - 1) and (pj == j - 1)
                nxt.append((m + 1, ch + (0 if contiguous else 1),
                            dist + abs(i - j), i, j, used | (1 << j),
                            pairs + ((i, j, stage),)))
        # keep the beam's best by the resolution criteria
        nxt.sort(key=lambda s: (-s[0], s[1], s[2]))
        states = nxt[:_METEOR_BEAM]
    best = states[0]
    return list(best[6]), best[1]


def _phrase_candidates(hyp, ref, para_idx, max_plen):
    """Paraphrase-stage span candidates [(i, hlen, j, rlen)]:
    hyp[i:i+hlen] and ref[j:j+rlen] are a table pair (share a pair id).
    Identical single words are left to the exact stage."""
    def spans(toks):
        found = {}
        for a in range(len(toks)):
            for ln in range(1, min(max_plen, len(toks) - a) + 1):
                ids = para_idx.get(tuple(toks[a:a + ln]))
                if ids:
                    found[(a, ln)] = ids
        return found

    rspans = spans(ref)
    if not rspans:
        return []
    out = []
    for (i, hl), hids in spans(hyp).items():
        for (j, rl), rids in rspans.items():
            # a match is the two DIFFERENT members of a table pair —
            # identical spans are the exact word module's business
            if hids & rids and tuple(hyp[i:i + hl]) != tuple(
                    ref[j:j + rl]):
                out.append((i, hl, j, rl))
    return out


def _meteor15_align_spans(hyp: List[str], ref: List[str], syn_idx,
                          para_idx=None, max_plen: int = 1):
    """Span-general alignment adding the jar's 4th matcher module
    (paraphrase, stage 3): matches are (hyp_i, hyp_len, ref_j, ref_len,
    stage); word-module matches are 1-1 spans. Resolution criteria
    generalize the word case per the jar's Aligner: maximize total
    covered words (both sides), then minimize chunks (a span match is
    contiguous with the previous match iff both its start positions
    equal the previous match's end positions), then minimize summed
    start-position distance. Returns (spans, chunks, matched_hyp_words,
    matched_ref_words).

    With no paraphrase candidates this defers to the word-level search."""
    phrase = (_phrase_candidates(hyp, ref, para_idx, max_plen)
              if para_idx else [])
    if not phrase:
        pairs, chunks = _meteor15_align(hyp, ref, syn_idx)
        spans = [(i, 1, j, 1, s) for i, j, s in pairs]
        return spans, chunks, len(pairs), len(pairs)

    cands = _meteor_candidates(hyp, ref, syn_idx)
    word_js = [{j for j, _ in row} for row in cands]
    by_start: List[list] = [[] for _ in hyp]
    for i, hl, j, rl in phrase:
        if hl == 1 and rl == 1 and j in word_js[i]:
            continue                 # 1-1 pair already has a word stage
        by_start[i].append((hl, j, rl))

    # state: (covered, chunks, dist, hyp_end, ref_end, ref_used_mask,
    #         next_free_hyp, spans); beam-pruned left to right in hyp
    states = [(0, 0, 0, -2, -2, 0, 0, ())]
    for i in range(len(hyp)):
        nxt = []
        for st in states:
            cov, ch, dist, he, re_, used, nh, spans = st
            if nh != i:              # a phrase match already covers i
                nxt.append(st)
                continue
            nxt.append((cov, ch, dist, he, re_, used, i + 1, spans))
            for j, stage in cands[i]:
                if used >> j & 1:
                    continue
                adj = (he == i) and (re_ == j)
                nxt.append((cov + 2, ch + (0 if adj else 1),
                            dist + abs(i - j), i + 1, j + 1,
                            used | (1 << j), i + 1,
                            spans + ((i, 1, j, 1, stage),)))
            for hl, j, rl in by_start[i]:
                rmask = ((1 << rl) - 1) << j
                if used & rmask:
                    continue
                adj = (he == i) and (re_ == j)
                nxt.append((cov + hl + rl, ch + (0 if adj else 1),
                            dist + abs(i - j), i + hl, j + rl,
                            used | rmask, i + hl,
                            spans + ((i, hl, j, rl, 3),)))
        nxt.sort(key=lambda s: (-s[0], s[1], s[2]))
        states = nxt[:_METEOR_BEAM]
    best = max(states, key=lambda s: (s[0], -s[1], -s[2]))
    spans = list(best[7])
    return (spans, best[1], sum(s[1] for s in spans),
            sum(s[3] for s in spans))


def meteor15(gts, res, alpha: float = 0.85, beta: float = 0.2,
             gamma: float = 0.6, delta: float = 0.75,
             weights=(1.0, 0.6, 0.8, 0.6), synonyms=None,
             function_words=None, paraphrases=None):
    """METEOR-1.5 scoring (the configuration the reference's
    pycocoevalcap jar runs: English rank task — alpha .85, beta .2,
    gamma .6, delta .75, module weights exact 1.0 / stem 0.6 /
    synonym 0.8 / paraphrase 0.6; evaluation.py:42).

    Weighted precision/recall with content/function-word delta
    weighting (a phrase match contributes each covered word at its
    module weight), harmonic Fmean, fragmentation penalty
    gamma·(ch/m)^beta with m = the matched-word count averaged over
    hyp and ref sides (equal for word-only alignments), best reference
    per segment, averaged over segments. All four jar matcher modules
    run; synonyms/function_words/paraphrases are pluggable
    (metrics/meteor_resources.py — the bundled paraphrase table is a
    domain mini-subset; `load_paraphrase_table` ingests the jar's
    60 MB paraphrase-en.gz for bit-parity users, pass
    `paraphrases=()` to disable the stage)."""
    from ekaid_torch.metrics.meteor_resources import (FUNCTION_WORDS,
                                                    paraphrase_index,
                                                    synonym_index)
    syn_idx = synonym_index(synonyms)
    para_idx, max_plen = paraphrase_index(paraphrases)
    fw = (FUNCTION_WORDS if function_words is None
          else frozenset(function_words))

    def dw(word):
        return delta if word not in fw else 1 - delta

    def wlen(tokens):
        nc = sum(1 for t in tokens if t not in fw)
        nf = len(tokens) - nc
        return delta * nc + (1 - delta) * nf

    scores = {}
    for img, cand in res.items():
        best = 0.0
        for ref in gts[img]:
            if not cand or not ref:
                continue
            spans, ch, mh, mr = _meteor15_align_spans(
                cand, ref, syn_idx, para_idx, max_plen)
            if not spans:
                continue
            wp = sum(weights[s] * sum(dw(cand[i + t]) for t in range(hl))
                     for i, hl, j, rl, s in spans)
            wr = sum(weights[s] * sum(dw(ref[j + t]) for t in range(rl))
                     for i, hl, j, rl, s in spans)
            p = wp / max(wlen(cand), 1e-9)
            r = wr / max(wlen(ref), 1e-9)
            if p + r == 0:
                continue
            fmean = p * r / (alpha * p + (1 - alpha) * r)
            pen = gamma * (ch / (0.5 * (mh + mr))) ** beta
            best = max(best, fmean * (1 - pen))
        scores[img] = best
    mean = sum(scores.values()) / max(len(scores), 1)
    return mean, scores


def meteor_lite(gts, res, alpha: float = 0.9, beta: float = 3.0,
                gamma: float = 0.5):
    """Exact+stem METEOR (the 2005 parameters); kept as the fast
    fallback scorer and for comparison against `meteor15` (the measured
    delta between the two is pinned in tests/test_metrics.py and
    recorded in docs/PARITY.md)."""
    scores = {}
    for img, cand in res.items():
        best = 0.0
        for ref in gts[img]:
            m, ch = _meteor_align(cand, ref)
            if m == 0 or not cand or not ref:
                continue
            p = m / len(cand)
            r = m / len(ref)
            fmean = p * r / (alpha * p + (1 - alpha) * r)
            frag = ch / m
            score = fmean * (1 - gamma * frag ** beta)
            best = max(best, score)
        scores[img] = best
    mean = sum(scores.values()) / max(len(scores), 1)
    return mean, scores
