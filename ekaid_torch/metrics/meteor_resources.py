"""Language resources of the METEOR-1.5 scorer (counterpart of
`ekaid_tpu/metrics/meteor_resources.py`).

  * FUNCTION_WORDS: the English function-word inventory of METEOR's
    delta weighting (closed-class words).
  * SYNONYMS: a small WordNet-synset subset covering general English and
    the answer vocabulary's domain; each inner set is one synset.
  * PARAPHRASES: a small phrase-pair table for the paraphrase module.

All three are pluggable in `meteor15(..., synonyms=, function_words=,
paraphrases=)`, e.g. `load_paraphrase_table('paraphrase-en.gz')`.
"""

from __future__ import annotations

FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both either
neither much many more most little less least few fewer enough such
what which who whom whose
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
ourselves themselves
in on at by for with about against between into through during before
after above below to from up down out off over under again further
of as
and or but nor so yet if because although though while whereas since
until unless when where how why whether than
be am is are was were been being
have has had having do does did doing
will would shall should may might must can could
not n't there here then once only also very too just
""".split())

# Each set is one synset. Curated from WordNet 3.0 synsets restricted
# to vocabulary plausible in chest-X-ray difference-VQA answers plus
# high-frequency general English.
SYNONYMS = [
    # general English
    {"big", "large"},
    {"small", "little"},
    {"image", "picture"},
    {"show", "demonstrate", "exhibit"},
    {"see", "observe"},
    {"area", "region", "zone"},
    {"middle", "center", "centre"},
    {"start", "begin"},
    {"stop", "halt"},
    {"new", "fresh"},
    {"same", "identical"},
    {"change", "alteration", "modification"},
    {"increase", "addition", "gain"},
    {"decrease", "diminution", "reduction"},
    {"improve", "better", "ameliorate"},
    {"worsen", "decline"},
    {"remove", "take"},
    {"patient", "affected"},
    # medical / radiology domain (WordNet noun synsets)
    {"disease", "illness", "sickness", "malady", "unwellness"},
    {"abnormality", "abnormalcy"},
    {"heart", "pump", "ticker"},
    {"chest", "thorax", "pectus"},
    {"bone", "os"},
    {"fluid", "liquid"},
    {"swelling", "puffiness", "lump"},
    {"infection", "contagion"},
    {"pneumonia", "pneumonic"},
    {"fracture", "break"},
    {"shadow", "shadowiness"},
    {"mass", "tumor", "tumour", "neoplasm", "growth"},
    {"nodule", "tubercle"},
    {"enlarged", "hypertrophied"},
    {"collapse", "collapsed"},
    {"scar", "cicatrix", "cicatrice"},
    {"tube", "tubing"},
    {"wire", "conducting"},
    {"device", "gimmick", "twist"},
    {"left", "leftover"},
    {"level", "degree", "grade"},
    {"location", "placement", "position", "locating"},
    {"type", "kind", "sort", "form"},
    {"present", "nowadays"},
    {"absent", "missing"},
    {"yes", "yeah"},
    {"no", "nope"},
    # adverbs (WordNet besides.r.02)
    {"also", "besides", "too", "likewise"},
]


# Paraphrase pairs (the jar's 4th matcher module, weight 0.6 in the
# English rank task). The jar ships data/paraphrase-en.gz (~60 MB,
# phrase pairs mined from parallel corpora); that artifact cannot be
# bundled, so this is a mini subset curated for the answer/report
# domain, and `load_paraphrase_table` ingests a full jar table for
# bit-parity users. Each entry is an unordered pair of phrases
# (whitespace-split into token tuples); matching is symmetric.
PARAPHRASES = [
    ("heart size", "cardiac silhouette"),
    ("enlarged heart", "cardiomegaly"),
    ("fluid in the lungs", "pulmonary edema"),
    ("pleural effusion", "fluid"),
    ("collapsed lung", "atelectasis"),
    ("air in the pleural space", "pneumothorax"),
    ("breathing tube", "endotracheal tube"),
    ("x ray", "radiograph"),
    ("chest x ray", "chest radiograph"),
    ("no change", "unchanged"),
    ("got better", "improved"),
    ("got worse", "worsened"),
    ("is present", "is seen"),
    ("left side", "left"),
    ("right side", "right"),
]


def paraphrase_index(pairs=None):
    """phrase (token tuple) -> set of pair ids, for the aligner's
    paraphrase stage. Two phrases match iff they share a pair id.
    Returns (index, max_phrase_len)."""
    idx = {}
    max_len = 1
    for pid, (a, b) in enumerate(pairs if pairs is not None
                                 else PARAPHRASES):
        for phrase in (a, b):
            toks = tuple(phrase.split() if isinstance(phrase, str)
                         else phrase)
            idx.setdefault(toks, set()).add(pid)
            max_len = max(max_len, len(toks))
    return idx, max_len


def load_paraphrase_table(path):
    """Read a METEOR paraphrase table into [(phrase, phrase)] for
    `meteor15(..., paraphrases=...)`.

    Accepts the jar's `paraphrase-en.gz` (gzip or plain). Field
    delimiter is auto-detected per line (`|||` or tab); purely numeric
    fields (translation probabilities some table builds carry) are
    dropped, and the first two remaining fields are the phrase pair.
    Lines with fewer than two phrase fields are skipped."""
    import gzip
    import io
    opener = gzip.open if str(path).endswith(".gz") else open
    pairs = []
    with opener(path, "rb") as fh:
        for raw in io.TextIOWrapper(fh, encoding="utf-8",
                                    errors="replace"):
            parts = (raw.split("|||") if "|||" in raw
                     else raw.split("\t"))
            fields = []
            for p in parts:
                p = p.strip()
                if not p:
                    continue
                try:
                    float(p)
                except ValueError:
                    fields.append(p)
            if len(fields) >= 2:
                pairs.append((fields[0], fields[1]))
    return pairs


def synonym_index(synsets=None):
    """word -> set of synset ids, for O(1) synonymy tests."""
    idx = {}
    for sid, syn in enumerate(synsets if synsets is not None
                              else SYNONYMS):
        for w in syn:
            idx.setdefault(w, set()).add(sid)
    return idx


def derive_vocab_synonyms(vocab_words, base=None):
    """Scope the synset table to an answer vocabulary.

    The jar loads full WordNet and lets any pair of words share a
    synset; for a closed answer vocabulary only synsets with >= 2
    members INSIDE the vocabulary can ever fire (both sides of every
    alignment are drawn from it). This derives that exact table:
    intersect each base synset with the vocab, drop singletons.

    `vocab_words` may be a vocab dict or any iterable of words."""
    base = SYNONYMS if base is None else base
    vw = set(vocab_words)
    scoped = [s & vw for s in base]
    return [s for s in scoped if len(s) >= 2]
