"""Building the program under test (`ekaid_torch`) from a configuration
file, a corpus and a state dict, and the reference from the same.

A configuration file holds `overlay`, the program's config overlay in
the schema of `configs/*.yaml`, with every width written out, and
`image_size` for the pixels-in mode. `model_dims` reads the widths the
reference needs from the overlay alone, so both sides run the same
sizes and the reference never reads the program's defaults.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch

#: settings the reference implements; the overlay must state these
REQUIRED = {("train", "graph"): "all",
            ("change_detector", "branch_mix"): "sequential",
            ("change_detector", "dir_reduce"): "reference",
            ("change_detector", "dir_num"): 2,
            ("change_detector", "pair_batch"): "off",
            ("question", "att_mode"): "fixed",
            ("speaker", "decoding_constraint"): 0}


def merge(base: dict, extra: Optional[dict]) -> dict:
    out = copy.deepcopy(base)
    for k, v in (extra or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def model_dims(config: dict, overlay: dict) -> dict:
    """The reference's widths, read from the overlay (KeyError where the
    overlay leaves one to the program's defaults)."""
    for (sec, key), want in REQUIRED.items():
        if overlay[sec][key] != want:
            raise ValueError(f"{sec}.{key} = {overlay[sec][key]!r}: the "
                             f"reference implements {want!r}")
    cd, sp, d = overlay["change_detector"], overlay["speaker"], overlay["data"]
    if sp["input_dim"] != cd["att_dim"] or \
            sp["embed_input_dim"] != 3 * sp["input_dim"]:
        raise ValueError("speaker.input_dim must equal att_dim and "
                         "embed_input_dim 3 x input_dim")
    return {"setting": overlay["train"]["setting"],
            "att_dim": cd["att_dim"], "att_head": cd["att_head"],
            "nongt_dim": cd["nongt_dim"], "dim": cd["dim"],
            "spa_label_num": cd["spa_label_num"],
            "sem_label_num": cd["sem_label_num"],
            "pos_emb_dim": cd["pos_emb_dim"],
            "feature_dim": d["feature_dim"], "num_nodes": d["num_nodes"],
            "adj_pad": d["adj_pad"],
            "embed_dim": sp["embed_dim"], "rnn_size": sp["rnn_size"],
            "input_dim": sp["input_dim"], "pos_classes": sp["pos_classes"],
            "word_embed_size": sp["word_embed_size"],
            "vocab_size": sp["vocab_size"], "seq_length": sp["seq_length"],
            "drop_prob_lm": sp["drop_prob_lm"], "bos_token": sp["bos_token"],
            "question_len": overlay["question"]["max_len"],
            "image_size": config.get("image_size", 0),
            "trunk_depths": config.get("trunk_depths", (3, 4, 23, 3))}


def ntoken(dims: dict) -> int:
    """Question-vocabulary size of the identity vocabulary: the answer
    vocabulary less its NULL id."""
    return dims["vocab_size"] - 1


def reference(dims: dict, device, precision=None):
    from reference.model import F32, EkaidReference
    return EkaidReference(dims, ntoken(dims), precision or F32).to(device)


def control_reference(ctx, weights):
    """The control of a calibration (`ctx.control` 'fp8'): the reference
    in float8 e4m3 in the program's place; None in a benchmark run."""
    if ctx.control != "fp8":
        return None
    from reference.model import fp8
    low = reference(ctx.dims, ctx.device, fp8())
    low.load_state_dict(weights)
    return low.eval()


def program_config(overlay: dict, **train_over):
    from ekaid_torch.config import default_config, merge_overrides
    cfg = merge_overrides(default_config(), overlay)
    if train_over:
        cfg = cfg.replace(train=cfg.train.replace(**train_over))
    return cfg


def dataset(cfg, corpus: Dict[str, np.ndarray], rows=None):
    """The program's dataset over the corpus arrays, its split the given
    rows (all by default)."""
    from ekaid_torch.data.pipeline import ArrayFeatureStore, DiffVQADataset
    arrays = {k: corpus[k] for k in ("questions", "answers", "pos",
                                     "feature_idx")}
    if "images" in corpus:
        images = corpus["images"]
        store = ArrayFeatureStore({"images": images})
        ds = DiffVQADataset(cfg, store, "test", arrays=arrays,
                            image_loader=lambda i: images[i])
    else:
        store = ArrayFeatureStore({k: corpus[k] for k in
                                   ("feats", "bb", "adj", "sem_adj")})
        ds = DiffVQADataset(cfg, store, "test", arrays=arrays)
    n = len(corpus["questions"])
    ds.split_idxs = np.arange(n, dtype=np.int64) if rows is None \
        else np.asarray(rows, np.int64)
    return ds


def view(ds, rows):
    """The same dataset with another split."""
    out = copy.copy(ds)
    out.split_idxs = np.asarray(rows, np.int64)
    return out


def trainer(cfg, workdir: str, train_ds, eval_ds, weights, device):
    """The program's Trainer on the datasets, its parameters the given
    state dict (the program's own seeded init is skipped where the
    config's seed is None)."""
    from ekaid_torch.data.vocab import identity_vocab
    from ekaid_torch.train.train import Trainer
    tr = Trainer(cfg, workdir, train_ds, eval_ds,
                 identity_vocab(cfg.speaker.vocab_size), device=device)
    tr.model.load_state_dict(weights, strict=True)
    return tr


def detokenize_answer(text: str) -> list:
    """Token ids of an answer text of the identity vocabulary
    ('<start>' is 1, 'w<i>' is i)."""
    ids = []
    for w in text.split():
        if w == "<start>":
            ids.append(1)
        elif w.startswith("w") and w[1:].isdigit():
            ids.append(int(w[1:]))
        else:
            raise ValueError(f"word {w!r} is not in the vocabulary")
    return ids


def question_text(tokens) -> str:
    return " ".join(f"w{int(t)}" for t in tokens if int(t) > 1)


def free_cuda() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
