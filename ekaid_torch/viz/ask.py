"""Ask a free-form question about one study pair and sample answers
(counterpart of `ekaid_tpu/viz/ask.py`).

    python -m ekaid_torch.viz.ask --checkpoint_dir <snapshots> \
        --question "what has changed compared to the reference image?"
    python -m ekaid_torch.viz.ask --synthetic --device cpu \
        --cfg configs/smoke.yaml --question "w5 what" --n_samples 8

Takes a pair of the eval split, replaces its question with the
tokenized text (words outside the vocab are dropped), draws n answers
in one batch-n multinomial decode (plain torch), decodes the greedy
answer once with its module weights (on the card: the greedy decode
kernel, K1), prints the answer histogram and, with --out, draws it.
It runs on the CUDA device and raises without one, unless `--device
cpu` is asked for.
"""

from __future__ import annotations

import argparse
import os
from collections import Counter
from typing import Optional

import numpy as np
import torch

from ekaid_torch.data.vocab import treebank_tokenize
from ekaid_torch.utils.device import resolve_device


def ask_question(trainer, index: int, question_text: str,
                 n_samples: int = 32, seed: int = 0,
                 temperature: Optional[float] = None,
                 gumbel: Optional[torch.Tensor] = None):
    """Sample `n_samples` answers for (pair `index` of the eval split,
    free-form question). The draws come from a generator seeded with
    `seed` on the model's device, or are `gumbel` [T, n, V]. Returns a
    dict with the answers, their counts, the greedy answer and its
    module weights [T, 3], the ground-truth answer and the question's
    token ids."""
    ds, vocab, model = trainer.eval_ds, trainer.vocab, trainer.model
    s = dict(ds.sample(int(index)))
    tokens = treebank_tokenize(question_text)
    ids = [vocab.word_to_idx[t] for t in tokens if t in vocab.word_to_idx]
    q = np.zeros_like(s["question"])
    q[:len(ids)] = ids[:len(q)]
    s["question"] = q

    batch = {k: np.repeat(np.asarray(v)[None], n_samples, axis=0)
             for k, v in s.items() if k != "pair_index"}
    gen = None
    if gumbel is None:
        gen = torch.Generator(device=model.device).manual_seed(seed)
    seqs = model.decode(batch, sample_max=False, temperature=temperature,
                        gumbel=gumbel, gen=gen)["seq"].cpu().numpy()
    answers = [vocab.decode(row) for row in seqs]
    counts = Counter(answers)

    one = {k: v[:1] for k, v in batch.items()}
    out = model.decode(one)
    greedy = vocab.decode(out["seq"][0].cpu().numpy())
    return {"answers": answers, "counts": dict(counts), "greedy": greedy,
            "module_weights": out["module_weights"][0].cpu().numpy(),
            "gt_answer": vocab.decode(s["labels"][1:]),
            "question_ids": ids}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Ask a question about a test study pair")
    p.add_argument("--cfg", default=None)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--question", required=True)
    p.add_argument("--n_samples", type=int, default=32)
    p.add_argument("--out", default=None,
                   help="save the answer-distribution figure here")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    from ekaid_torch.config import default_config, load_config
    from ekaid_torch.train.train import (build_synthetic_trainer,
                                         build_trainer)
    cfg = load_config(a.cfg) if a.cfg else default_config()
    workdir = os.path.join("build", "ekaid_ask")
    if a.synthetic:
        trainer = build_synthetic_trainer(cfg, workdir, device=device)
    else:
        trainer = build_trainer(cfg, workdir, "test", device=device)
    if a.checkpoint_dir:
        from ekaid_torch.utils.checkpoint import CheckpointManager
        CheckpointManager(a.checkpoint_dir).restore(trainer.state,
                                                    name=a.checkpoint)

    res = ask_question(trainer, a.index, a.question,
                       n_samples=a.n_samples)
    print("greedy:", res["greedy"])
    print("gt:", res["gt_answer"])
    for ans, n in sorted(res["counts"].items(), key=lambda kv: -kv[1]):
        print(f"{n:4d}  {ans}")
    if a.out:
        from ekaid_torch.viz.draw import draw_answer_distribution
        draw_answer_distribution(res["counts"], save=a.out,
                                 title=a.question)
        print("saved", a.out)
    return res


if __name__ == "__main__":
    main()
