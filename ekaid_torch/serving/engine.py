"""Batch-1 inference engine (counterpart of the reference package's
`serving/server.py::InferenceEngine`).

`InferenceEngine(trainer)` answers questions about the pairs of the
trainer's eval split with the trainer's model, whose parameters it casts
to the compute dtype once (weight-norm modules excepted).
`answer(question_text, index, detail)` tokenizes a free-form question
through the answer vocabulary (unknown words drop out), pads it to the
dataset's question width, decodes it greedily against study pair
`index` (K1 on the card) and returns the answer text, with the tokens
and the module weights trimmed at EOS when `detail` is asked. Each
pair's inputs are uploaded to the device once, at the compact wire
dtypes (`data/pipeline.py::compact_wire`), and kept in an LRU under a
lock; only the question row is uploaded per request. Decodes run one at
a time per device (a lock around the launch): K1 is one cooperative
kernel that fills the card.

`InferenceEngine(trainer, artifact=...)` serves from a serving artifact
(`serving/artifact.py`): it checks the dataset's sample shapes against
the export's, takes the artifact's inference-cast weights, decodes at
batch 1 only if the artifact exported it, and uploads the full-width
inputs the export recorded (no compact wire), as the reference does.

    python -m ekaid_torch.serving.engine --n 8     # one JSON line each

The HTTP server and the coalescing engine are `serving/server.py`.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ekaid_torch.config import default_config, load_config
from ekaid_torch.data.pipeline import compact_wire
from ekaid_torch.data.vocab import treebank_tokenize
from ekaid_torch.serving.artifact import greedy
from ekaid_torch.utils.dtypes import cast_params_for_inference

#: pairs kept on the device (~0.6 MB each at flagship widths)
_CACHE_SIZE = 64
#: sample fields the decode does not read
_NOT_INPUTS = ("pair_index", "labels", "masks")


class InferenceEngine:
    """Answers questions about `trainer.eval_ds` with `trainer.model` on
    the model's device. `seed` drives `refresh`; `image_dir` holds the
    PNGs that `image_bytes` serves; `artifact`, a loaded serving
    artifact, gives the weights and the exported batch sizes."""

    def __init__(self, trainer, seed: int = 0,
                 image_dir: Optional[str] = None, artifact=None):
        self.trainer = trainer
        self.vocab = trainer.vocab
        self.answer_vocab = trainer.answer_vocab
        self.ds = trainer.eval_ds
        self.model = trainer.model
        self.rng = random.Random(seed)
        self.index = int(self.ds.split_idxs[0])
        self.image_dir = image_dir
        self.artifact = artifact
        cast_params_for_inference(self.model, self.model.policy)
        if artifact is not None:
            artifact.check_sample({k: v for k, v in
                                   self.ds.sample(self.index).items()
                                   if k != "pair_index"})
            artifact.load_into(self.model)
            self._decode1 = artifact.fn_for_batch(1)
            self._wire = dict              # the export's full width
        else:
            self._decode1 = greedy
            self._wire = compact_wire
        self.device = self.model.device
        self.decode_kernel = self.model.cfg.speaker.decode_kernel
        print(f"engine: speaker.decode_kernel {self.decode_kernel!r} on "
              f"{self.device}", file=sys.stderr)
        self._dev_cache: "OrderedDict[int, Dict[str, torch.Tensor]]" = \
            OrderedDict()
        self._dev_cache_lock = threading.Lock()
        self._decode_lock = threading.Lock()
        # warm-up on the batch-1 path: builds K1 and packs its weights
        InferenceEngine.answer(self, None)

    def _dev_sample(self, index: int) -> Dict[str, torch.Tensor]:
        """The pair's decode inputs on the device, [1, ...], uploaded
        once per index at the compact wire dtypes (full width from an
        artifact) and LRU-cached."""
        with self._dev_cache_lock:
            hit = self._dev_cache.get(index)
            if hit is not None:
                self._dev_cache.move_to_end(index)
                return hit
        # built and uploaded outside the lock: a duplicate upload of the
        # same index is harmless (both are equal; the last one stays)
        s = self._wire(self.ds.sample(index))
        hit = {k: torch.as_tensor(np.asarray(v)[None], device=self.device)
               for k, v in s.items() if k not in _NOT_INPUTS}
        with self._dev_cache_lock:
            self._dev_cache[index] = hit
            while len(self._dev_cache) > _CACHE_SIZE:
                self._dev_cache.popitem(last=False)
        return hit

    def _batch_for(self, index: int, question_ids: Optional[np.ndarray]):
        batch = self._dev_sample(index)
        if question_ids is not None:
            batch = dict(batch)
            batch["question"] = torch.as_tensor(
                question_ids.astype(np.int32)[None], device=self.device)
        return batch

    def question_to_ids(self, text: str) -> np.ndarray:
        ids = [self.vocab.word_to_idx[t] for t in treebank_tokenize(text)
               if t in self.vocab.word_to_idx]
        q = np.zeros(self.ds.questions.shape[1], np.int64)
        q[:len(ids)] = ids[:len(q)]
        return q

    def refresh(self) -> int:
        """A new random pair of the split becomes the current one."""
        self.index = int(self.rng.choice(list(self.ds.split_idxs)))
        return self.index

    def _detail_fields(self, seq: np.ndarray,
                       mw: Optional[np.ndarray]) -> dict:
        """Per-token words and the [n, 3] bef/diff/aft module attention,
        trimmed to the generated length."""
        tokens = self.answer_vocab.decode(seq).split()
        n = len(tokens)
        weights = (np.asarray(mw[:n], np.float64).round(4).tolist()
                   if mw is not None else None)
        return {"tokens": tokens, "module_weights": weights}

    def answer(self, question_text: Optional[str],
               index: Optional[int] = None, detail: bool = False) -> dict:
        idx = self.index if index is None else int(index)
        qids = self.question_to_ids(question_text) if question_text else None
        t0 = time.time()
        batch = self._batch_for(idx, qids)
        with self._decode_lock:
            out = self._decode1(self.model, batch)
        seq = out["seq"][0].cpu().numpy()    # waits for the device
        res = {"answer": self.answer_vocab.decode(seq), "index": idx,
               "latency_ms": round(1000 * (time.time() - t0), 2),
               "question_tokens": (qids[qids > 0].tolist()
                                   if qids is not None else None)}
        if detail:
            mw = out.get("module_weights")
            res.update(self._detail_fields(
                seq, None if mw is None else mw[0].cpu().numpy()))
        return res

    def sample_info(self, index: Optional[int] = None) -> dict:
        idx = self.index if index is None else int(index)
        s = self.ds.sample(idx)
        return {"index": idx,
                "question": self.vocab.decode(s["question"]),
                "gt_answer": self.vocab.decode(s["labels"][1:])}

    def image_bytes(self, index: Optional[int] = None,
                    which: str = "main") -> bytes:
        """PNG bytes of one image of the pair ('main' or the reference
        image), from `image_dir`/<feature row>.png."""
        if self.image_dir is None:
            raise FileNotFoundError("server started without --image_dir")
        idx = self.index if index is None else int(index)
        col = 0 if which == "main" else 1
        img_row = int(self.ds.feature_idx[idx][col])
        with open(os.path.join(self.image_dir, f"{img_row}.png"), "rb") as f:
            return f.read()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Answer questions over the synthetic eval split")
    p.add_argument("--cfg", default=None, help="YAML config overlay")
    p.add_argument("--n", type=int, default=4, help="questions to answer")
    p.add_argument("--workdir", default=os.path.join("build",
                                                     "ekaid_engine"))
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    a = p.parse_args(argv)
    from ekaid_torch.train.train import build_synthetic_trainer
    cfg = load_config(a.cfg) if a.cfg else default_config()
    engine = InferenceEngine(build_synthetic_trainer(cfg, a.workdir,
                                                     device=a.device))
    idxs = engine.ds.split_idxs
    for i in range(a.n):
        idx = int(idxs[i % len(idxs)])
        text = engine.vocab.decode(engine.ds.questions[idx])
        print(json.dumps({"question": text,
                          **engine.answer(text, idx, detail=True)}))


if __name__ == "__main__":
    main()
