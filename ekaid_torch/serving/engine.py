"""Batch-1 inference engine (counterpart of the reference package's
`serving/server.py::InferenceEngine`).

`answer(question_text, index, detail)` tokenizes a free-form question
through the answer vocabulary (unknown words drop out), decodes it
greedily against the study pair `index` and returns the answer text.
Each pair's inputs are uploaded to the device once, at the compact wire
dtypes (features f16, adjacency labels int8), and kept in an LRU; only
the question row is uploaded per request. The model's parameters are
cast to the compute dtype once, weight-norm modules excepted.

    python -m ekaid_torch.serving.engine --n 8     # one JSON line each

The HTTP handler and the coalescing engine are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ekaid_torch.config import load_config
from ekaid_torch.data.synthetic import SyntheticPairStore
from ekaid_torch.data.vocab import identity_vocab, treebank_tokenize
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.utils.device import resolve_device
from ekaid_torch.utils.dtypes import Policy, cast_params_for_inference

#: pairs kept on the device (~0.6 MB each at flagship widths)
_CACHE_SIZE = 64
#: compact wire dtypes of the per-pair device upload
_WIRE = {"d_feats": np.float16, "q_feats": np.float16,
         "d_adj": np.int8, "q_adj": np.int8,
         "d_sem_adj": np.int8, "q_sem_adj": np.int8}


class InferenceEngine:
    """Answers questions about the pairs of `store` with `model`.

    Defaults: the answer vocabulary is the synthetic identity vocab, the
    store a `SyntheticPairStore`, and the model an `EkaidModel` with
    random weights from `seed` under the config's dtype policy. `device`
    defaults to CUDA and raises without a card unless 'cpu' is asked."""

    def __init__(self, cfg=None, model: Optional[EkaidModel] = None,
                 store=None, vocab=None, seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        self.cfg = cfg if cfg is not None else load_config()
        self.vocab = vocab or identity_vocab(self.cfg.speaker.vocab_size)
        self.store = store or SyntheticPairStore(self.cfg)
        policy = Policy.from_config(self.cfg.dtypes)
        self.model = model or EkaidModel(
            self.cfg, ntoken=len(self.vocab.word_to_idx), policy=policy,
            device=dev, seed=seed)
        cast_params_for_inference(self.model, self.model.policy)
        self.device = self.model.device
        self.index = int(self.store.split_idxs[0])
        self._cache: "OrderedDict[int, Dict[str, torch.Tensor]]" = \
            OrderedDict()
        self._cache_lock = threading.Lock()
        self.answer(None)                    # warm-up: builds the kernel

    def _dev_sample(self, index: int) -> Dict[str, torch.Tensor]:
        """The pair's inputs on the device, [1, ...], uploaded once per
        index and LRU-cached."""
        with self._cache_lock:
            hit = self._cache.get(index)
            if hit is not None:
                self._cache.move_to_end(index)
                return hit
        s = self.store.sample(index)
        hit = {k: torch.as_tensor(
                   np.asarray(v).astype(_WIRE.get(k, np.asarray(v).dtype))
                   [None], device=self.device)
               for k, v in s.items() if k != "labels"}
        with self._cache_lock:
            self._cache[index] = hit
            while len(self._cache) > _CACHE_SIZE:
                self._cache.popitem(last=False)
        return hit

    def question_to_ids(self, text: str) -> np.ndarray:
        ids = [self.vocab.word_to_idx[t] for t in treebank_tokenize(text)
               if t in self.vocab.word_to_idx]
        q = np.zeros(self.store.questions.shape[1], np.int64)
        q[:len(ids)] = ids[:len(q)]
        return q

    def _detail_fields(self, seq: np.ndarray, mw: np.ndarray) -> dict:
        """Per-token words and the [n, 3] bef/diff/aft module attention,
        trimmed to the generated length."""
        n = int(np.argmax(seq == 0)) if (seq == 0).any() else len(seq)
        tokens = [self.vocab.idx_to_word.get(int(i), "<unk>")
                  for i in seq[:n]]
        return {"tokens": tokens,
                "module_weights": np.asarray(mw[:n], np.float64
                                             ).round(4).tolist()}

    def answer(self, question_text: Optional[str],
               index: Optional[int] = None, detail: bool = False) -> dict:
        idx = self.index if index is None else int(index)
        qids = self.question_to_ids(question_text) if question_text else None
        t0 = time.perf_counter()
        batch = self._dev_sample(idx)
        if qids is not None:
            batch = dict(batch)
            batch["question"] = torch.as_tensor(
                qids.astype(np.int32)[None], device=self.device)
        out = self.model.decode(batch)
        seq = out["seq"][0].cpu().numpy()    # waits for the device
        res = {"answer": self.vocab.decode(seq), "index": idx,
               "latency_ms": round(1000 * (time.perf_counter() - t0), 2),
               "question_tokens": (qids[qids > 0].tolist()
                                   if qids is not None else None)}
        if detail:
            res.update(self._detail_fields(
                seq, out["module_weights"][0].cpu().numpy()))
        return res


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Answer questions over the synthetic pair store")
    p.add_argument("--cfg", default=None, help="YAML config overlay")
    p.add_argument("--n", type=int, default=4, help="questions to answer")
    p.add_argument("--seed", type=int, default=0, help="weight seed")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    engine = InferenceEngine(load_config(a.cfg), seed=a.seed,
                             device=resolve_device(a.device))
    idxs = engine.store.split_idxs
    for i in range(a.n):
        idx = int(idxs[i % len(idxs)])
        text = engine.vocab.decode(engine.store.questions[idx])
        print(json.dumps({"question": text,
                          **engine.answer(text, idx, detail=True)}))


if __name__ == "__main__":
    main()
