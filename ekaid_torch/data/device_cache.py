"""Device-resident per-image feature cache for the eval decode
(counterpart of `ekaid_tpu/data/device_cache.py`).

The eval loop's heavy tensors are per image, not per QA pair, and a
study pair is asked several questions, so a cache on the card keyed by
feature-store row ships each image once: afterwards a batch sends only
its question tokens, its slot ids and the rows it misses.

  * four device tensors hold up to `capacity` images' post-slice
    records at the compact wire dtypes (feats f16, boxes f32, adjacency
    int8; see pipeline.compact_wire);
  * a batch's missing rows go up as one stacked host-to-device copy
    (from pinned memory on the card), padded to the next power of two
    rows, and are installed with one `index_copy_` each; the slot ids
    go up from pinned memory too, so resolving a batch never waits for
    the work queued on the device;
  * `gather_batch` builds the decode's [B, ...] inputs on the device by
    slot index: exactly the tensors the compact wire would carry.
Slots are assigned on the host, least recently used first out (never a
row of the batch being resolved). While a profiler records, each
batch's hits and misses are also added to the counters
`ekaid.cache.hits` and `ekaid.cache.misses` (`utils/observability`).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from ekaid_torch.utils.device import host_to_device
from ekaid_torch.utils.observability import count

__all__ = ["DeviceEvalCache"]


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


class DeviceEvalCache:
    """LRU cache of per-image eval features on `device`.

    cache = DeviceEvalCache(dataset, capacity=1024, device="cuda")
    d_slots, q_slots = cache.ensure(batch_pair_idxs)   # resolves misses
    batch = cache.gather_batch(cache.dev_arrays(), d_slots, q_slots, q)
    """

    def __init__(self, dataset, capacity: int = 1024, device="cuda"):
        if dataset.cfg.data.feature_mode == "mode0":
            raise ValueError("device cache holds graph features, not raw "
                             "pixels")
        self.ds = dataset
        self.cap = int(capacity)
        self.device = torch.device(device)
        self._slot_of: "OrderedDict[int, int]" = OrderedDict()  # LRU
        self._free = list(range(self.cap))
        self._dev = None          # (feats, bb, adj, sem) device tensors
        self.hits = 0
        self.misses = 0
        self.upload_bytes = 0

    def _read_rows(self, store_idxs: np.ndarray):
        rec = self.ds.store.get_batch(store_idxs)
        feats, bb, adj, sem = self.ds._slice_mode(rec)
        return (np.asarray(feats, np.float16),
                np.asarray(bb, np.float32),
                np.asarray(adj, np.int8),
                np.asarray(sem, np.int8))

    def ensure(self, pair_idxs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Resolve a batch of QA-pair indices to cache slots, uploading
        the images not resident. Returns (d_slots, q_slots), int64 [B]
        on the cache's device, into the tensors of `dev_arrays()`."""
        fi = self.ds.feature_idx[np.asarray(pair_idxs, np.int64)]  # [B,2]
        legs = fi.reshape(-1)
        uniq = list(dict.fromkeys(int(i) for i in legs))   # order-stable
        if len(uniq) > self.cap:
            raise ValueError(
                f"device cache capacity {self.cap} < {len(uniq)} unique "
                f"images in one batch; raise data.eval_device_cache")
        miss = []
        for i in uniq:
            if i in self._slot_of:
                self._slot_of.move_to_end(i)
            else:
                miss.append(i)
        self.hits += len(uniq) - len(miss)
        self.misses += len(miss)
        count("ekaid.cache.hits", len(uniq) - len(miss))
        count("ekaid.cache.misses", len(miss))
        if miss:
            in_batch = set(uniq)
            for i in miss:
                if self._free:
                    slot = self._free.pop()
                else:                      # evict the LRU not in this batch
                    old = next(o for o in self._slot_of if o not in in_batch)
                    slot = self._slot_of.pop(old)
                self._slot_of[i] = slot
            rows = self._read_rows(np.asarray(miss, np.int64))
            if self._dev is None:
                self._dev = tuple(
                    torch.zeros((self.cap,) + r.shape[1:],
                                dtype=torch.from_numpy(r[:1]).dtype,
                                device=self.device) for r in rows)
            m = len(miss)
            pm = _next_pow2(m)
            if pm != m:
                rows = tuple(np.concatenate(
                    [r, np.zeros((pm - m,) + r.shape[1:], r.dtype)])
                    for r in rows)
            self.upload_bytes += sum(r.nbytes for r in rows)
            slots = host_to_device(
                np.fromiter((self._slot_of[i] for i in miss), np.int64, m),
                self.device)
            for cache, r in zip(self._dev, rows):
                cache.index_copy_(0, slots,
                                  host_to_device(r, self.device)[:m])
        elif self._dev is None:
            raise RuntimeError("cache used before any upload")
        slot_arr = np.fromiter(
            (self._slot_of[int(i)] for i in legs), np.int64, len(legs)
        ).reshape(fi.shape)
        s = host_to_device(slot_arr, self.device)
        return s[:, 0], s[:, 1]

    def dev_arrays(self):
        """(feats [C, N, D] f16, bb [C, N, 4] f32, adj [C, P, P] int8,
        sem [C, P, P] int8) on the device."""
        if self._dev is None:
            raise RuntimeError("call ensure() first")
        return self._dev

    @staticmethod
    def gather_batch(dev, d_slots, q_slots, question) -> Dict:
        """The decode's input dict, gathered from the cache on the
        device."""
        feats, bb, adj, sem = dev
        return {
            "d_feats": feats[d_slots], "q_feats": feats[q_slots],
            "d_bb": bb[d_slots], "q_bb": bb[q_slots],
            "d_adj": adj[d_slots], "q_adj": adj[q_slots],
            "d_sem_adj": sem[d_slots], "q_sem_adj": sem[q_slots],
            "question": question,
        }

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": (self.hits / total) if total else 0.0,
                "upload_mb": round(self.upload_bytes / 2**20, 2),
                "resident": len(self._slot_of), "capacity": self.cap}
