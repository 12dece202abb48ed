"""Host data pipeline: feature stores, the QA dataset, the threaded
loader (counterpart of `ekaid_tpu/data/pipeline.py`).

  * stores map an image index to its graph record (feats [N, F], bb
    [N, 4], adj and sem_adj [P, P]): HDF5 (`H5FeatureStore`, h5py
    imported when one is opened), synthetic per-index records, or
    in-memory arrays;
  * `DiffVQADataset` pairs QA rows with two store lookups and slices
    them by `data.feature_mode` (both / single_ana / single_loc, with
    the single_loc adjacency block swap); in the pixels-in mode0 a
    sample is the raw image pair from the dataset's `image_loader`,
    with no graph keys;
  * `Loader` assembles batches of numpy arrays in worker threads, in the
    single-threaded order, with a per-epoch shuffle seed, `skip_next`
    for an exact mid-epoch resume and `pad_final`. The threads build
    numpy only and never touch a device: the trainer copies a batch to
    the card in its own thread.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ekaid_torch.data.synthetic import synthetic_image
from ekaid_torch.data.vocab import Vocabulary
from ekaid_torch.native.bindings import native as _native
from ekaid_torch.ops.graph import spatial_adjacency


class FeatureStore:
    """index -> dict(feats [N,F], bb [N,4], adj [P,P], sem_adj [P,P])."""

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def get_batch(self, idxs) -> Dict[str, np.ndarray]:
        """Batched lookup: dict of [B, ...] arrays. Base implementation
        loops get(); stores with cheaper bulk reads override."""
        recs = [self.get(int(i)) for i in np.asarray(idxs).ravel()]
        return {k: np.stack([r[k] for r in recs]) for k in recs[0]}

    def __len__(self):
        raise NotImplementedError


class _RawRows:
    """Row reader for an uncompressed HDF5 dataset through an mmap.

    h5py serializes every read behind one lock; for unfiltered datasets
    the rows sit in the file as plain C-order bytes (contiguous, or in
    per-chunk blobs whose offsets `get_chunk_info` gives), so after one
    offset walk at open, row reads are copies out of a shared mmap
    (the native library's gather, off the GIL), safe from any number of
    worker threads."""

    def __init__(self, dset, mm: np.memmap):
        if (dset.compression is not None or dset.shuffle
                or dset.fletcher32 or dset.scaleoffset is not None):
            raise ValueError("filtered dataset")
        self.shape = dset.shape
        self.dtype = np.dtype(dset.dtype).newbyteorder("=")
        if np.dtype(dset.dtype) != self.dtype:
            raise ValueError("non-native byte order")
        self.row_shape = dset.shape[1:]
        rowelems = int(np.prod(self.row_shape, dtype=np.int64))
        self.rowbytes = rowelems * self.dtype.itemsize
        self.mm = mm
        if dset.chunks is None:
            off = dset.id.get_offset()
            if off is None:
                raise ValueError("no storage allocated")
            self.chunk_rows = dset.shape[0] or 1
            self.offsets = np.asarray([off], np.int64)
        else:
            if tuple(dset.chunks[1:]) != tuple(self.row_shape):
                raise ValueError("chunking splits rows")
            self.chunk_rows = dset.chunks[0]
            n0 = -(-dset.shape[0] // self.chunk_rows) if dset.shape[0] \
                else 1
            offs = np.full(n0, -1, np.int64)
            did = dset.id
            for i in range(did.get_num_chunks()):
                si = did.get_chunk_info(i)
                if si.filter_mask:
                    raise ValueError("filtered chunk")
                offs[si.chunk_offset[0] // self.chunk_rows] = \
                    si.byte_offset
            if (offs < 0).any():
                raise ValueError("unallocated chunks")
            self.offsets = offs

    def take(self, rows, out_dtype=None) -> np.ndarray:
        """Gather rows (any order, duplicates fine), cast to out_dtype
        when given. The native library's threaded gather copies them
        (int64 rows asked for as int32 narrow in the same pass); numpy
        slicing is the plain version."""
        rows = np.asarray(rows, np.int64).ravel()
        n = self.shape[0]
        rows = np.where(rows < 0, rows + n, rows)  # h5py semantics
        if len(rows) and (rows.min() < 0 or rows.max() >= n):
            raise IndexError(
                f"row index out of range for dataset of {n} rows")
        starts = (self.offsets[rows // self.chunk_rows]
                  + (rows % self.chunk_rows) * self.rowbytes)
        odt = np.dtype(out_dtype) if out_dtype is not None else self.dtype
        nat = _native()
        mm = self.mm            # the mapping stays alive across the call
        if nat is not None and odt == np.int32 and self.dtype == np.int64:
            rowelems = self.rowbytes // 8
            out = np.empty((len(rows), rowelems), np.int32)
            nat.gather_rows_i64_i32(mm.ctypes.data, starts, rowelems, out)
            return out.reshape(len(rows), *self.row_shape)
        out = np.empty((len(rows), self.rowbytes), np.uint8)
        if nat is not None:
            nat.gather_rows(mm.ctypes.data, starts, self.rowbytes, out)
        else:
            for i, s in enumerate(starts):
                out[i] = mm[s:s + self.rowbytes]
        res = out.view(self.dtype).reshape(len(rows), *self.row_shape)
        return res.astype(odt, copy=False) if out_dtype is not None \
            else res


class H5FeatureStore(FeatureStore):
    """Reads the graph file layout (image_features [M, 52, 1024],
    image_bb [M, 52, 4], image_adj_matrix and semantic_adj_matrix
    [M, 100, 100]). Unfiltered files take the lock-free `_RawRows` mmap
    path; anything else reads through h5py."""

    _KEYS = {"feats": "image_features", "bb": "image_bb",
             "adj": "image_adj_matrix", "sem_adj": "semantic_adj_matrix"}

    def __init__(self, path: str, allow_raw: bool = True):
        import h5py
        self.path = path
        self._h5 = h5py.File(path, "r")
        self.features = self._h5["image_features"]
        # f16-stored features stay f16 up to the device (the model casts
        # to its compute dtype at entry); the rest is f32 / int32
        feat_dt = (np.float16 if self.features.dtype == np.float16
                   else np.float32)
        self._DTYPES = {"feats": feat_dt, "bb": np.float32,
                        "adj": np.int32, "sem_adj": np.int32}
        self.bb = self._h5["image_bb"]
        self.adj = self._h5["image_adj_matrix"]
        self.sem_adj = self._h5["semantic_adj_matrix"]
        if self.features.shape[1] % 2:
            raise ValueError("image_features: an odd node count "
                             f"{self.features.shape[1]}")
        self.allow_raw = allow_raw
        self._raw = None
        if allow_raw:
            try:
                mm = np.memmap(path, np.uint8, "r")
                self._raw = {k: _RawRows(self._h5[v], mm)
                             for k, v in self._KEYS.items()}
            except (ValueError, OSError):
                self._raw = None

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        if self._raw is not None:
            return {k: self._raw[k].take([idx], self._DTYPES[k])[0]
                    for k in self._KEYS}
        return {
            "feats": np.asarray(self.features[idx], self._DTYPES["feats"]),
            "bb": np.asarray(self.bb[idx], np.float32),
            "adj": np.asarray(self.adj[idx], np.int32),
            "sem_adj": np.asarray(self.sem_adj[idx], np.int32),
        }

    def get_batch(self, idxs) -> Dict[str, np.ndarray]:
        """Raw path: direct mmap row gather, any order/duplicates.
        h5py path: one fancy-index read per dataset over the sorted
        unique indices, scattered back by the inverse permutation."""
        idxs = np.asarray(idxs, np.int64).ravel()
        if self._raw is not None:
            return {k: self._raw[k].take(idxs, self._DTYPES[k])
                    for k in self._KEYS}
        uniq, inv = np.unique(idxs, return_inverse=True)
        sel = uniq.tolist() if len(uniq) > 1 else int(uniq[0])
        out = {
            "feats": np.asarray(self.features[sel], self._DTYPES["feats"]),
            "bb": np.asarray(self.bb[sel], np.float32),
            "adj": np.asarray(self.adj[sel], np.int32),
            "sem_adj": np.asarray(self.sem_adj[sel], np.int32),
        }
        if len(uniq) == 1:
            return {k: np.broadcast_to(v, (len(idxs), *v.shape))
                    for k, v in out.items()}
        return {k: v[inv] for k, v in out.items()}

    def __len__(self):
        return self.features.shape[0]

    def clone(self) -> "H5FeatureStore":
        """Fresh handle for a worker thread. The raw-mmap path is
        lock-free and thread-safe, so it is shared as-is; only the
        h5py fallback needs a private file handle."""
        if self._raw is not None:
            return self
        return H5FeatureStore(self.path, allow_raw=self.allow_raw)


class SyntheticFeatureStore(FeatureStore):
    """Deterministic per-index synthetic records (`synthetic_image`)."""

    def __init__(self, cfg, n_images: int = 1024):
        self.cfg = cfg
        self.n = n_images

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        return synthetic_image(self.cfg, idx)

    def __len__(self):
        return self.n


class DiffVQADataset:
    """QA rows (questions, answers, pos, feature_idx: the two images of
    each pair) and their feature lookups, for one split."""

    def __init__(self, cfg, store: FeatureStore, split: str,
                 npz_path: Optional[str] = None,
                 splits_path: Optional[str] = None,
                 vocab: Optional[Vocabulary] = None,
                 arrays: Optional[Dict[str, np.ndarray]] = None,
                 image_loader=None):
        #: the mode0 (pixels-in) image source: image index -> [H, W]
        #: float (the reference model's data reads 128^2 PNGs)
        self.image_loader = image_loader
        self.cfg = cfg
        self.store = store
        self.split = split
        self.vocab = vocab
        if arrays is None:
            data = np.load(npz_path)
            arrays = {k: data[k] for k in data.files}
        self.questions = arrays["questions"]
        self.answers = arrays["answers"]
        self.pos = arrays["pos"]
        self.feature_idx = arrays["feature_idx"]
        if splits_path is not None:
            with open(splits_path) as f:
                self.split_idxs = np.asarray(json.load(f)[split], np.int64)
        else:
            n = len(self.questions)
            bounds = {"train": (0, int(np.ceil(0.8 * n))),
                      "val": (int(np.ceil(0.8 * n)), int(np.ceil(0.9 * n))),
                      "test": (int(np.ceil(0.9 * n)), n),
                      "all": (0, n)}[split]
            self.split_idxs = np.arange(*bounds, dtype=np.int64)
        split_cfg = getattr(cfg.data, split if split != "all" else "test")
        max_samples = split_cfg.max_samples
        if max_samples is not None:
            self.split_idxs = self.split_idxs[:max_samples]
        self.batch_size = split_cfg.batch_size
        self.seq_length = self.answers.shape[1]

    def __len__(self):
        return len(self.split_idxs)

    def sample(self, img_idx: int) -> Dict[str, np.ndarray]:
        if self.cfg.data.feature_mode == "mode0":
            return self._sample_mode0(img_idx, self.feature_idx[img_idx])
        return self._features_for(img_idx, self.feature_idx[img_idx])

    def _sample_mode0(self, img_idx: int, fi) -> Dict[str, np.ndarray]:
        """The pixels-in sample: the raw image pair with the labels and
        the question, and no graph keys."""
        if self.image_loader is None:
            raise ValueError("feature_mode=mode0 needs an image_loader "
                             "(idx -> [H, W])")
        out = self._labels_for(img_idx)
        out.update({
            "d_feats": np.asarray(self.image_loader(int(fi[0])), np.float32),
            "q_feats": np.asarray(self.image_loader(int(fi[1])), np.float32),
            "pair_index": np.int64(img_idx),
            "question": self.questions[img_idx].astype(np.int32)})
        return out

    def sample_batch(self, img_idxs) -> Dict[str, np.ndarray]:
        """Batch assembly: one store.get_batch per image leg and
        broadcast label/mask construction; equal to collating per-sample
        `sample` calls. mode0 collates the per-sample calls."""
        img_idxs = np.asarray(img_idxs, np.int64).ravel()
        if self.cfg.data.feature_mode == "mode0":
            return _collate([self.sample(int(i)) for i in img_idxs])
        fi = self.feature_idx[img_idxs]                      # [B, 2]
        d = self.store.get_batch(fi[:, 0])
        q = self.store.get_batch(fi[:, 1])
        d_feats, d_bb, d_adj, d_sem = self._slice_mode(d)
        q_feats, q_bb, q_adj, q_sem = self._slice_mode(q)

        B, T = len(img_idxs), self.seq_length
        labels = np.zeros((B, T + 1), np.int32)
        labels[:, :T] = self.answers[img_idxs]
        lengths = (labels != 0).sum(1) + 1   # tokens + one EOS slot
        masks = (np.arange(T + 1)[None] < lengths[:, None]
                 ).astype(np.float32)
        pos = np.zeros((B, T + 1), np.int32)
        pos[:, :T] = self.pos[img_idxs]
        return {
            "labels": labels, "pos": pos, "masks": masks,
            "d_feats": d_feats, "q_feats": q_feats,
            "pair_index": img_idxs,
            "d_adj": d_adj, "q_adj": q_adj,
            "d_sem_adj": d_sem, "q_sem_adj": q_sem,
            "d_bb": d_bb, "q_bb": q_bb,
            "question": self.questions[img_idxs].astype(np.int32),
        }

    def _labels_for(self, img_idx: int) -> Dict[str, np.ndarray]:
        T = self.seq_length
        labels = np.zeros(T + 1, np.int32)
        labels[:T] = self.answers[img_idx]
        mask = np.zeros(T + 1, np.float32)
        # tokens + one EOS slot
        mask[:int((labels != 0).sum()) + 1] = 1.0
        pos = np.zeros(T + 1, np.int32)
        pos[:T] = self.pos[img_idx]
        return {"labels": labels, "pos": pos, "masks": mask}

    def _slice_mode(self, rec):
        """feature_mode slicing, per sample or batched ([..., N, F] /
        [..., P, P]). single_loc takes feats from the location block and
        bb from the anatomy block, and moves adjacency block 3 to block
        1, as the reference model's data does."""
        mode = self.cfg.data.feature_mode
        n1 = self.cfg.data.node_one_num
        feats, bb = rec["feats"], rec["bb"]
        adj, sem = rec["adj"], rec["sem_adj"]
        if mode in ("both", "location"):
            return feats, bb, adj, sem
        if mode == "single_ana":
            return feats[..., :n1, :], bb[..., :n1, :], adj, sem
        if mode == "single_loc":
            adj = adj.copy()
            sem = sem.copy()
            for m in (adj, sem):
                m[..., :n1, :] = m[..., 2 * n1:3 * n1, :]
                m[..., :, :n1] = m[..., :, 2 * n1:3 * n1]
            return (feats[..., -n1:, :], bb[..., :n1, :], adj, sem)
        raise ValueError(f"unknown feature_mode {mode!r}")

    def _features_for(self, img_idx: int, fi):
        d = self.store.get(int(fi[0]))
        q = self.store.get(int(fi[1]))
        d_feats, d_bb, d_adj, d_sem = self._slice_mode(d)
        q_feats, q_bb, q_adj, q_sem = self._slice_mode(q)

        out = self._labels_for(img_idx)
        out.update({
            "d_feats": d_feats, "q_feats": q_feats,
            "pair_index": np.int64(img_idx),
            "d_adj": d_adj, "q_adj": q_adj,
            "d_sem_adj": d_sem, "q_sem_adj": q_sem,
            "d_bb": d_bb, "q_bb": q_bb,
            "question": self.questions[img_idx].astype(np.int32),
        })
        return out


def _collate(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


#: compact host->device dtypes (compact_wire): features as f16 (the
#: model casts every input to its compute dtype at first use), adjacency
#: labels (spatial 1..11, semantic 1..3) as int8; boxes stay f32, since
#: position_matrix takes log-ratios of raw coordinates.
_WIRE_COMPACT = {
    "d_feats": np.float16, "q_feats": np.float16,
    "d_adj": np.int8, "q_adj": np.int8,
    "d_sem_adj": np.int8, "q_sem_adj": np.int8,
}


def compact_wire(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Cast a host batch to the compact wire dtypes for the eval and
    serving host-to-device copy (2.3x fewer bytes at flagship dims).
    Training batches keep their full width."""
    out = dict(batch)
    for k, dt in _WIRE_COMPACT.items():
        if k in out:
            out[k] = np.asarray(out[k]).astype(dt, copy=False)
    return out


class Loader:
    """Threaded prefetching batch iterator."""

    def __init__(self, dataset: DiffVQADataset, batch_size: Optional[int]
                 = None, shuffle: bool = False, seed: int = 0,
                 drop_remainder: bool = True, pad_final: bool = False,
                 num_threads: Optional[int] = None, prefetch: int = 2,
                 shard_index: int = 0, num_shards: int = 1,
                 wire: str = "f32"):
        """pad_final=True keeps the remainder batch, padded to batch_size
        by repeating its last row (duplicate pair_index rows collapse in
        a predictions dict).

        shard_index/num_shards: each process iterates a disjoint
        1-in-num_shards slice of every epoch's (identically shuffled)
        order. wire="compact" casts batches to the compact dtypes in the
        worker threads (see compact_wire).
        """
        if wire not in ("f32", "compact"):
            raise ValueError(f"unknown wire {wire!r}")
        self.wire = wire
        self.ds = dataset
        self.batch_size = batch_size or dataset.batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder and not pad_final
        self.pad_final = pad_final
        # None or < 0: min(4, cpu_count); more threads than cores only
        # thrash
        if num_threads is None or num_threads < 0:
            num_threads = min(4, os.cpu_count() or 1)
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        # epoch feeds the shuffle RNG (seed + epoch) and is advanced by
        # each __iter__; a resuming trainer sets it to the restored
        # epoch so the permutation matches the original run's.
        self.epoch = 0
        # one-shot batch fast-forward for exact mid-epoch resume: the
        # next __iter__ drops this many leading batches BEFORE workers
        # start (no assembly cost for the skipped ones), then resets.
        self.skip_next = 0
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards}")
        self.shard_index = shard_index
        self.num_shards = num_shards

    def _shard_len(self):
        # every shard gets exactly n // k items (the < k leftover ones
        # are dropped each epoch), so shards stay in step
        return len(self.ds) // self.num_shards

    def __len__(self):
        n = self._shard_len() // self.batch_size
        if not self.drop_remainder and self._shard_len() % self.batch_size:
            n += 1
        return n

    def _epoch_order(self):
        order = np.asarray(self.ds.split_idxs)
        if self.shuffle:
            # same seed on every host -> identical permutation, disjoint
            # strided slices
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(order)
        if self.num_shards > 1:
            order = order[self.shard_index::self.num_shards]
            order = order[:len(self.ds) // self.num_shards]  # lockstep
        return order

    def _batch_indices(self):
        order = self._epoch_order()
        self.epoch += 1
        nb = len(order) // self.batch_size
        rem = len(order) % self.batch_size
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        if rem and not self.drop_remainder:
            tail = order[nb * self.batch_size:]
            if self.pad_final:
                pad = np.full(self.batch_size - rem, tail[-1],
                              dtype=tail.dtype)
                tail = np.concatenate([tail, pad])
            batches.append(tail)
        return batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Multi-worker assembly with deterministic order: worker w
        builds batches w, w+N, w+2N, … into its own bounded queue (each
        worker holds a private feature-store handle — h5py handles are
        not safe for concurrent reads); the consumer round-robins the
        queues, so batch order matches the single-threaded loader
        exactly and lookahead is bounded by prefetch per worker."""
        import copy

        batches = self._batch_indices()
        if self.skip_next:
            batches = batches[self.skip_next:]
            self.skip_next = 0
        n_workers = max(1, min(self.num_threads, len(batches) or 1))
        qs = [queue.Queue(maxsize=max(1, self.prefetch))
              for _ in range(n_workers)]
        stop = threading.Event()

        def worker(wid: int):
            ds = self.ds
            if n_workers > 1 and hasattr(ds.store, "clone"):
                ds = copy.copy(self.ds)
                ds.store = self.ds.store.clone()
            for bi in range(wid, len(batches), n_workers):
                if stop.is_set():
                    return
                try:
                    b = ds.sample_batch(batches[bi])
                    if self.wire == "compact":
                        b = compact_wire(b)
                    item = ("ok", b)
                except Exception as e:          # surface in the consumer
                    item = ("error", e)
                while not stop.is_set():
                    try:
                        qs[wid].put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if item[0] == "error":
                    return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(n_workers)]
        for t in threads:
            t.start()
        try:
            for bi in range(len(batches)):
                kind, payload = qs[bi % n_workers].get()
                if kind == "error":
                    raise payload
                yield payload
        finally:
            stop.set()


def trim_batch_to_bucket(batch: Dict[str, np.ndarray], buckets,
                         seq_length: int) -> Dict[str, np.ndarray]:
    """Trim the time axis of labels/pos/masks to the smallest length
    bucket that covers the batch's longest answer.

    The teacher-forcing loop length follows the labels shape, and steps
    past every row's EOS slot are masked out of the loss, so trimming
    gives the same loss and gradients while skipping those steps.
    `buckets` are loop lengths (e.g. (16, 32)); the full seq_length is
    the implicit fallback. Host-side numpy.
    """
    if not buckets:
        return batch
    # masks row sum = n_tokens + 2 (<start> + tokens + EOS slot);
    # steps needed = n_tokens + 1 (the EOS prediction's step)
    need = int(batch["masks"].sum(1).max()) - 1
    for b in sorted(set(int(b) for b in buckets)):
        if need <= b < seq_length:
            out = dict(batch)
            for k in ("labels", "pos", "masks"):
                if k in batch:
                    out[k] = batch[k][:, :b + 1]
            return out
    return batch


class ArrayFeatureStore(FeatureStore):
    """In-memory store over precomputed per-image arrays."""

    def __init__(self, rows: Dict[str, np.ndarray]):
        self.rows = rows

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        return {k: v[int(idx)] for k, v in self.rows.items()}

    def get_batch(self, idxs) -> Dict[str, np.ndarray]:
        idxs = np.asarray(idxs, np.int64)
        return {k: v[idxs] for k, v in self.rows.items()}

    def __len__(self):
        return len(next(iter(self.rows.values())))

    def clone(self) -> "ArrayFeatureStore":
        return self                       # ndarray reads are thread-safe


def learnable_dataset(cfg, split: str = "train", n_pairs: int = 4096,
                      n_images: int = 512, seed: int = 7
                      ) -> DiffVQADataset:
    """Synthetic corpus whose answers are deterministic functions of the
    image-pair features: learnable, unlike `synthetic_dataset`'s
    random-token answers, so eval Bleu_1 and answer accuracy can climb
    and best-checkpoint selection has a signal.

    Every image has one 'hot' node h = idx % num_nodes whose features
    are shifted by a class-specific pattern (4x a unit-scale random
    direction per h), so the class identity lives in the pooled feature
    content. Pairs alternate two question families:
      * open  ('what changed'-shaped): answer names BOTH hot nodes —
        tokens [10 + h_bef, 80 + h_aft % 26]; requires routing
        information from each image through the change encoder.
      * closed ('is there change'): yes(3)/no(4) by whether the two
        hot nodes coincide (pairs are drawn so ~half match).
    Generalization-testable: the train/test splits share the image
    pool but not the QA pairs, so a model that merely memorizes rows
    scores ~0 on eval while one that learns the rule scores ~1."""
    rng = np.random.default_rng(seed)
    d = cfg.data
    t = cfg.speaker.seq_length
    n_nodes, feat = d.num_nodes, d.feature_dim

    # --- image pool: N(0,1) + a class-coded hot-node pattern ---------
    feats = rng.standard_normal((n_images, n_nodes, feat)
                                ).astype(np.float32)
    hot = (np.arange(n_images) % n_nodes).astype(np.int64)
    patterns = rng.standard_normal((n_nodes, feat)).astype(np.float32)
    feats[np.arange(n_images), hot] += 4.0 * patterns[hot]
    x1 = rng.uniform(0, 800, (n_images, n_nodes))
    y1 = rng.uniform(0, 800, (n_images, n_nodes))
    w = rng.uniform(10, 500, (n_images, n_nodes))
    h = rng.uniform(10, 500, (n_images, n_nodes))
    bb = np.stack([x1, y1, np.minimum(x1 + w, 1024.0),
                   np.minimum(y1 + h, 1024.0)], -1).astype(np.float32)
    adj = np.zeros((n_images, d.adj_pad, d.adj_pad), np.int32)
    adj[:, :n_nodes, :n_nodes] = spatial_adjacency(bb)
    sem = np.zeros((n_images, d.adj_pad, d.adj_pad), np.int32)
    sem[:, :n_nodes, :n_nodes] = rng.integers(
        0, 3, (n_images, n_nodes, n_nodes))
    store = ArrayFeatureStore({"feats": feats, "bb": bb,
                               "adj": adj, "sem_adj": sem})

    # --- QA pairs ----------------------------------------------------
    bef = rng.integers(0, n_images, n_pairs)
    aft = rng.integers(0, n_images, n_pairs)
    same = rng.random(n_pairs) < 0.5       # ~half matching hot nodes
    for p in np.nonzero(same)[0]:
        cands = np.nonzero(hot == hot[bef[p]])[0]
        aft[p] = cands[rng.integers(0, len(cands))]
    feature_idx = np.stack([bef, aft], -1).astype(np.int64)

    tq = cfg.question.max_len
    questions = np.zeros((n_pairs, tq), np.int32)
    answers = np.zeros((n_pairs, t), np.int32)
    pos = np.zeros((n_pairs, t), np.int32)
    is_open = (np.arange(n_pairs) % 2) == 0
    questions[is_open, :3] = [5, 6, 7]            # 'what changed'
    questions[~is_open, :2] = [8, 9]              # 'is there change'
    hb, ha = hot[bef], hot[aft]
    answers[:, 0] = 1                             # <start>
    answers[is_open, 1] = 10 + hb[is_open]
    answers[is_open, 2] = 80 + (ha[is_open] % 26)
    answers[~is_open, 1] = np.where(hb[~is_open] == ha[~is_open], 3, 4)
    pos[:, :3] = 1
    arrays = {"questions": questions, "answers": answers, "pos": pos,
              "feature_idx": feature_idx}
    assert int(answers.max()) < cfg.speaker.vocab_size
    return DiffVQADataset(cfg, store, split, arrays=arrays)


def synthetic_dataset(cfg, split: str = "train", n_pairs: int = 512,
                      vocab_size: Optional[int] = None) -> DiffVQADataset:
    """A fully synthetic DiffVQADataset (no files on disk)."""
    rng = np.random.default_rng(42)
    v = vocab_size or cfg.speaker.vocab_size
    t = cfg.speaker.seq_length
    n = n_pairs
    questions = np.zeros((n, cfg.question.max_len), np.int32)
    answers = np.zeros((n, t), np.int32)
    pos = np.zeros((n, t), np.int32)
    for i in range(n):
        ql = rng.integers(3, cfg.question.max_len)
        questions[i, :ql] = rng.integers(1, v - 1, ql)
        al = rng.integers(2, max(3, t // 3))
        answers[i, 0] = 1
        answers[i, 1:al] = rng.integers(1, v - 1, al - 1)
        pos[i, :al] = rng.integers(1, 16, al)
    feature_idx = np.stack([rng.integers(0, 256, n),
                            rng.integers(0, 256, n)], -1).astype(np.int64)
    arrays = {"questions": questions, "answers": answers, "pos": pos,
              "feature_idx": feature_idx}
    store = SyntheticFeatureStore(cfg, n_images=256)
    return DiffVQADataset(cfg, store, split, arrays=arrays)
