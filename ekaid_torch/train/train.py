"""The training loop and its entry point (counterpart of
`ekaid_tpu/train/train.py`).

    python -m ekaid_torch.train.train --synthetic --max_iter 100
    python -m ekaid_torch.train.train --synthetic --device cpu \
        --cfg configs/smoke.yaml --max_iter 4 --snapshot_interval 2
    torchrun --nproc_per_node 2 -m ekaid_torch.train.train --synthetic

The loop: per epoch the scheduled-sampling probability, then per batch
one `train_step`, a log line every `log_interval` steps, and every
`snapshot_interval` steps a checkpoint, a greedy-decode eval of the
eval split with the caption metrics and answer accuracy, and the best
checkpoint by Bleu_1. The eval decode is `EkaidModel.decode`, so on the
card it runs the greedy decode kernel (K1) on the weights of the
current step.

It runs on the CUDA device and raises without one, unless the caller
asks for the CPU (`device='cpu'`, `--device cpu`). Batches are built by
the loader's threads in numpy; the trainer copies the next one to the
card from pinned memory while the current step runs. The optimizer
state checkpoints with the parameters, and `--resume` continues from
the exact batch where the run stopped. `evaluate(beam_size > 1)`
decodes with beam search (`EkaidModel.decode_beam`, plain torch) from
the loader's wire batches.

With the LM answer decoder (the config's `decoder` 'lm',
`models/lm_decoder.py`) the trainer evaluates only: the question
encoder keeps the dataset's word vocabulary, the answers are the LM's
ids, detokenized through `answer_vocab` (`data/vocab.AnswerIds`), no
optimizer state is built, and `train`, snapshots and beam search are
refused.

The mesh: under `torchrun` (or any joined `torch.distributed` group)
the group's processes, one device each, form the data axis
(`parallel/mesh.py`): `mesh.data` is -1 or the world, and `mesh.model`
must be 1, else it raises. Every rank holds the whole model, which
trains in DDP over the group. Each rank reads `train.batch_size / data`
pairs a step: the Loader's shard d of `data` (the rank's index) takes
every data-th pair of the epoch's shuffled order, so the ranks' batches
of step i are together exactly the one-process batch i of
`train.batch_size` pairs, the reference's global batch. Length buckets
apply with one process only (each rank would pick its own). The loss is
the global batch's (`train/step.py`). At a snapshot every rank
evaluates: a greedy decode splits each eval batch's rows over the data
axis, each rank decodes its block (K1 on the card) and the blocks are
gathered (`EkaidModel.decode`); beam search decodes the whole batch on
every rank. Rank 0 alone detokenizes, scores, logs and writes snapshots and
the workdir's files; the ranks meet at a barrier after each snapshot.
The device image cache is off with more than one process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ekaid_torch.config import Config, default_config, load_config
from ekaid_torch.data.pipeline import (DiffVQADataset, H5FeatureStore,
                                       Loader, learnable_dataset,
                                       synthetic_dataset,
                                       trim_batch_to_bucket)
from ekaid_torch.data.vocab import AnswerIds, Vocabulary, identity_vocab
from ekaid_torch.metrics.coco import CaptionEvaluator, CocoCaptions
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.parallel import mesh as dp
from ekaid_torch.train.score import accuracy
from ekaid_torch.train.step import Forward, init_state, train_step
from ekaid_torch.utils.checkpoint import CheckpointManager
from ekaid_torch.utils.device import (HostCopy, host_to_device,
                                     resolve_device)
from ekaid_torch.utils.dtypes import Policy
from ekaid_torch.utils.logging import MetricsLogger
from ekaid_torch.utils.observability import span
from ekaid_torch.utils.platform import resolve_decode_kernel

__all__ = ["Trainer", "build_synthetic_trainer", "build_trainer",
           "identity_vocab", "main", "ss_prob_for_epoch"]


def ss_prob_for_epoch(cfg, epoch: int) -> float:
    """Scheduled-sampling ramp: 0 up to scheduled_sampling_start, then
    increase_prob more every increase_every epochs, up to max_prob."""
    t = cfg.train
    if t.scheduled_sampling_start < 0 or epoch <= t.scheduled_sampling_start:
        return 0.0
    frac = ((epoch - t.scheduled_sampling_start)
            // t.scheduled_sampling_increase_every)
    return min(t.scheduled_sampling_increase_prob * frac,
               t.scheduled_sampling_max_prob)


def to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy, pair_index dropped) as tensors on `device`."""
    return {k: host_to_device(v, device) for k, v in batch.items()
            if k != "pair_index"}


class Trainer:
    def __init__(self, cfg: Config, workdir: str,
                 train_ds: DiffVQADataset, eval_ds: DiffVQADataset,
                 vocab: Vocabulary, gt_annotations: Optional[dict] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.mesh = dp.make_mesh(cfg.mesh, self.device)
        self.lead = self.mesh.rank == 0
        if train_ds.batch_size % self.mesh.data:
            raise ValueError(f"train batch {train_ds.batch_size} does not "
                             f"split over the {self.mesh.data} ranks of "
                             "the data axis")
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        # the answer vocabulary's size comes from the data; the decode
        # kernel's name is resolved here, once ('auto' -> 'pallas')
        kernel = resolve_decode_kernel(cfg.speaker.decode_kernel)
        if self.lead:
            print(f"speaker.decode_kernel {cfg.speaker.decode_kernel!r} -> "
                  f"{kernel!r}", file=sys.stderr)
        self.cfg = cfg = cfg.replace(speaker=cfg.speaker.replace(
            vocab_size=vocab.size, decode_kernel=kernel))
        if self.lead:
            cfg.to_json(os.path.join(workdir, "cfg.json"))
        self.vocab = vocab
        lm = cfg.decoder == "lm"
        #: the words of the decoded answers
        self.answer_vocab = (AnswerIds(vocab, cfg.lm.vocab_size) if lm
                             else vocab)
        self.train_ds = train_ds
        self.eval_ds = eval_ds
        self.gt_annotations = gt_annotations
        self.model = EkaidModel(cfg, ntoken=len(vocab.word_to_idx),
                                policy=Policy.from_config(cfg.dtypes),
                                device=self.device, seed=cfg.train.seed,
                                mesh=(self.mesh if self.mesh.distributed
                                      else None))
        self.steps_per_epoch = max(1, len(train_ds) // train_ds.batch_size)
        # the LM decoder evaluates only: no optimizer state beside it
        self.state = None if lm else init_state(
            self.model, cfg.train.optim, self.steps_per_epoch)
        #: the DDP-wrapped training forward when a group is joined
        self.ddp = (dp.wrap(Forward(self.model), self.mesh)
                    if self.mesh.distributed and not lm else None)
        self.ckpt = CheckpointManager(os.path.join(workdir, "snapshots"))
        self.stop_requested = False
        self.best = self.ckpt.best_metric()
        self.logger = MetricsLogger(workdir)
        #: when set, each step's seconds (host clock, device synced)
        self.step_seconds: Optional[list] = None
        self._eval_cache = None
        if self.lead:
            self._dump_model_print()

    def install_preemption_handler(self):
        """SIGTERM/SIGINT: finish the step in flight, checkpoint, return
        from `train` (a second signal interrupts). With the exact
        mid-epoch resume, `--resume` continues from that batch."""
        import signal

        def _request_stop(signum, frame):
            if self.stop_requested:
                raise KeyboardInterrupt
            self.stop_requested = True
            print(f"signal {signum}: will checkpoint and exit after "
                  f"the current step")

        signal.signal(signal.SIGTERM, _request_stop)
        signal.signal(signal.SIGINT, _request_stop)

    def _dump_model_print(self):
        """<workdir>/model_print: each parameter's name, shape and dtype,
        and the total count."""
        lines, total = [], 0
        for name, p in self.model.named_parameters():
            lines.append(f"{name}  {tuple(p.shape)}  {p.dtype}")
            total += p.numel()
        lines.append(f"total parameters: {total:,}")
        with open(os.path.join(self.workdir, "model_print"), "w") as f:
            f.write("\n".join(lines) + "\n")

    # ------------------------------------------------------------ train ---

    def _refuse_lm(self, what: str) -> None:
        if self.state is None:
            raise NotImplementedError(
                f"{what} is refused with the LM decoder (decoder 'lm'): "
                "the trainer evaluates only")

    def train(self, log_every: Optional[int] = None,
              eval_fraction: Optional[int] = None) -> Dict:
        self._refuse_lm("training")
        cfg = self.cfg
        log_every = log_every or cfg.train.log_interval
        t = self.state.step
        epoch = t // self.steps_per_epoch
        last_metrics: Dict = {}
        data = self.mesh.data
        # each data rank's shard of every global batch (see the docstring)
        loader = Loader(self.train_ds,
                        batch_size=self.train_ds.batch_size // data,
                        shuffle=True, seed=cfg.train.seed,
                        num_threads=cfg.data.num_workers,
                        prefetch=cfg.data.prefetch,
                        shard_index=self.mesh.rank, num_shards=data)
        buckets = cfg.train.length_buckets if data == 1 else ()
        # exact mid-epoch resume: the restored epoch's permutation, less
        # the batches already taken
        loader.epoch = epoch
        if t % self.steps_per_epoch:
            loader.skip_next = t % self.steps_per_epoch

        def device_batches():
            """One ahead: the next batch's copy to the device is queued
            before the current batch is handed to the step."""
            nxt = None
            for batch in loader:
                batch = trim_batch_to_bucket(batch, buckets,
                                             cfg.speaker.seq_length)
                cur, nxt = nxt, to_device(batch, self.device)
                if cur is not None:
                    yield cur
            if nxt is not None:
                yield nxt

        while t < cfg.train.max_iter:
            ss_prob = ss_prob_for_epoch(cfg, epoch)
            for batch in device_batches():
                if self.stop_requested:
                    if self.lead:
                        self.ckpt.save(self.state, config_dict=cfg.to_dict())
                        print(f"preempted at iter {t}: checkpoint saved; "
                              f"resume with --resume")
                    return last_metrics
                it_start = time.time()
                metrics = train_step(
                    self.state, batch, cfg.train.seed,
                    cfg.train.att_reg_weight, ss_prob=ss_prob,
                    param_cast=cfg.dtypes.train_param_cast,
                    accum_steps=cfg.train.accum_steps,
                    entropy_weight=cfg.train.entropy_weight, ddp=self.ddp)
                if self.step_seconds is not None:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    self.step_seconds.append(time.time() - it_start)
                t += 1
                if t % log_every == 0 and self.lead:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["iter_time"] = time.time() - it_start
                    print(f"epoch {epoch} iter {t} "
                          + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
                    self.logger.log(t, m, prefix="train/")
                    last_metrics = m
                if t % cfg.train.snapshot_interval == 0:
                    self.snapshot_and_eval(t, max_batches=eval_fraction)
                    self.barrier()
                if t >= cfg.train.max_iter:
                    break
            epoch += 1
        return last_metrics

    def barrier(self) -> None:
        """Wait for every rank (nothing to wait for without a group)."""
        if self.mesh.distributed:
            torch.distributed.barrier()

    # ------------------------------------------------------------- eval ---

    def snapshot_and_eval(self, t: int,
                          max_batches: Optional[int] = None) -> Dict:
        """On every rank together: every rank evaluates; rank 0 alone
        writes, scores and logs (the other ranks return empty
        scores)."""
        self._refuse_lm("a snapshot")
        sd = self.state.state_dict()
        if self.lead:
            self.ckpt.save(sd, config_dict=self.cfg.to_dict())
        scores, predictions = self.evaluate(max_batches=max_batches)
        if not self.lead:
            return scores
        print(f"eval @ {t}: "
              + " ".join(f"{k}={v:.3f}" for k, v in scores.items()))
        self.logger.log(t, scores, prefix="eval/")
        out = os.path.join(self.workdir, "eval_sents")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"eval_results_{t}.json"), "w") as f:
            json.dump([{"caption": v, "image_id": k}
                       for k, v in predictions.items()], f)
        if scores.get("Bleu_1", 0.0) > self.best:
            self.best = scores["Bleu_1"]
            self.ckpt.save_best(sd, self.best,
                                config_dict=self.cfg.to_dict())
            print("Best checkpoint saved")
        return scores

    def _cached_batches(self, loader, cache_slots: int):
        """(pair indices, decode inputs) of each eval batch, gathered on
        the device from the image cache (kept across evals)."""
        from ekaid_torch.data.device_cache import DeviceEvalCache
        if self._eval_cache is None:
            self._eval_cache = DeviceEvalCache(
                self.eval_ds, capacity=cache_slots, device=self.device)
        cache = self._eval_cache
        for idxs in loader._batch_indices():
            with span("ekaid.eval.inputs"):
                d_slots, q_slots = cache.ensure(idxs)
                q = host_to_device(
                    self.eval_ds.questions[idxs].astype(np.int32),
                    self.device)
                batch = cache.gather_batch(cache.dev_arrays(), d_slots,
                                           q_slots, q)
            yield idxs, batch

    def _wire_batches(self, loader):
        """(pair indices, decode inputs) of each eval batch, from the
        loader's wire batches: the wait on its queue and the copy to the
        device in one span a batch."""
        it = iter(loader)
        while True:
            with span("ekaid.eval.inputs"):
                b = next(it, None)
                batch = None if b is None else to_device(b, self.device)
            if b is None:
                return
            yield b["pair_index"], batch

    def evaluate(self, max_batches: Optional[int] = None,
                 beam_size: int = 1, use_cache: Optional[bool] = None):
        """Greedy decode (beam search when beam_size > 1) over the eval
        split, then the caption metrics and answer accuracy. use_cache:
        feed the greedy decode from the device image cache (default:
        when data.eval_device_cache > 0) or from the loader's compact
        wire batches; both give the same tokens. Beam search reads the
        wire batches, and so does every eval with more than one process.
        Every rank of a mesh calls this together (the decodes are
        collectives); rank 0 alone detokenizes and scores, and the
        other ranks return ({}, {}). Under a profiler, spans name each
        batch's inputs, decode, fetch and detokenizing, and the scoring
        (`ekaid.eval.*`, `utils/observability.span`)."""
        cfg = self.cfg
        decode = self.model.decode
        if beam_size > 1:
            def decode(batch):
                return self.model.decode_beam(batch, beam_size=beam_size)
        loader = Loader(self.eval_ds, shuffle=False, pad_final=True,
                        num_threads=cfg.data.num_workers,
                        prefetch=cfg.data.prefetch, wire=cfg.data.eval_wire)
        if use_cache is None:
            use_cache = cfg.data.eval_device_cache > 0
        # the cache's slots are this process's: a mesh reads the wire
        use_cache = use_cache and self.mesh.data == 1
        # the cache holds graph features: mode0 reads the wire batches
        if use_cache and beam_size == 1 and cfg.data.feature_mode != "mode0":
            batches = self._cached_batches(
                loader, max(1, cfg.data.eval_device_cache))
        else:
            batches = self._wire_batches(loader)
        predictions: Dict[str, str] = {}

        def flush(pair_index, tokens):
            if tokens is None:
                return
            with span("ekaid.eval.fetch"):
                seqs = tokens.wait()
            with span("ekaid.eval.detok"):
                for j, row in enumerate(seqs):
                    predictions[str(int(pair_index[j]))] = \
                        self.answer_vocab.decode(row)

        # batch i's tokens are copied to the host right behind its
        # decode, and read only once batch i + 1 is queued: the read
        # waits for batch i alone while batch i + 1 runs on the device.
        # Ranks but the lead read nothing.
        pending = None
        for i, (idxs, batch) in enumerate(batches):
            if max_batches is not None and i >= max_batches:
                break
            with span("ekaid.eval.decode"):
                out = decode(batch)
                nxt = (idxs, HostCopy(out["seq"]) if self.lead else None)
            if pending is not None:
                flush(*pending)
            pending = nxt
        if pending is not None:
            flush(*pending)

        if not self.lead:
            return {}, predictions
        if not predictions:
            return {k: 0.0 for k in CaptionEvaluator.METRICS}, predictions
        with span("ekaid.eval.score"):
            gts = self._gt_annotations(predictions)
            res = CocoCaptions(annotations={"annotations": [
                {"image_id": k, "caption": v, "id": k}
                for k, v in predictions.items()]})
            scores = CaptionEvaluator(CocoCaptions(annotations=gts),
                                      res).evaluate()
            results = [{"image_id": k, "caption": v}
                       for k, v in predictions.items()]
            total, open_a, closed = accuracy(gts, results, verbose=False)
            scores.update({"acc_total": total, "acc_open": open_a,
                           "acc_closed": closed})
        return scores, predictions

    def _gt_annotations(self, predictions) -> dict:
        if self.gt_annotations is not None:
            keep = set(predictions)
            return {"annotations": [
                a for a in self.gt_annotations["annotations"]
                if str(a["image_id"]) in keep]}
        # synthetic: the ground truth is the dataset's own answer rows
        annos = []
        for k in predictions:
            caption = self.vocab.decode(self.eval_ds.answers[int(k)][1:])
            annos.append({"image_id": k, "id": k,
                          "caption": caption or "no change"})
        return {"annotations": annos}


def build_synthetic_trainer(cfg: Config, workdir: str, n_pairs: int = 512,
                            corpus: str = "random",
                            device="cuda") -> Trainer:
    """corpus 'random': random-token answers (the loss floors at their
    entropy). 'learnable': answers are functions of the pair's features
    (`learnable_dataset`), so eval Bleu_1 and accuracy can reach ~1."""
    vocab = identity_vocab(cfg.speaker.vocab_size)
    if corpus == "learnable":
        train_ds = learnable_dataset(cfg, "train", n_pairs=n_pairs * 8)
        eval_ds = learnable_dataset(cfg, "test", n_pairs=n_pairs * 8)
    else:
        train_ds = synthetic_dataset(cfg, "train", n_pairs=n_pairs)
        eval_ds = synthetic_dataset(cfg, "test", n_pairs=n_pairs)
    return Trainer(cfg, workdir, train_ds, eval_ds, vocab, device=device)


def build_trainer(cfg: Config, workdir: str, eval_target: str = "test",
                  device="cuda") -> Trainer:
    """The trainer over the data files the config names."""
    vocab = Vocabulary.load(cfg.data.vocab_json)
    store = H5FeatureStore(cfg.data.feature_h5)
    npz = os.path.join(os.path.dirname(cfg.data.vocab_json),
                       "vqa_dataset.npz")
    train_ds = DiffVQADataset(cfg, store, "train", npz_path=npz,
                              splits_path=cfg.data.splits_json, vocab=vocab)
    eval_ds = DiffVQADataset(cfg, store, eval_target, npz_path=npz,
                             splits_path=cfg.data.splits_json, vocab=vocab)
    with open(cfg.data.gt_captions % eval_target) as f:
        gt = json.load(f)
    return Trainer(cfg, workdir, train_ds, eval_ds, vocab,
                   gt_annotations=gt, device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description="ekaid_torch training")
    p.add_argument("--cfg", default=None, help="YAML config overlay")
    p.add_argument("--graph", default="all",
                   choices=["implicit", "semantic", "spatial", "all",
                            "i+s"])
    p.add_argument("--feature_mode", default="both",
                   choices=["both", "location", "single_ana", "single_loc"])
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--entropy_weight", type=float, default=None,
                   help="module-attention entropy bonus weight (default 0)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--eval_target", default="test", choices=["test", "val"])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_corpus", default="random",
                   choices=["random", "learnable"],
                   help="'learnable': answers are functions of the pair "
                        "features, so eval Bleu_1 can climb")
    p.add_argument("--max_iter", type=int, default=None)
    p.add_argument("--snapshot_interval", type=int, default=None)
    p.add_argument("--workdir", default=None)
    p.add_argument("--eval_batches", type=int, default=None,
                   help="cap eval batches per snapshot")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest snapshot in the workdir, "
                        "optimizer state included")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("overrides", nargs="*", metavar="KEY VALUE",
                   help="trailing dotted-key config overrides, e.g. "
                        "train.accum_steps 2 speaker.remat dots")
    a = p.parse_args(argv)
    # under torchrun: join the group, on cuda:LOCAL_RANK
    device = resolve_device(dp.init_from_env(a.device))

    cfg = load_config(a.cfg) if a.cfg else default_config()
    if a.overrides:
        from ekaid_torch.config import merge_from_list
        cfg = merge_from_list(cfg, a.overrides)
    train_over = {"graph": a.graph}
    if a.entropy_weight is not None:
        train_over["entropy_weight"] = a.entropy_weight
    if a.lr is not None:
        train_over["optim"] = cfg.train.optim.replace(lr=a.lr)
    if a.seed is not None:
        train_over["seed"] = a.seed
    if a.max_iter is not None:
        train_over["max_iter"] = a.max_iter
    if a.snapshot_interval is not None:
        train_over["snapshot_interval"] = a.snapshot_interval
    cfg = cfg.replace(train=cfg.train.replace(**train_over),
                      data=cfg.data.replace(feature_mode=a.feature_mode))

    exp = f"mode2_{a.feature_mode}_{a.graph}_{cfg.train.optim.lr}"
    workdir = a.workdir or os.path.join(cfg.exp_dir, "temp", exp)
    if a.synthetic:
        trainer = build_synthetic_trainer(cfg, workdir,
                                          corpus=a.synthetic_corpus,
                                          device=device)
    else:
        trainer = build_trainer(cfg, workdir, a.eval_target, device=device)
    if a.resume and trainer.ckpt.latest_step() is not None:
        trainer.ckpt.restore(trainer.state)
        print(f"resumed from step {trainer.state.step}")
    trainer.install_preemption_handler()
    trainer.train(eval_fraction=a.eval_batches)
    # preempted: the checkpoint is saved; skip the final eval
    if not trainer.stop_requested:
        trainer.snapshot_and_eval(trainer.state.step,
                                  max_batches=a.eval_batches)
    if trainer.mesh.distributed:
        trainer.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
