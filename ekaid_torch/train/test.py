"""Batch-inference driver (counterpart of `ekaid_tpu/train/test.py`).

Loads a checkpoint, decodes the chosen split (greedy: K1 on the card;
`--beam_size` > 1: beam search), writes the COCO-format results JSON
[{"caption", "image_id"}], and prints the wall clock ("Test took %.4f
seconds (%d pairs, %.2f pairs/s)") and each caption score.

    python -m ekaid_torch.train.test -p <snapshots> --checkpoint best
    python -m ekaid_torch.train.test --synthetic --max_batches 2
    python -m ekaid_torch.train.test --synthetic --device cpu \
        --cfg configs/smoke.yaml --max_batches 1
    python -m ekaid_torch.train.test --synthetic --profile build/prof
    torchrun --nproc_per_node 2 -m ekaid_torch.train.test -p <snapshots>

A checkpoint is the port's `<name>.pt` or the reference's orbax
directory `<name>/` (`utils/checkpoint.py`; the orbax form needs
tensorstore). It runs on the CUDA device and raises without one, unless
`--device cpu` is asked for. Under `torchrun` it runs on the trainer's
mesh (`train/train.py`): each rank restores the whole checkpoint, the
greedy decode splits every batch's rows over the data axis, and rank 0
alone prints, scores and writes the results.
`--profile DIR` traces the restore and the eval (rank 0's) with
torch.profiler into `DIR/trace.json` (`utils/observability.profile`),
the eval's spans (`ekaid.eval.*`, `ekaid.decode.*`) among its host
events.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from ekaid_torch.config import default_config, load_config
from ekaid_torch.parallel.mesh import init_from_env
from ekaid_torch.train.train import (Trainer, build_synthetic_trainer,
                                     build_trainer)
from ekaid_torch.utils.checkpoint import CheckpointManager
from ekaid_torch.utils.device import resolve_device
from ekaid_torch.utils.dtypes import Policy, cast_params_for_inference
from ekaid_torch.utils.observability import profile


def run_test(trainer: Trainer, checkpoint_dir: str = None,
             checkpoint_name=None, out_path: str = None,
             max_batches=None, beam_size: int = 1):
    """Restore `checkpoint_name` (default: the latest) from
    `checkpoint_dir` when given, cast the params for inference once,
    evaluate, print the time and scores and write the results JSON to
    `out_path`. Returns (scores, predictions)."""
    lead = trainer.lead
    if checkpoint_dir:
        trainer._refuse_lm("restoring a checkpoint")
        CheckpointManager(checkpoint_dir).restore(trainer.state,
                                                  name=checkpoint_name)
        if lead:
            print(f"Loaded checkpoint step {int(trainer.state.step)}")
    cast_params_for_inference(trainer.model,
                              Policy.from_config(trainer.cfg.dtypes))
    t0 = time.time()
    scores, predictions = trainer.evaluate(max_batches=max_batches,
                                           beam_size=beam_size)
    elapsed = time.time() - t0
    if not lead:
        return scores, predictions
    n = len(predictions)
    print("Test took %.4f seconds (%d pairs, %.2f pairs/s)"
          % (elapsed, n, n / max(elapsed, 1e-9)))
    for k, v in scores.items():
        print(f"{k}: {v:.3f}")
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump([{"caption": v, "image_id": k}
                       for k, v in predictions.items()], f)
        print(f"results saved to {out_path}")
    return scores, predictions


def main(argv=None):
    p = argparse.ArgumentParser(description="ekaid_torch batch inference")
    p.add_argument("-p", "--checkpoint_dir", default=None,
                   help="snapshots directory (none: fresh params)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint name or step inside the directory")
    p.add_argument("--cfg", default=None)
    p.add_argument("--split", default="test", choices=["test", "val"])
    p.add_argument("--graph", default="all")
    p.add_argument("--feature_mode", default="both")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--workdir", default=os.path.join("build", "ekaid_test"))
    p.add_argument("--beam_size", type=int, default=1,
                   help=">1 decodes with beam search")
    p.add_argument("--batch_size", type=int, default=None,
                   help="decode batch (default: the config's test batch)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to "
                        "DIR/trace.json")
    p.add_argument("overrides", nargs="*", metavar="KEY VALUE",
                   help="trailing dotted-key config overrides")
    a = p.parse_args(argv)
    # under torchrun: join the group, on cuda:LOCAL_RANK
    device = resolve_device(init_from_env(a.device))

    cfg = load_config(a.cfg) if a.cfg else default_config()
    if a.overrides:
        from ekaid_torch.config import merge_from_list
        cfg = merge_from_list(cfg, a.overrides)
    cfg = cfg.replace(train=cfg.train.replace(graph=a.graph),
                      data=cfg.data.replace(feature_mode=a.feature_mode))
    if a.batch_size:
        cfg = cfg.replace(data=cfg.data.replace(
            test=cfg.data.test.replace(batch_size=a.batch_size)))
    if a.synthetic:
        trainer = build_synthetic_trainer(cfg, a.workdir, device=device)
    else:
        trainer = build_trainer(cfg, a.workdir, a.split, device=device)
    out = a.out or os.path.join(a.workdir, f"test_results_{a.split}.json")
    traced = a.profile and trainer.lead
    with profile(a.profile) if traced else contextlib.nullcontext():
        run_test(trainer, a.checkpoint_dir, a.checkpoint, out,
                 a.max_batches, beam_size=a.beam_size)
    if trainer.mesh.distributed:
        trainer.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
