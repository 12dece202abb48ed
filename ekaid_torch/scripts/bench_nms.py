"""NMS A/B on the card: the blocked NMS of `ops/nms.py` against K4.

Counterpart of the JAX package's `scripts/bench_nms.py`. Both
implementations run on one batch of random boxes (the reference
script's generator: centres U(100, 900), sizes U(20, 200), scores
U(0, 1), from a numpy seed) at the extraction's batch geometry (8
images x 1000 proposals, 100 kept, IoU 0.5 by default), each timed by
CUDA events over `--iters` calls after a warm-up call:

* `blocked`: `ops/nms.py::nms`, the NMS the extraction path runs, with
  its host reads per call (one per fixed-point iteration);
* `k4_cuda`: `ops/nms_kernel.py::nms_kernel`, one call for the batch
  (two CUDA kernels: the order, then the mask and the scan together).

Prints one JSON line for each, then the agreement of their kept sets,
which must be 1.0 (the script exits non-zero otherwise).

    python -m ekaid_torch.scripts.bench_nms [--iters 20] [--batch 8]
    python -m ekaid_torch.scripts.bench_nms --device cpu

Without a card the default device raises. On `--device cpu` both run
their plain versions (host clock), and the kernel's line says
`k4_plain`.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ekaid_torch.ops import nms as nms_ops
from ekaid_torch.ops.nms_kernel import nms_kernel
from ekaid_torch.utils.device import resolve_device


def make_inputs(batch: int, rois: int, seed: int = 0):
    """boxes [batch, rois, 4] and scores [batch, rois], f32 numpy."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(100, 900, (batch, rois, 2))
    sizes = rng.uniform(20, 200, (batch, rois, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2],
                           axis=-1).astype(np.float32)
    scores = rng.uniform(0, 1, (batch, rois)).astype(np.float32)
    return boxes, scores


def time_ms(fn, iters: int, dev: torch.device) -> float:
    """ms per call of `fn` over `iters` calls: CUDA events on a card, the
    host clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def kept_set_agreement(a, b) -> float:
    """Share of equal entries of the two sorted kept-index sets (invalid
    slots as -1), as the JAX package's script computes it."""
    def kept(idx, valid):
        return np.sort(np.where(valid.cpu().numpy(), idx.cpu().numpy(), -1),
                       -1)
    return float(np.mean(kept(*a) == kept(*b)))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--rois", type=int, default=1000)
    p.add_argument("--max_out", type=int, default=100)
    p.add_argument("--iou", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    dev = resolve_device(a.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    boxes_np, scores_np = make_inputs(a.batch, a.rois, a.seed)
    boxes = torch.as_tensor(boxes_np, device=dev)
    scores = torch.as_tensor(scores_np, device=dev)
    impls = {
        "blocked": lambda: nms_ops.nms(boxes, scores, a.iou, a.max_out),
        ("k4_cuda" if dev.type == "cuda" else "k4_plain"):
            lambda: nms_kernel(boxes, scores, a.iou, a.max_out),
    }
    lines, outs = [], []
    for impl, fn in impls.items():
        reads = nms_ops._survivor_mask.host_reads
        outs.append(fn())                       # warm-up and the result
        reads = nms_ops._survivor_mask.host_reads - reads
        ms = time_ms(fn, a.iters, dev)
        line = {"impl": impl, "device": name, "batch": a.batch,
                "rois": a.rois, "max_out": a.max_out, "iou": a.iou,
                "ms_per_batch": ms, "images_per_sec": a.batch / ms * 1e3}
        if impl == "blocked":
            line["host_reads_per_call"] = reads
        print(json.dumps(line), flush=True)
        lines.append(line)
    agree = kept_set_agreement(*outs)
    print(json.dumps({"kept_set_agreement": agree}), flush=True)
    if agree != 1.0:
        raise SystemExit(f"bench_nms: kept sets agree on {agree} only")
    return {"lines": lines, "kept_set_agreement": agree,
            "k4_calls": 1 + a.iters if dev.type == "cuda" else 0}


if __name__ == "__main__":
    main()
