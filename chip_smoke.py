#!/usr/bin/env python3
"""Drive the PyTorch port (`ekaid_torch`) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root

Phases, each fatal on failure:
  1. the card's name and power limit;
  2. build every CUDA kernel from `ekaid_torch/csrc/`;
  3. the greedy decode kernel (K1) against its plain-torch version at
     flagship width (E=D=1024, R=512, W=300, V=148, T=90), random
     weights from a seed, at B=64, 5 and 1 (5 and 1 fill a 16-row tile
     only partly; 1 is the engine's batch): f32 token-exact (plain,
     forced early exit, decoding constraint), then bf16 at B=64, 5, 1
     and 80 (two row groups of K1's units, the second partial): finite,
     step-0 tokens equal, a small step-0 logprob gap, agreement
     measured; two bf16 decodes at B=64 bit-equal (the split-K sums
     run in a fixed order); one-step decodes (`scratch=True`) whose
     per-phase intermediates are held against the plain version's:
     f32 within 1e-5 of each tensor's largest magnitude, bf16 gaps in
     ulps recorded, zx and h_mod within 2 ulps;
  4. the main path: an `EkaidModel` at flagship width under the bf16
     policy behind the batch-1 `InferenceEngine`, answering questions
     over the synthetic pair store, then one batch-64 decode; the
     kernel's launch count must equal the number of decodes, and each
     answer is held against the plain version on the same inputs;
  5. timings of the kernel, its plain version, its bound, the batch-64
     decode and the batch-1 answer;
  6. the ROIAlign kernels K2 (canvas) and K3 (patch) against their
     plain versions on the pyramid and proposals of a flagship
     extraction batch (8 synthetic uint8 1024^2 images, the anatomy
     detector with random weights from the seed), with an elongated ROI
     that takes the level bump, at 1000 and 997 ROIs per image: f32 max
     abs error <= 1e-5, bf16 within one bf16 ulp (equal share recorded);
  7. the extraction path: `extract.runner.build_detector_fns` +
     `Extractor` over 3 batches of 8 at 1024^2, bf16, records written
     to an in-memory sink; every record is checked, and K2 must launch
     twice a batch (anatomy + disease detector); then one batch with
     roi_backend 'pallas', where K3 must launch twice;
  8. timings: K2 and K3 per call (CUDA events around the launch alone,
     the profiler's device time, the whole wrapper with its geometry,
     the launch on f32 maps) beside their plain versions and their
     bounds from the map positions these ROIs read, extraction images/s
     end to end (host clock, records fetched), backbone ms per batch
     and a per-stage breakdown;
  9. greedy NMS: the kernel K4 against its plain version and the
     blocked NMS (`ops/nms.py::nms`) at f32, selections equal in order,
     at the bench geometry (8 images x 1000 boxes, 100 slots, IoU 0.5),
     on a hard set (ties, duplicate, zero-area and inverted boxes,
     padding rows, an image with nothing live, more slots than live
     rows, R not a multiple of 32, B=1) and at the extraction geometry
     (the level-offset proposals that `generate_proposals` hands to
     `batched_nms` on a flagship batch: 4,768 rows an image, IoU 0.7,
     1000 slots); then the NMS A/B entry point
     (`ekaid_torch.scripts.bench_nms`) through its `main`, where K4
     must launch once a call; then times at both geometries (K4's
     launch alone by CUDA events and by torch.profiler, the plain
     version, the blocked NMS with its host reads) beside K4's bound
     and its serial depth.
Prints one `kernels` JSON line, the card line, and as the last line
{"ok": true, "device": {...}}, after a `record:` line with every number
as JSON. Without a CUDA device, or outside the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {"float32": 67e12,      # f32 outside the tensor cores
            "bfloat16": 989e12}    # dense bf16 tensor cores
F32_GATES = {"logprobs": 1e-4, "module_weights": 1e-5}
# bf16 sums in another order flip roundings and later tokens may differ;
# at step 0 only the order of the f32 sums differs, so its tokens must
# be equal and its logprobs close
BF16_STEP0_GAP = 1e-3
BATCHES = (64, 5, 1)
BF16_GROUPS_B = 80                 # two row groups of K1's units
BF16_BATCHES = BATCHES + (BF16_GROUPS_B,)
# one-step intermediates: f32 relative to the plain tensor's largest
# magnitude; bf16 zx and h_mod, whose step-0 inputs are equal in both
ONE_STEP_F32 = 1e-5
BF16_STEP0_ULPS = 2
ROI_F32_GATE = 1e-5                # K2/K3 vs plain, f32 max abs error
EXTRACT_BATCHES = 3
# ROIs whose long side takes the level bump (on a 1024^2 image)
ELONGATED_ROIS = ((0.0, 300.0, 1000.0, 350.0), (100.0, 0.0, 160.0, 900.0))
# K4's IoU pass, f32 operations per live row and step: iw and ih (min,
# max, subtract, clamp each), the product, the union (add, subtract),
# the quotient, the threshold test and the arg-max comparison
NMS_OPS_PER_ROW = 14


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiler_kernel_ms(fn, kernel_name: str, reps: int = 10):
    """Device time per call of the CUDA kernels whose name holds
    `kernel_name`, from a torch.profiler trace of `reps` calls of `fn`;
    None where the trace shows no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if kernel_name in e.key:
            us += (getattr(e, "device_time_total", 0)
                   or getattr(e, "cuda_time_total", 0))
    return us / reps / 1e3 if us else None


def steps_run(seq) -> int:
    """Steps the loop ran: one past the last step any row emitted."""
    live = (seq > 0).any(dim=0).nonzero()
    return min(seq.shape[1], int(live.max()) + 2) if len(live) else 1


def compare(ref, out, what: str) -> dict:
    import torch
    if not torch.equal(ref["seq"], out["seq"]):
        bad = (ref["seq"] != out["seq"]).sum().item()
        raise AssertionError(f"{what}: seq differs in {bad} tokens")
    errs = {}
    for k, tol in F32_GATES.items():
        errs[k] = (ref[k] - out[k]).abs().max().item()
        if errs[k] > tol:
            raise AssertionError(f"{what}: {k} max abs err {errs[k]} > {tol}")
    log(f"  {what}: seq exact, steps {steps_run(out['seq'])}, logprobs err "
        f"{errs['logprobs']:.3g}, module_weights err "
        f"{errs['module_weights']:.3g}")
    return errs


def bf16_agreement(ref, out, what: str) -> dict:
    """Finite outputs, equal step-0 tokens and a step-0 logprob gap of at
    most BF16_STEP0_GAP; returns the share of equal tokens and the gap."""
    import torch
    for k in ("logprobs", "module_weights"):
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"{what}: non-finite {k}")
    r = {"token_share": (ref["seq"] == out["seq"]).float().mean().item(),
         "step0_lp_gap": (ref["logprobs"][:, 0]
                          - out["logprobs"][:, 0]).abs().max().item()}
    if not torch.equal(ref["seq"][:, 0], out["seq"][:, 0]):
        raise AssertionError(f"{what}: step-0 tokens differ")
    if r["step0_lp_gap"] > BF16_STEP0_GAP:
        raise AssertionError(f"{what}: step-0 logprob gap "
                             f"{r['step0_lp_gap']} > {BF16_STEP0_GAP}")
    return r


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    import torch
    mag = x.abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def roi_bound(fmaps, rois, scales, out_size: int = 7, s: int = 2) -> dict:
    """The least time of one ROIAlign call on these inputs: the map
    positions these ROIs read (those with a non-zero row and column tap,
    each distinct (image, level, row, column) once, all C channels) and
    the ROIs read once, the output written once, against the
    multiply-adds the geometry needs (every non-zero row tap of a bin
    times every non-zero column tap, plus the column sums). `pyramid_mb`
    is the whole pyramid, the most any ROIs could read."""
    import torch
    from ekaid_torch.ops import roi_kernels as rk
    _, _, b, _, heights, img, lvl_idx, fmeta = rk._prepare(
        fmaps, rois, scales, out_size, s, 2)
    a_y, b_x = rk._hats(fmeta, out_size, s)
    ny = (a_y != 0).sum(-1).sum(-1).double()      # [n]
    nx = (b_x != 0).sum(-1).sum(-1).double()
    C, esize = fmaps[0].shape[-1], fmaps[0].element_size()
    ops = 2.0 * C * float((ny * nx + out_size * nx).sum())
    # distinct positions read: per ROI the rows with a tap in any bin
    # times the columns with a tap in any bin, at the patch origin
    dev = fmeta.device
    h = torch.tensor(heights, device=dev)
    area = h * h
    lvl_off = torch.cumsum(area, 0) - area
    hl = h[lvl_idx][:, None, None]
    rows = (fmeta[:, 6].long()[:, None, None]
            + torch.arange(rk.PATCH_Y, device=dev)[None, :, None])
    cols = (fmeta[:, 7].long()[:, None, None]
            + torch.arange(rk.PATCH_X, device=dev)[None, None, :])
    read = ((a_y != 0).any(1)[:, :, None] & (b_x != 0).any(1)[:, None, :]
            & (rows < hl) & (cols < hl))
    pos = (img[:, None, None] * int(area.sum()) + lvl_off[lvl_idx][:, None,
                                                                 None]
           + rows * hl + cols)[read]
    seen = torch.zeros(b * int(area.sum()), dtype=torch.bool, device=dev)
    seen[pos] = True
    n_pos = int(seen.sum())
    n = fmeta.shape[0]
    out_bytes = n * out_size * out_size * C * esize
    nbytes = n_pos * C * esize + rois.numel() * 4 + out_bytes
    peak = PEAK_OPS["bfloat16" if esize == 2 else "float32"]
    ops_ms, bytes_ms = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
            "read_mb": n_pos * C * esize / 1e6,
            "out_mb": out_bytes / 1e6,
            "pyramid_mb": sum(f.numel() for f in fmaps) * esize / 1e6}


class MemorySink:
    """H5Writer's append/close interface, in memory."""

    def __init__(self):
        self.records = []

    def append(self, records):
        self.records.extend(records)

    def close(self):
        pass


def check_records(records, det, what: str) -> float:
    """Shapes, finiteness and ranges of graph records; returns the share
    of anatomy nodes found."""
    import numpy as np
    from ekaid_torch.data import knowledge as K
    n = 2 * det.num_anatomy_classes
    found = []
    for i, r in enumerate(records):
        want = {"image_features": (n, det.roi_feat_dim), "image_bb": (n, 4),
                "image_adj_matrix": (100, 100),
                "semantic_adj_matrix": (100, 100), "bbox_label": (n,)}
        for k, shape in want.items():
            if r[k].shape != shape:
                raise AssertionError(f"{what} record {i}: {k} shape "
                                     f"{r[k].shape} != {shape}")
        if not np.isfinite(r["image_features"]).all():
            raise AssertionError(f"{what} record {i}: non-finite features")
        bb = r["image_bb"]
        if not ((bb >= 0).all() and (bb <= det.image_size).all()):
            raise AssertionError(f"{what} record {i}: box outside image")
        lab = r["bbox_label"]
        if not ((lab >= 0).all() and (lab <= K.NUM_CLASSES).all()):
            raise AssertionError(f"{what} record {i}: label out of range")
        found.append((lab[:det.num_anatomy_classes] < K.NUM_CLASSES).mean())
    return float(np.mean(found))


def extraction(rec: dict, cfg=None, device: str = "cuda") -> list:
    """Phases 6-8: K2/K3 against their plain versions, the extraction
    path, and the times, at the flagship detector config unless `cfg`
    is given. Returns the kernels-line entries of K2 and K3."""
    import numpy as np
    import torch
    from ekaid_torch.config import load_config
    from ekaid_torch.extract import runner
    from ekaid_torch.extract.pipeline import Extractor
    from ekaid_torch.models.detector.faster_rcnn import FPN_SCALES
    from ekaid_torch.models.greedy_decode import greedy_decode
    from ekaid_torch.ops import roi_kernels as rk

    cfg = cfg or load_config()
    det = cfg.detector
    dev = torch.device(device)
    bs = det.extract_batch_size
    batches = list(runner.synthetic_batches(
        bs * EXTRACT_BATCHES, det.image_size, bs, dtype="uint8"))

    # ---- 6. K2 and K3 against their plain versions ---------------------
    ana, _ = runner.build_detectors(
        cfg, gen=torch.Generator().manual_seed(SEED), device=dev)
    x = runner.preprocess(batches[0], det, dev)
    with torch.no_grad():
        pyr = ana.features(x)
        boxes, _, _ = ana.proposals(pyr)
    rois = boxes.clone()
    for i, box in enumerate(ELONGATED_ROIS):
        rois[i, -1] = torch.tensor(box, device=dev) * det.image_size / 1024
    fm16 = [p.contiguous() for p in pyr[:4]]
    fm32 = [f.float() for f in fm16]
    log(f"[6] K2/K3 vs plain: pyramid {[tuple(f.shape) for f in fm16]} "
        f"{fm16[0].dtype}, rois {tuple(rois.shape)}")
    pairs = {"roi_align_canvas": (rk.multilevel_roi_align_canvas,
                                  rk.multilevel_roi_align_canvas_plain),
             "roi_align_patch": (rk.multilevel_roi_align_pallas,
                                 rk.multilevel_roi_align_pallas_plain)}
    rec["roi"] = {}
    for name, (fn, plain) in pairs.items():
        r = rec["roi"][name] = {"f32_max_abs_err": 0.0}
        # and a ROI count per image that is not a multiple of 8
        for rr in (rois, rois[:, :rois.shape[1] - 3].contiguous()):
            out, ref = fn(fm32, rr, FPN_SCALES), plain(fm32, rr, FPN_SCALES)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            r["f32_max_abs_err"] = max(r["f32_max_abs_err"], err)
            if err > ROI_F32_GATE:
                raise AssertionError(f"{name} f32 R={rr.shape[1]}: max abs "
                                     f"err {err} > {ROI_F32_GATE}")
        out, ref = fn(fm16, rois, FPN_SCALES), plain(fm16, rois, FPN_SCALES)
        torch.cuda.synchronize()
        o, p = out.float(), ref.float()
        gap = (o - p).abs()
        if not torch.isfinite(o).all() or \
                (gap > bf16_ulp(torch.maximum(o.abs(), p.abs()))).any():
            raise AssertionError(f"{name} bf16: max gap {gap.max().item()} "
                                 "exceeds one bf16 ulp")
        r["bf16_equal_share"] = (gap == 0).sum().item() / gap.numel()
        r["bf16_max_abs_gap"] = gap.max().item()
        for i in range(len(ELONGATED_ROIS)):     # no zeroed columns/rows
            if o[i, -1].abs().amax(dim=(0, 2)).min() == 0 or \
                    o[i, -1].abs().amax(dim=(1, 2)).min() == 0:
                raise AssertionError(f"{name}: elongated ROI {i} pooled "
                                     "an all-zero row or column")
        log(f"  {name}: f32 max err {r['f32_max_abs_err']:.3g} (R="
            f"{rois.shape[1]} and {rois.shape[1] - 3}; gate "
            f"{ROI_F32_GATE}); bf16 within one ulp, equal "
            f"{r['bf16_equal_share']:.6f}, max gap "
            f"{r['bf16_max_abs_gap']:.3g}")

    # ---- 7. the extraction path ----------------------------------------
    counters = (rk.multilevel_roi_align_canvas, rk.multilevel_roi_align_pallas,
                greedy_decode)

    def drive(cfg_run, n_batches):
        ana_apply, dis_apply = runner.build_detector_fns(
            cfg_run, gen=torch.Generator().manual_seed(SEED), device=dev)
        ex = Extractor(ana_apply, dis_apply, det.num_disease_classes)
        sink = MemorySink()
        for c in counters:
            c.launches = 0
        ex.run(iter(batches[:n_batches]), sink)
        torch.cuda.synchronize()
        counts = [c.launches for c in counters]
        if len(sink.records) != n_batches * bs:
            raise AssertionError(f"{len(sink.records)} records for "
                                 f"{n_batches} batches")
        return ex, sink.records, counts

    ex, records, counts = drive(cfg, EXTRACT_BATCHES)
    rec["k2_launches"] = counts[0]
    found = check_records(records, det, "canvas")
    log(f"[7] extraction, roi_backend {det.roi_backend!r}: "
        f"{len(records)} records, anatomy found {found:.3f}, launches "
        f"K2 {counts[0]} K3 {counts[1]} K1 {counts[2]}")
    if counts != [2 * EXTRACT_BATCHES, 0, 0]:
        raise AssertionError(f"launches {counts}: K2 must launch twice a "
                             "batch and nothing else")
    cfg_p = cfg.replace(detector=det.replace(roi_backend="pallas"))
    _, rec_p, counts_p = drive(cfg_p, 1)
    rec["k3_launches"] = counts_p[1]
    found_p = check_records(rec_p, det, "patch")
    same = np.mean([(a["bbox_label"] == b["bbox_label"]).mean()
                    for a, b in zip(rec_p, records)])
    log(f"  roi_backend 'pallas': {len(rec_p)} records, anatomy found "
        f"{found_p:.3f}, labels equal to the canvas run {same:.4f}, "
        f"launches K2 {counts_p[0]} K3 {counts_p[1]} K1 {counts_p[2]}")
    if counts_p != [0, 2, 0]:
        raise AssertionError(f"launches {counts_p}: K3 must launch twice "
                             "a batch and nothing else")
    rec["extract_found_share"] = found
    rec["patch_vs_canvas_label_share"] = float(same)

    # ---- 8. times --------------------------------------------------------
    entries = []
    for name, (fn, plain) in pairs.items():
        round_a = name == "roi_align_canvas"

        def launch_alone(fmaps, round_a):
            """The ctypes launch alone, geometry and output made before."""
            fms, _, _, _, hs, meta, fmeta = rk._kernel_inputs(
                fmaps, rois, FPN_SCALES, 7, 2, 2)
            out = torch.empty(meta.shape[0], 7, 7, fms[0].shape[-1],
                              dtype=fms[0].dtype, device=dev)
            return lambda: rk._kernel_launch(fms, hs, meta, fmeta, out, 2,
                                             round_a)

        alone16 = launch_alone(fm16, round_a)
        alone32 = launch_alone(fm32, round_a)
        runs = {"plain": [], "wrapper": [], "kernel": [], "kernel_f32": []}
        for which in ("plain", "wrapper", "kernel", "kernel_f32",
                      "kernel_f32", "kernel", "wrapper", "plain"):
            f = {"plain": lambda: plain(fm16, rois, FPN_SCALES),
                 "wrapper": lambda: fn(fm16, rois, FPN_SCALES),
                 "kernel": alone16, "kernel_f32": alone32}[which]
            runs[which].append(cuda_ms(f, 2 if which == "plain" else 20))
        b = roi_bound(fm16, rois, FPN_SCALES)
        b32 = roi_bound(fm32, rois, FPN_SCALES)
        r = rec["roi"][name]
        r.update(b, ms=statistics.mean(runs["kernel"]),
                 wrapper_ms=statistics.mean(runs["wrapper"]),
                 f32_ms=statistics.mean(runs["kernel_f32"]),
                 f32_bound_ms=b32["bound_ms"],
                 plain_ms=statistics.mean(runs["plain"]),
                 profiler_kernel_ms=profiler_kernel_ms(alone16,
                                                       "roi_align_kernel"),
                 runs=runs)
        log(f"[8] {name} bf16 {tuple(rois.shape)}: launch alone "
            f"{r['ms']:.3f} ms (runs {['%.3f' % v for v in runs['kernel']]}"
            f"; profiler's device time {r['profiler_kernel_ms']}), whole "
            f"wrapper {r['wrapper_ms']:.3f} ms, f32 maps {r['f32_ms']:.3f} "
            f"ms (bound {b32['bound_ms']:.4f}); plain {r['plain_ms']:.1f} "
            f"ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
            f"{b['read_mb']:.1f} MB of the {b['pyramid_mb']:.1f} MB "
            f"pyramid read, {b['out_mb']:.1f} MB written, at 3.35 TB/s; "
            f"{b['gflop']:.2f} GFLOP)")
        entries.append({
            "name": name, "route": "cuda",
            "source": "ekaid_torch/csrc/roi_align.cu",
            "replaces": ("ekaid_tpu/ops/pallas_roi.py:221"
                         if name == "roi_align_canvas"
                         else "ekaid_tpu/ops/pallas_roi.py:67"),
            "launches": (rec["k2_launches"] if name == "roi_align_canvas"
                         else rec["k3_launches"]),
            "max_abs_err": r["f32_max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None})

    t0 = time.perf_counter()
    sink = MemorySink()
    ex.run(iter(batches), sink)
    dt = time.perf_counter() - t0
    rec["extract_images_per_s"] = len(sink.records) / dt
    with torch.no_grad():
        rec["backbone_ms"] = cuda_ms(lambda: ana.features(x), 5)
        stages = {}

        def stage(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stages[name] = (time.perf_counter() - t) * 1e3
            return out

        for _ in range(2):                   # the second pass is kept
            xb = stage("h2d+normalise", lambda: runner.preprocess(
                batches[1], det, dev))
            p = stage("backbone", lambda: ana.features(xb))
            bx, sc, va = stage("rpn+proposals", lambda: ana.proposals(p))
            stage("roi_pool (K2)", lambda: ana.box_head.pool(
                p[:4], bx, FPN_SCALES))
            feats, cls, dl = stage("box_head", lambda: ana.box_head(
                p[:4], bx, FPN_SCALES))
            out = {"proposals": bx, "proposal_scores": sc,
                   "proposal_valid": va, "roi_features": feats,
                   "cls_scores": cls, "box_deltas": dl}
            stage("select (nms)", lambda: ana.select_extract(out))
            disp = stage("both detectors", lambda: ex.dispatch(batches[1]))
            stage("host graph assembly", lambda: ex.finish(disp))
    rec["stages_ms"] = stages
    log(f"    extraction end to end: {rec['extract_images_per_s']:.1f} "
        f"images/s over {len(sink.records)} images ({cfg.dtypes.compute_dtype}"
        f", {det.image_size}^2, batch {bs}); backbone {rec['backbone_ms']:.2f} ms per batch")
    log(f"    anatomy detector stages, ms per batch of {bs} (host clock, "
        "synchronised): " + ", ".join(f"{k} {v:.2f}"
                                      for k, v in stages.items()))
    return entries


def nms_same(got, want, what: str) -> None:
    """Equal valid flags, and equal indices under them, in order."""
    import torch
    (gi, gv), (wi, wv) = got, want
    if not torch.equal(gv, wv):
        raise AssertionError(f"{what}: valid differs in "
                             f"{(gv != wv).sum().item()} slots")
    differ = torch.where(gv, gi, -1) != torch.where(wv, wi, -1)
    if differ.any():
        raise AssertionError(f"{what}: indices differ in "
                             f"{differ.sum().item()} valid slots")


def nms_hard_set():
    """(name, boxes [B, R, 4], scores [B, R], iou, max_out) cases, numpy
    f32, R = 77 (not a multiple of 32)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 9)
    b, r = 6, 77
    c = rng.uniform(100, 400, (b, r, 2))
    s = rng.uniform(10, 150, (b, r, 2))
    boxes = np.concatenate([c - s / 2, c + s / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, r)).astype(np.float32)
    scores[0] = rng.integers(1, 4, r) / 3                   # ties
    boxes[1, r // 2:] = boxes[1, :r - r // 2]               # duplicates
    scores[1] = rng.integers(1, 3, r) / 2
    boxes[2, ::3, 2] = boxes[2, ::3, 0]                     # zero area
    boxes[2, 1::3] = boxes[2, 1::3][:, [2, 3, 0, 1]]        # inverted
    scores[3, r // 2:] = -1e9                               # padding rows
    scores[3, :2] = (-5e8, -4.9e8)                          # dead, live
    scores[4] = -1e9                                        # nothing live
    return [("hard set", boxes, scores, 0.5, 60),           # 60 > live rows
            ("hard set IoU 0.7", boxes, scores, 0.7, 60),
            ("hard set B=1", boxes[5:], scores[5:], 0.5, 100)]


def proposal_nms_inputs(cfg, dev):
    """The (boxes, scores, iou, max_out) that `generate_proposals` hands
    to the blocked NMS through `batched_nms` (level offsets added) on
    one flagship batch: the anatomy detector with random weights from
    the seed, synthetic uint8 images. Checks R against the config."""
    import torch
    from ekaid_torch.extract import runner
    from ekaid_torch.models.detector.anchors import pyramid_anchors
    from ekaid_torch.ops import nms as nms_ops

    det = cfg.detector
    ana, _ = runner.build_detectors(
        cfg, gen=torch.Generator().manual_seed(SEED), device=dev)
    images = next(runner.synthetic_batches(
        det.extract_batch_size, det.image_size, det.extract_batch_size,
        dtype="uint8"))
    seen, orig = [], nms_ops.nms

    def capture(boxes, scores, iou_thresh, max_out,
                score_thresh=float("-inf"), **kw):
        seen.append((boxes, scores, iou_thresh, max_out, score_thresh, kw))
        return orig(boxes, scores, iou_thresh, max_out, score_thresh, **kw)

    nms_ops.nms = capture
    try:
        with torch.no_grad():
            ana.proposals(ana.features(runner.preprocess(images, det, dev)))
    finally:
        nms_ops.nms = orig
    (boxes, scores, iou, max_out, score_thresh, kw), = seen
    if score_thresh != float("-inf") or kw:
        raise AssertionError(f"proposal NMS takes score_thresh "
                             f"{score_thresh}, {kw}; K4 has neither")
    want_r = sum(min(det.pre_nms_topk, len(a))
                 for a in pyramid_anchors(det.image_size))
    if scores.shape != (det.extract_batch_size, want_r):
        raise AssertionError(f"proposal NMS on {tuple(scores.shape)}, "
                             f"expected ({det.extract_batch_size}, {want_r})")
    return (boxes.float().contiguous(), scores.float().contiguous(), iou,
            max_out)


def nms_bound(b: int, r: int, max_out: int, live_rows: int) -> dict:
    """K4's least time: the boxes and scores read once and the outputs
    written once, against the IoU pass over the rows still live at each
    step (`live_rows`, summed over the steps and images; dead rows need
    no IoU)."""
    nbytes = b * r * (16 + 4) + b * max_out * (4 + 1)
    ops = float(NMS_OPS_PER_ROW) * live_rows
    ops_ms = ops / PEAK_OPS["float32"] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "mflop": ops / 1e6, "kbytes": nbytes / 1e3}


def nms_phase(rec: dict, cfg, device: str = "cuda") -> dict:
    """Phase 9: K4 against its plain version and the blocked NMS, the
    NMS A/B entry point, and the times. Returns K4's kernels-line
    entry."""
    import torch
    from ekaid_torch.models.greedy_decode import greedy_decode
    from ekaid_torch.ops import nms as nms_ops
    from ekaid_torch.ops import nms_kernel as nk
    from ekaid_torch.ops import roi_kernels as rk
    from ekaid_torch.scripts import bench_nms

    dev = torch.device(device)
    T = lambda x: torch.as_tensor(x, device=dev)              # noqa: E731
    bench = dict(batch=8, rois=1000, max_out=100, iou=0.5)
    bb, bs = bench_nms.make_inputs(bench["batch"], bench["rois"], SEED)
    geoms = {"bench": (T(bb), T(bs), bench["iou"], bench["max_out"]),
             "extraction": proposal_nms_inputs(cfg, dev)}
    cases = [("bench geometry", *geoms["bench"])]
    cases += [(n, T(b), T(s), iou, m) for n, b, s, iou, m in nms_hard_set()]
    # the most rows the kernel's shared memory takes (all of it)
    mb, ms = bench_nms.make_inputs(2, nk.MAX_ROWS, SEED + 1)
    cases.append((f"R={nk.MAX_ROWS}", T(mb), T(ms), 0.5, 50))
    cases.append(("extraction geometry", *geoms["extraction"]))

    # ---- 9a. K4 against its plain version and the blocked NMS ------------
    r9 = rec["nms"] = {"cases": {}}
    log("[9] K4 vs plain vs blocked NMS, f32, selections equal in order")
    for name, boxes, scores, iou, max_out in cases:
        got = nk.nms_kernel(boxes, scores, iou, max_out)
        live = torch.zeros(scores.shape[0], dtype=torch.int64, device=dev)
        plain = nk.nms_kernel_plain(boxes, scores, iou, max_out,
                                    live_rows=live)
        blocked = nms_ops.nms(boxes, scores, iou, max_out)
        torch.cuda.synchronize()
        nms_same(got, plain, f"{name}: K4 vs plain")
        nms_same(got, blocked, f"{name}: K4 vs blocked nms")
        r9["cases"][name] = c = {
            "shape": list(scores.shape), "iou": iou, "max_out": max_out,
            "picks": got[1].sum(-1).tolist(), "live_rows": live.tolist()}
        log(f"  {name}: {tuple(scores.shape)} IoU {iou} max_out {max_out}:"
            f" equal; picks per image {c['picks']}; live rows over the "
            f"steps {sum(c['live_rows'])}")
    hard = r9["cases"]["hard set"]["picks"]
    if hard[3] > 37 or hard[4] != 0:
        raise AssertionError(f"hard set picks {hard}: the padded image has "
                             "37 live rows, the dead one none")

    # ---- 9b. the NMS A/B entry point -------------------------------------
    counters = (nk.nms_kernel, greedy_decode, rk.multilevel_roi_align_canvas,
                rk.multilevel_roi_align_pallas)
    for cnt in counters:
        cnt.launches = 0
    res = bench_nms.main(["--iters", "20", "--device", device])
    torch.cuda.synchronize()
    counts = [cnt.launches for cnt in counters]
    log(f"  bench_nms.main: {len(res['lines'])} impls, agreement "
        f"{res['kept_set_agreement']}, launches K4 {counts[0]} (calls "
        f"{res['k4_calls']}), K1/K2/K3 {counts[1:]}")
    if counts != [res["k4_calls"], 0, 0, 0] or (
            device == "cuda" and counts[0] < 1):
        raise AssertionError(f"launches {counts}: K4 must launch once per "
                             f"call ({res['k4_calls']}) and nothing else")
    r9["bench_nms"] = res["lines"]
    r9["launches"] = counts[0]

    # ---- 9c. times ---------------------------------------------------------
    for g, (boxes, scores, iou, max_out) in geoms.items():
        n, r = scores.shape
        idx = torch.empty(n, max_out, dtype=torch.int32, device=dev)
        valid = torch.empty(n, max_out, dtype=torch.bool, device=dev)

        def alone():
            nk._kernel_launch(boxes, scores, iou, idx, valid)

        reads = nms_ops._survivor_mask.host_reads
        nms_ops.nms(boxes, scores, iou, max_out)
        reads = nms_ops._survivor_mask.host_reads - reads
        runs = {"kernel": [], "blocked": []}
        for which in ("kernel", "blocked", "blocked", "kernel"):
            runs[which].append(cuda_ms(
                alone if which == "kernel" else
                lambda: nms_ops.nms(boxes, scores, iou, max_out),
                20 if which == "kernel" else 5))
        c = r9["cases"][f"{g} geometry"]
        picks, steps = sum(c["picks"]), max(c["picks"])
        live = sum(c["live_rows"])
        t = r9[g] = dict(
            nms_bound(n, r, max_out, live),
            ms=statistics.mean(runs["kernel"]),
            wrapper_ms=cuda_ms(lambda: nk.nms_kernel(boxes, scores, iou,
                                                     max_out), 20),
            profiler_kernel_ms=profiler_kernel_ms(alone, "greedy_nms_kernel"),
            blocked_ms=statistics.mean(runs["blocked"]),
            blocked_host_reads=reads, serial_steps=steps, picks=picks,
            live_rows=live, runs=runs,
            # the plain version at max_out=1000 is a 1000-step loop
            plain_ms=cuda_ms(lambda: nk.nms_kernel_plain(
                boxes, scores, iou, max_out), 2 if g == "bench" else 1))
        t["x_bound"] = t["ms"] / t["bound_ms"]
        log(f"    K4 {g} {tuple(scores.shape)}, IoU {iou}, {max_out} slots: "
            f"launch alone {t['ms']:.4f} ms (runs "
            f"{['%.4f' % v for v in runs['kernel']]}; profiler's device time "
            f"{t['profiler_kernel_ms']}), wrapper {t['wrapper_ms']:.4f} ms; "
            f"{steps} serial steps, {picks} picks, {live} live rows over the "
            f"steps ({live / (r * max(picks, 1)):.3f} of R at every pick); "
            f"bound {t['bound_ms']:.5f}"
            f" ms ({t['bound_by']}: {t['mflop']:.1f} MFLOP at 67 TFLOP/s, "
            f"{t['kbytes']:.0f} KB at 3.35 TB/s), {t['x_bound']:.0f}x; "
            f"plain {t['plain_ms']:.1f} ms; blocked nms {t['blocked_ms']:.3f}"
            f" ms with {reads} host reads a call")
    b = r9["bench"]
    # the gate is exact (nms_same): this entry exists only when every
    # selection above was equal, so the index error is 0
    return {"name": "greedy_nms", "route": "cuda",
            "source": "ekaid_torch/csrc/nms.cu",
            "replaces": "ekaid_tpu/ops/pallas_nms.py:38",
            "launches": r9["launches"], "max_abs_err": 0,
            "ms": b["ms"], "plain_ms": b["plain_ms"],
            "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None}


def bf16_gap_ulps(ref, out) -> dict:
    """The largest gap between two bf16 tensors in bf16 ulps (of the
    larger magnitude) and the share of bit-equal elements."""
    import torch
    r, o = ref.float(), out.float()
    gap = (r - o).abs()
    ulps = gap / bf16_ulp(torch.maximum(r.abs(), o.abs()))
    return {"max_ulps": ulps.max().item(),
            "equal_share": (gap == 0).float().mean().item()}


def one_step(rec: dict, w32, w16, sp, fx32, fx16) -> None:
    """The step-0 intermediates of one-step decodes (`scratch=True`)
    against the plain version's, at B=64: f32 within ONE_STEP_F32 x the
    plain tensor's largest magnitude; bf16 gaps in ulps and bit-equal
    shares recorded, zx and h_mod (inputs equal at step 0) gated at
    BF16_STEP0_ULPS."""
    import torch
    from ekaid_torch.models.greedy_decode import (SCRATCH_NAMES,
                                                  greedy_decode,
                                                  greedy_decode_plain)
    from ekaid_torch.utils.dtypes import BF16, F32
    sp1 = sp.replace(seq_length=1)
    r = rec["one_step"] = {"f32": {}, "bf16": {}}
    for pol, w, (f, x) in ((F32, w32, fx32), (BF16, w16, fx16)):
        ref = greedy_decode_plain(w, sp1, pol, f, x, scratch=True)
        out = greedy_decode(w, sp1, pol, f, x, scratch=True)
        torch.cuda.synchronize()
        for k in SCRATCH_NAMES:
            if pol is F32:
                scale = ref[k].abs().max().item()
                err = (ref[k] - out[k]).abs().max().item()
                r["f32"][k] = err / max(scale, 1e-30)
                if err > ONE_STEP_F32 * scale:
                    raise AssertionError(f"one step f32 {k}: max abs err "
                                         f"{err} > {ONE_STEP_F32} x {scale}")
            else:
                g = r["bf16"][k] = bf16_gap_ulps(ref[k], out[k])
                if k in ("zx", "h_mod") and g["max_ulps"] > BF16_STEP0_ULPS:
                    raise AssertionError(f"one step bf16 {k}: "
                                         f"{g['max_ulps']} ulps > "
                                         f"{BF16_STEP0_ULPS}")
    log("  one step, B=64, f32 max err / max |plain|: " + ", ".join(
        f"{k} {v:.2g}" for k, v in r["f32"].items()))
    log("  one step, B=64, bf16 max ulps (bit-equal share): " + ", ".join(
        f"{k} {v['max_ulps']:.3g} ({v['equal_share']:.4f})"
        for k, v in r["bf16"].items()) + f"; zx, h_mod gated at "
        f"{BF16_STEP0_ULPS}")


def k1_phase(rec: dict, cfg):
    """Phase 3: K1 against its plain version at flagship width. Returns
    the bf16 model, the B=64 batch, its bf16 decode inputs, weights and
    kernel decode, for the main path."""
    import torch
    from ekaid_torch.data.synthetic import synthetic_batch
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.models.greedy_decode import (
        PRODUCT_WEIGHTS, greedy_decode, greedy_decode_plain)
    from ekaid_torch.utils.dtypes import BF16, F32
    sp = cfg.speaker
    B = BATCHES[0]
    batch = synthetic_batch(cfg, B, seed=SEED + 1)
    ntoken = sp.vocab_size - 1               # the identity vocab's words
    m32 = EkaidModel(cfg, ntoken, policy=F32, device="cuda", seed=SEED)
    enc = m32.encode(batch)
    fused, feats = m32.speaker._fused(enc["feat_bef"], enc["feat_diff"],
                                      enc["feat_aft"])
    w32 = m32.speaker.decode_weights()
    log(f"[3] K1 vs plain, f32, T={sp.seq_length}, B in {BATCHES}")
    w_exit = dict(w32, blogit=w32["blogit"].clone())
    w_exit["blogit"][0] += 100.0
    sp_c = sp.replace(decoding_constraint=1)
    errs = []
    for b in BATCHES:
        f, x = fused[:b].contiguous(), feats[:b].contiguous()
        for what, w, s in (("plain", w32, sp), ("early exit", w_exit, sp),
                           ("decoding constraint", w32, sp_c)):
            ref = greedy_decode_plain(w, s, F32, f, x)
            out = greedy_decode(w, s, F32, f, x)
            torch.cuda.synchronize()
            if what == "early exit" and not (
                    (out["seq"][:, 1:] == 0).all()
                    and (out["seq"][:, 0] > 0).all()):
                raise AssertionError(f"early exit B={b}: rows did not all "
                                     "end at step 1")
            errs.append(compare(ref, out, f"{what} B={b}"))
            if b == B and what == "plain":
                rec["f32_steps"] = steps_run(out["seq"])
    rec["f32_max_abs_err"] = max(e["logprobs"] for e in errs)
    rec["f32_kernel_ms"] = cuda_ms(
        lambda: greedy_decode(w32, sp, F32, fused, feats), 5)
    log(f"  f32 kernel {rec['f32_kernel_ms']:.3f} ms per decode")

    m16 = EkaidModel(cfg, ntoken, policy=BF16, device="cuda", seed=SEED)
    enc16 = m16.encode(batch)
    fused16, feats16 = m16.speaker._fused(
        enc16["feat_bef"], enc16["feat_diff"], enc16["feat_aft"])
    w16 = m16.speaker.decode_weights()
    # a batch of 80: two row groups, the second partial
    e80 = m16.encode(synthetic_batch(cfg, BF16_GROUPS_B, seed=SEED + 2))
    f80, x80 = m16.speaker._fused(e80["feat_bef"], e80["feat_diff"],
                                  e80["feat_aft"])
    rec["bf16"] = {}
    for b in BF16_BATCHES:
        f, x = ((f80, x80) if b == BF16_GROUPS_B else
                (fused16[:b].contiguous(), feats16[:b].contiguous()))
        ref16 = greedy_decode_plain(w16, sp, BF16, f, x)
        out = greedy_decode(w16, sp, BF16, f, x)
        if b == B:
            out16 = out
        r = rec["bf16"][b] = bf16_agreement(ref16, out, f"bf16 kernel B={b}")
        log(f"  bf16 B={b}: equal tokens {r['token_share']:.4f}, step-0 "
            f"logprob gap {r['step0_lp_gap']:.3g}, steps "
            f"{steps_run(out['seq'])} (hard checks: finite, step-0 tokens "
            f"equal, step-0 gap <= {BF16_STEP0_GAP})")
    # other parameter sets, each made and dropped in turn, decode with
    # their own packed weights: f32 as its plain version does, bf16 bit
    # for bit as a fresh copy of the set (packed anew)
    products = {n for names in PRODUCT_WEIGHTS.values() for n in names}
    for shift in (1, 2):
        for pol, w0, f, x in ((F32, w32, fused, feats),
                              (BF16, w16, fused16, feats16)):
            w_other = {k: v.roll(shift, 0).contiguous() if k in products
                       else v for k, v in w0.items()}
            what = (f"{'f32' if pol is F32 else 'bf16'} B={B}, parameter "
                    f"set {shift + 1}")
            out = greedy_decode(w_other, sp, pol, f, x)
            if pol is F32:
                compare(greedy_decode_plain(w_other, sp, F32, f, x), out,
                        what)
                continue
            fresh = greedy_decode({k: v.clone() for k, v in w_other.items()},
                                  sp, BF16, f, x)
            torch.cuda.synchronize()
            for k in ("seq", "logprobs", "module_weights"):
                if not torch.equal(out[k], fresh[k]):
                    raise AssertionError(f"{what}: differs in {k} from a "
                                         "fresh copy of the set")
            log(f"  {what}: bit-equal to a fresh copy of the set")
    # the split-K sums run in a fixed order: a second decode is bit-equal
    again = greedy_decode(w16, sp, BF16, fused16, feats16)
    torch.cuda.synchronize()
    for k in ("seq", "logprobs", "module_weights"):
        if not torch.equal(again[k], out16[k]):
            raise AssertionError(f"bf16 B={B}: a second decode differs in {k}")
    log(f"  bf16 B={B}: a second decode, after two other parameter sets, "
        "is bit-equal (seq, logprobs, module_weights)")
    one_step(rec, w32, w16, sp, (fused, feats), (fused16, feats16))
    return m16, batch, fused16, feats16, w16, out16


def main() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    if not (ROOT / "ekaid_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from ekaid_torch import kernels
    from ekaid_torch.config import load_config
    from ekaid_torch.models.greedy_decode import (greedy_decode,
                                                  greedy_decode_plain)
    from ekaid_torch.serving.engine import InferenceEngine
    from ekaid_torch.utils.dtypes import BF16

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {}

    # ---- 1. the card ---------------------------------------------------
    card = card_line()
    rec["card"] = card
    rec["device"] = torch.cuda.get_device_name(0)
    log(f"[1] card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {rec['device']}")

    # ---- 2. build --------------------------------------------------------
    rec["build_s"] = kernels.build_all()
    log(f"[2] built {sorted(kernels.SOURCES)} in {rec['build_s']:.1f} s")
    for name in kernels.SOURCES:
        for line in (kernels.BUILD / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")

    # ---- 3. K1 against its plain version, flagship width -----------------
    cfg = load_config()
    sp = cfg.speaker
    B = BATCHES[0]
    m16, batch, fused16, feats16, w16, out16 = k1_phase(rec, cfg)

    # ---- 4. main path ----------------------------------------------------
    greedy_decode.launches = 0
    engine = InferenceEngine(cfg, model=m16, device="cuda")
    decodes = 1                              # the engine's warm-up answer
    idxs = engine.store.split_idxs
    texts = [engine.vocab.decode(engine.store.questions[int(i)])
             for i in idxs[:4]]
    answers = []
    for i, text in enumerate(texts):
        answers.append(engine.answer(text, int(idxs[i]), detail=True))
        decodes += 1
    dev_batch = m16.tensors(batch)
    out_main = m16.decode(dev_batch)
    decodes += 1
    torch.cuda.synchronize()
    launches = greedy_decode.launches
    log(f"[4] main path: {decodes} decodes, greedy_decode launches "
        f"{launches}, grid {greedy_decode.last_grid} blocks")
    for a in answers:
        log(f"    q@{a['index']}: {a['answer'][:60]!r} "
            f"({len(a['tokens'])} tokens, {a['latency_ms']} ms)")
    if launches != decodes:
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{decodes} decodes")
    if tuple(out_main["seq"].shape) != (B, sp.seq_length):
        raise AssertionError(f"seq shape {tuple(out_main['seq'].shape)}")
    for k in ("logprobs", "module_weights", "feat_bef", "feat_diff", "pred"):
        if not torch.isfinite(out_main[k].float()).all():
            raise AssertionError(f"main path: non-finite {k}")
    if not ((out_main["seq"] >= 0) & (out_main["seq"] < sp.vocab_size)).all():
        raise AssertionError("main path: token out of the vocab")
    if not torch.equal(out_main["seq"], out16["seq"]):
        raise AssertionError("main path batch-64 decode differs from the "
                             "same decode in phase 3")
    rec["launches"] = launches
    # each answer against the plain version on the engine's own inputs
    w16e = m16.speaker.decode_weights()
    rec["engine"] = []
    for text, a in zip(texts, answers):
        eb = dict(engine._dev_sample(a["index"]))
        eb["question"] = torch.as_tensor(
            engine.question_to_ids(text).astype(np.int32)[None],
            device=m16.device)
        e = m16.encode(eb)
        f, x = m16.speaker._fused(e["feat_bef"], e["feat_diff"],
                                  e["feat_aft"])
        ref = greedy_decode_plain(w16e, sp, BF16, f, x)["seq"][0]
        want = engine._detail_fields(ref.cpu().numpy(),
                                     np.zeros((len(ref), 3)))["tokens"]
        got = a["tokens"]
        if got[:1] != want[:1]:
            raise AssertionError(f"answer q@{a['index']}: first token "
                                 f"{got[:1]} != plain {want[:1]}")
        rec["engine"].append(sum(
            g == w for g, w in zip(got, want)) / max(len(got), len(want)))
    log(f"    answers vs plain, share of equal tokens {rec['engine']} "
        "(hard check: first token equal)")

    # ---- 5. times ----------------------------------------------------------
    steps = steps_run(out16["seq"])
    E, R, D = sp.embed_dim, sp.rnn_size, sp.input_dim
    W, V, P = sp.word_embed_size, sp.vocab_size, sp.pos_classes
    G = 2 * R + D
    macs_row = ((E + R) * 4 * R + R * 4 * R + R * 3 + R * R + R * P + P * R
                + G * G + G * D + W * 4 * R + D * 4 * R + R * 4 * R + R * V)
    ops = 2.0 * B * macs_row * steps
    weight_bytes = sum(x.numel() * x.element_size() for x in w16.values())
    io_bytes = (weight_bytes + fused16.numel() * 2 + feats16.numel() * 2
                + B * sp.seq_length * (4 + 4 + 12))
    bound_ops_ms = ops / PEAK_OPS["bfloat16"] * 1e3
    bound_bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    rec["bound_ms"] = max(bound_ops_ms, bound_bytes_ms)
    rec["bound_by"] = "operations" if bound_ops_ms >= bound_bytes_ms \
        else "bytes"
    rec["weights_per_step_ms"] = weight_bytes * steps / HBM_BYTES_PER_S * 1e3

    def kernel():
        greedy_decode(w16, sp, BF16, fused16, feats16)

    def plain():
        greedy_decode_plain(w16, sp, BF16, fused16, feats16)

    runs = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn, reps = (kernel, 20) if name == "kernel" else (plain, 3)
        runs[name].append(cuda_ms(fn, reps))
    rec["kernel_ms"] = statistics.mean(runs["kernel"])
    rec["kernel_b1_ms"] = cuda_ms(lambda: greedy_decode(
        w16, sp, BF16, fused16[:1].contiguous(), feats16[:1].contiguous()), 10)
    phase_ns = torch.zeros(7, dtype=torch.int64, device="cuda")
    greedy_decode(w16, sp, BF16, fused16, feats16, phase_ns=phase_ns)
    torch.cuda.synchronize()
    names = ("mod_lstm+vpos+zx+zh", "mw+pos+att", "gate1x", "gate2x",
             "lang_lstm", "logits", "argmax")
    rec["phase_us_per_step"] = {
        n: v / steps / 1e3 for n, v in zip(names, phase_ns.tolist())}
    rec["plain_ms"] = statistics.mean(runs["plain"])
    rec["steps"] = steps

    def e2e():
        m16.decode(dev_batch)["seq"].cpu()

    e2e()
    t0 = time.perf_counter()
    for _ in range(5):
        e2e()
    rec["e2e_b64_pairs_per_s"] = 5 * B / (time.perf_counter() - t0)
    one = {k: v[:1] for k, v in dev_batch.items()}
    for name, b in (("encode_b64_ms", dev_batch), ("encode_b1_ms", one)):
        m16.encode(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            m16.encode(b)
        torch.cuda.synchronize()
        rec[name] = (time.perf_counter() - t0) / 5 * 1e3
    lat = [engine.answer(None, int(idxs[i % len(idxs)]))["latency_ms"]
           for i in range(10)]
    rec["b1_latency_ms_median"] = statistics.median(lat)
    log(f"[5] on {card}:")
    log(f"    K1 bf16 B={B}: {rec['kernel_ms']:.3f} ms per decode "
        f"({steps} steps; runs {['%.3f' % x for x in runs['kernel']]}); "
        f"plain {rec['plain_ms']:.3f} ms; B=1 {rec['kernel_b1_ms']:.3f} ms")
    log("    K1 phases, us per step (block 0's view): " + ", ".join(
        f"{n} {v:.2f}" for n, v in rec["phase_us_per_step"].items()))
    log(f"    K1 bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
        f"{ops / 1e9:.1f} GFLOP at 989 TFLOP/s = {bound_ops_ms:.4f} ms; "
        f"{io_bytes / 1e6:.1f} MB once at 3.35 TB/s = "
        f"{bound_bytes_ms:.4f} ms); weights streamed every step "
        f"{rec['weights_per_step_ms']:.3f} ms")
    log(f"    batch-64 decode end to end: "
        f"{rec['e2e_b64_pairs_per_s']:.1f} pairs/s; batch-1 answer "
        f"median {rec['b1_latency_ms_median']:.2f} ms over 10; encoder "
        f"B=64 {rec['encode_b64_ms']:.2f} ms, B=1 {rec['encode_b1_ms']:.2f} ms")

    kernels_line = [{
        "name": "greedy_decode", "route": "cuda",
        "source": "ekaid_torch/csrc/greedy_decode.cu",
        "replaces": "ekaid_tpu/models/pallas_decode.py:70",
        "launches": launches, "max_abs_err": rec["f32_max_abs_err"],
        "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": None}]
    kernels_line += extraction(rec)
    kernels_line.append(nms_phase(rec, cfg))
    kline = {"kernels": kernels_line}
    log("record: " + json.dumps(rec))
    print(json.dumps(kline))
    print(card)
    return {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--watchdog", type=float, default=1150.0,
                    help="seconds before the run is aborted (a hung "
                         "kernel cannot be interrupted otherwise)")
    args = ap.parse_args()
    timer = threading.Timer(args.watchdog, lambda: (
        print(f"chip_smoke: watchdog after {args.watchdog} s",
              file=sys.stderr, flush=True), os._exit(124)))
    timer.daemon = True
    timer.start()
    result = main()
    timer.cancel()
    print(json.dumps(result), flush=True)
