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
     ulps recorded, zx and h_mod within 2 ulps; on ROLLED_SETS more
     parameter sets, f32 decodes (plain and with the decoding
     constraint) gated under the near-tie rule (`near_tie_agree`: two
     decodes agree if each row's tokens are equal to the end or up to
     the first step where the plain version's two best logprobs are
     closer than K1's f32 logprob error above, floor 1e-6), and records
     of bf16: K1's step-0 gap to the plain version beside the CPU's
     plain version's, and for the largest gap the one-step
     intermediates of both in ulps; on the inputs that two other draws
     of the weight norm give (g at init from the forward's sum of
     squares, and both from that sum in f64), the f32 decodes gated
     under the near-tie rule and the bf16 comparisons recorded;
  4. the main path: the model of a synthetic trainer (phase 3's bf16
     model: the same config, vocab and seed) behind the batch-1
     `InferenceEngine(trainer)`, answering questions over the eval
     split, then one batch-64 decode; the kernel's launch count must
     equal the number of decodes, and each answer is held against the
     plain version on the same inputs;
  5. timings of the kernel, its plain version, its bound, the batch-64
     decode and the batch-1 answer;
  6. the ROIAlign kernels K2 (canvas) and K3 (patch), which compute the
     ROI geometry themselves: on the card, x / d for a Python scalar
     against a 0-d tensor (recorded); each instance's geometry (image,
     level, 8 patch floats) bit-equal to `_roi_geometry` on the card, on
     the batch below and on ROIs within BOUNDARY_ULPS of every level
     boundary, and the ROIs whose plain geometry differs between the
     card and the CPU (recorded); then K2 and K3 against their plain
     versions on the pyramid and proposals of a flagship extraction
     batch (8 synthetic uint8 1024^2 images, the anatomy detector with
     random weights from the seed), with an elongated ROI that takes the
     level bump, at 1000 and 997 ROIs per image: f32 max abs error <=
     1e-5, bf16 within one bf16 ulp (equal share recorded);
  7. the extraction path: `extract.runner.build_detector_fns` +
     `Extractor` over 3 batches of 8 at 1024^2, bf16, records written
     to an in-memory sink; every record is checked, and K2 must launch
     twice a batch (anatomy + disease detector); then one batch with
     roi_backend 'pallas', where K3 must launch twice;
  8. timings: K2 and K3 per call (CUDA events around the launch alone,
     warm and with the L2 flushed, the profiler's device time, the whole
     wrapper, the launch on f32 maps) beside their plain versions, their
     bounds from the map positions these ROIs read, the bytes their taps
     move through L1/L2 and their resident warps per SM, extraction images/s
     end to end (host clock, records fetched), backbone ms per batch
     and a per-stage breakdown;
  9. greedy NMS: K4 (one call: the order kernel, then mask and scan in
     one cooperative kernel) against its plain version, the blocked NMS
     (`ops/nms.py::nms`) and the bitmask model (`nms_bitmask_plain`) at
     f32, selections equal in order, both as the path calls it (the
     mask built only as far as the walk needs) and with the whole mask
     built, and then K4's debug output (the order, L, the mask words it
     writes, rows walked, chunks, picks) bit-equal to the model's: at
     the bench geometry (8 images x 1000 boxes, 100 slots, IoU 0.5), on
     a hard set (ties, duplicate, zero-area and inverted boxes, padding
     rows, an image with nothing live, more slots than live rows, R not
     a multiple of 32, B=1), at R = MAX_ROWS, at the extraction geometry
     (the level-offset proposals that `generate_proposals` hands to
     `batched_nms` on a flagship batch: 4,768 rows an image, IoU 0.7,
     1000 slots) and on an edge set (-0.0 / 0.0 ties, NaN scores, one
     box repeated, IoU 0 and -0.1, more slots than live rows, R of 1,
     63, 64, 65, 1000); two calls bit-equal; then the NMS A/B entry
     point (`ekaid_torch.scripts.bench_nms`) through its `main`, where
     K4 must be called once a call; then times at both geometries (K4's
     call alone by CUDA events, warm and L2-flushed, and by
     torch.profiler, summed and by kernel, with its kernels a call; the
     wrapper; the plain version; the blocked NMS with its host reads)
     beside K4's bound, the design's own work (pairs, dividing pairs,
     mask bytes, mask tiles built) and the rows and chunks the scan
     walked;
 10. the training path at flagship width: one f32 train step (dropout
     off, ss_prob 0, B=8) on the card and on the CPU from the same
     seeded weights and batch, and the same step with every f32 cast
     promoted to f64: loss within 1e-5 relative, each gradient tensor
     of the card no further from the f64 step than TRAIN_GRAD_RATIO x
     the CPU's + TRAIN_GRAD_TOL (card to CPU recorded), and the Adam
     updates of the elements whose gradient stands above the card-CPU
     gap within UPDATE_TOL lr + 2 ulps of the CPU's; then
     `build_synthetic_trainer(corpus='learnable')` at bf16, batch 64,
     trained 8 steps with a snapshot and an eval of 4 batches at steps 4
     and 8: every logged loss and grad_norm finite, K1's launches equal
     to the eval decodes, each eval batch's step-0 tokens equal to the
     plain decode on weights built fresh from the current parameters,
     the two evals on different weights, the cached eval equal to the
     wire eval token for token; a fresh trainer restored at step 4 and
     run to 8 (its largest parameter gap to the uninterrupted run
     recorded); device memory flat over evals once the packed weight
     cache is full; then times (train step, QA pairs trained/s, the
     forward / backward / optimizer split, peak memory, eval pairs/s,
     K1 per eval decode) and one step under torch.profiler (the card's
     busy share of the step, its device activities, the top kernels).
     K1's launches here add to its `kernels` entry;
 11. the inference entry points on phase 10's snapshots (learnable
     corpus, flagship widths, bf16): (a) the eval driver
     (`train/test.py::run_test`) on the step-8 snapshot over EVAL_B
     batches of 64 of the learnable eval split, each batch's step-0
     tokens equal to the plain decode's and K1 launched once a batch,
     then timed again unchecked (the same answers), its results file
     through `score.main` (-a, then the caption
     metrics, both equal to the driver's scores), then `test.main`
     with --synthetic --max_batches 2; (b) beam search
     (`Trainer.evaluate(beam_size=3)`, plain torch, no K1 launch) timed
     on one batch, and a beam-3 f32 decode of 8 pairs on the card and
     on the CPU, rows equal except where the CPU's ranking had a
     near-tied cut; (c) `CoalescingEngine(coalesce_batch=16)` behind
     `make_handler` on 127.0.0.1: 16 client threads post 128
     /question requests (varied questions, some with detail), every
     reply equal to its own row of its batch decoded again by K1, each
     served batch's step-0 tokens equal to the plain decode's, K1's
     launches equal to the batches plus the warm-up, /health /sample /
     /refresh answered, drained; recorded: coalesced answers equal to
     batch-1 answers, requests/s, latency p50/p99, batches; then the
     plain batch-1 engine, 16 requests one at a time; (d) the
     extraction runner's --ana_ckpt/--dis_ckpt on `.pt` state dicts of
     the seeded detectors, its records bit-equal to the in-process
     path's on the same weights and images, K2 launched twice. K1's
     and K2's launches here add to their `kernels` entries;
 12. the detector's training path: (a) one f32 `FasterRCNN.losses`
     step (full widths, K=26, 256^2 images, batch 2, pre/post NMS
     2000/1000) on the card, on the CPU and with every f32 cast promoted
     to f64, from the same seeded weights, images, gts and draws (drawn
     on the CPU): whether the card's own discrete choices equal the
     CPU's is recorded, then the card and f64 steps replay the CPU's
     choices: losses card-CPU within DET_LOSS_RTOL, each gradient
     tensor of the card no further from f64 than TRAIN_GRAD_RATIO x the
     CPU's + TRAIN_GRAD_TOL; K2 refuses a pyramid that requires grad;
     (b) the flagship `DetectorTrainer` (anatomy, K=26, bf16, 1024^2,
     batch 8, augmentation on) over DET_TRAIN_IMAGES synthetic blob
     images for DET_STEPS steps: every logged loss finite, the first
     update leaving every parameter bit-equal (lr 0 at count 0); then
     `validation_loss` and `evaluate(proposals=True)`, K2 launched once
     an eval batch, and one eval batch's pooled features held against
     K2's plain version within one bf16 ulp; (c) the trained weights
     saved as a `.pt` and read by the extraction runner's --ana_ckpt:
     records bit-equal to the in-process `Extractor` on the same
     weights, K2 launched twice; (d) `train_detector.main` with
     --synthetic 8 --steps 2 at 256^2 and --ckpt_out; (e) times: train
     step (median of steps 3-6), images trained/s, the forward /
     backward / optimizer split, augmentation host ms a batch, peak
     memory, eval images/s, one step under torch.profiler. K2's
     launches here add to its `kernels` entry;
 13. from raw files to answers, through `ekaid_torch.tools.pipeline.main`
     with each stage timed by the host clock (the flagship detectors at
     1024^2, the `load_config()` VQA widths at bf16; steps cut): (a)
     `--stage all --synthetic 16` (detectors 4 steps, VQA 8 iterations):
     every stage's artifact there, every logged loss finite, one test
     prediction per test pair, K2 launched twice an extraction batch and
     once a detector-eval batch, K1 once an eval or test batch; a second
     `--stage extract` skipped because its file exists, then redone with
     --force; (b) 2 x RAW_PAIRS grayscale JPGs of assorted sizes and a
     question CSV over the seven question types, written by the phase,
     through convert (the shapes pickle holds the sizes written), the
     detector stage skipped on (a)'s checkpoints, extract (K2 twice a
     batch), preprocess (self-indexed rows, each feature_idx below the
     rows written), then train and test with a --cfg YAML that points
     data.* at this root: losses finite, each eval and test batch's
     step-0 tokens equal to the plain decode's on fresh weights, one
     prediction per test question; (c) `viz.ask.main` on (b)'s best
     snapshot, ASK_SAMPLES samples (the counts sum to it, K1 launched
     once, for the greedy answer), a multinomial decode of MULTI_ROWS
     pairs at f32 on the card and on the CPU from the same weights and
     Gumbel draws (tokens equal up to a near-tie of the CPU's scores,
     the equal prefix's logprobs within MULTI_LP_GATE; bf16 agreement
     recorded), `viz.examples` on (b)'s GT JSON; the figures are drawn
     where matplotlib is installed; (d) a Detectron2-layout R50-FPN
     state dict at full widths from seeded arrays, converted by
     `tools.torch_convert --kind detector`, fine-tuned through the
     pipeline's detector stage (--detector_init, 256^2, 2 steps; losses
     finite) and read by the extraction runner with frozen_bn,
     stride_in_1x1 and detectron2 preprocessing (K2 twice, records
     finite). Where h5py is not installed the feature file goes through
     a numpy stand-in for the part of h5py's API the port uses
     (`h5py_module`). K1's and K2's launches here add to their
     `kernels` entries.
 14. the eval knobs and the native host library, at flagship widths
     with phase 3's weights and batch: (a) `pair_batch`: the engine's
     bf16 model encodes B=64 with 'off' and 'on' (encoder ms, median of
     KNOB_REPS synced host clocks; device operations an encode from
     torch.profiler) and answers KNOB_ANSWERS batch-1 questions with each
     (K1 once an answer, counted); at f32, the encoder outputs of 'on'
     within PAIR_RTOL x max|x| of 'off', K1's tokens on both equal to the
     plain decode's up to a near-tie, and a training-mode forward (B=8)
     with 'train' bit-equal to 'on' under one generator; (b)
     `decode_kernel='xla'`, the torch step loop, never launching K1: f32
     B=64 tokens equal to K1's up to a near-tie, the equal prefix's
     logprobs within LOOP_LP_GATE; bf16 ms a batch beside K1's decode;
     (c) `weight_quant='int8'`: `quantize_matrix` on the card bit-equal
     to the CPU for every large core matrix; the f32 int8 loop of INT8_B
     rows card vs CPU (near-tie rule on the CPU's scores, prefix logprobs
     within LOOP_LP_GATE); bf16 B=64 ms, token share against the
     unquantized loop, peak memory; an int8 multinomial decode of INT8_B
     pairs (the ask path) whose logprobs must differ from the
     unquantized decode's on the same draws; (d) `fused_core`, which runs
     the core's own step: the f32 loop bit-equal to the unfused loop;
     (e) the native library: g++ build seconds cold and warm, phase 8's
     adjacency of 8 x 52 boxes bit-equal to numpy, both row gathers over
     a memmap of GATHER_ROWS rows byte-equal to numpy slicing, 11a's
     caption scores native against Python within CAPTION_TOL, host graph
     assembly ms, the caption metrics' seconds and BLEU + ROUGE-L's
     (the metrics with native parts), native and plain. K1's launches
     here add to its `kernels` entry.
 15. the last modules of the port: (a) mode0 (pixels in) at flagship
     widths, bf16, R101-GN over M0_SIZE^2 synthetic grayscale images
     (`mode0_trainer`): M0_TRAIN_STEPS train steps at batch M0_B (step
     ms, peak memory, losses finite), one eval batch, then the
     `InferenceEngine`: encode + K1 decode of B=M0_B timed (pairs/s) and
     M0_ANSWERS batch-1 answers (median ms); K1's launches must equal
     the decodes (15a and 15b's live ones); the train steps launch no K5
     (gradients: the plain chain), and an encode of the inference-cast
     model, its graphs dropped, launches K5 104 times a trunk call when
     eager, records as many into its graph when captured, and its
     eager run and a replay, traced, show K5 and no
     RowwiseMomentsCUDAKernel (`mode0_k5`); gates outside the count: the
     bf16 step-0 tokens equal the plain decode's, and at f32 with TF32
     off the card's encoder outputs on M0_GATE_ROWS rows within
     M0_ENC_RTOL of the largest magnitude of the CPU's, and K1 on them
     equal to its plain version under the near-tie rule; (b) the
     serving artifact exported from 15a's engine (batch 1 and
     COALESCE), then two fresh processes (`startup_child`): cold, with
     an empty kernel build directory (nvcc must run), and from the
     artifact (no nvcc process may start, the build directory stays
     empty); the seconds from the spawn to the first answer of each;
     the artifact's batch-1 and coalesced decodes of STARTUP_ITEMS
     questions bit-equal to the live engine's (both on the full-width
     wire); (c) a `torch.distributed` group of one process (NCCL),
     in-process: one DDP f32 step at TRAIN_B equal to the plain step
     (loss within TRAIN_LOSS_RTOL, each gradient within TRAIN_GRAD_TOL
     of the tensor's largest magnitude; bit-equal tensors recorded),
     both timed in turns; the trainer in DDP for 2 steps with a
     snapshot and an eval (K1 once); the extraction runner's `--dp 1`
     records bit-equal to `--dp 0`'s over DP_IMAGES images (images/s
     from the runner's own line, K2 twice a batch), `--dp` above the
     visible devices refused; (d) the native `match_disease` equal to
     `match_disease_to_anatomy` on phase 8's dispatched batch (as
     detected, with every detection counted valid, and with the next
     image's anatomy boxes as the detections) and
     `exact_match` equal to the plain comparison on phase 11a's
     answers. K1's and K2's launches here add to their `kernels`
     entries.
 16. the data axis: MESH_DATA fresh interpreters, all on cuda:0, joined
     in a gloo group through a `file://` rendezvous (NCCL takes one rank
     a device), K1 loaded from phase 2's library (no nvcc). (a) At
     flagship widths, f32 with TF32 off, one train step in DDP with
     dropout off at TRAIN_B, each rank on its rows r::data (the loss's
     denominators all-reduced, the gradients averaged over the group):
     the ranks' updated parameters are equal, and against the
     one-process step on the card that takes the ranks' rows as its
     MESH_DATA microbatches (accum_steps: microbatch i is rows
     i::data, so each product runs at a rank's shape; the whole batch
     in one product stands ~1e-3 of a tensor's max off in the implicit
     relation, whose log(relu) magnifies the f32 rounding of a product
     at another shape) the loss is within TRAIN_LOSS_RTOL,
     each gradient tensor within TRAIN_GRAD_TOL of its largest
     magnitude (10a's floor) and the Adam-updated parameters within
     MESH_PARAM_RTOL / MESH_PARAM_ATOL where the gradient stands
     UPDATE_SIGNAL x above the tensor's gap (on at least
     UPDATE_MIN_SHARE of the elements; Adam's first step moves an
     element at noise size by about +-lr either way), every element
     within 2 lr; (b) one eval
     batch of MESH_EVAL_B at flagship widths through `EkaidModel.decode`
     on the data axis, at f32 (TF32 off) and at bf16: each rank decodes
     its contiguous block through K1 (once on every rank), and the
     blocks are gathered; f32: tokens equal to the one-process plain
     decode up to a near-tie, the equal prefix's logprobs within
     MESH_LP_GATE of the one-process K1 decode; bf16: step-0 tokens
     equal up to a near-tie under BF16_STEP0_GAP, the token share and
     gaps recorded. K1's launches here (every rank's eval decodes) add
     to its `kernels` entry.
 17. the trunk's GroupNorm, K5 (`csrc/group_norm.cu`), at mode0's
     shapes (every GroupNorm of the R101 over M0_SIZE^2 images, batch
     M0_B, bf16 inference-cast affine): at each distinct shape and
     epilogue, the kernel against the plain chain (`group_norm_plain`
     and the next convolution's copy to channels-last), at least
     GN_EQUAL_SHARE of the outputs bit-equal and none further than one
     bf16 ulp of the normalised value (plus one of the sum after the
     residual add; an ulp taken at no less than 2^-8); then device
     times by CUDA events, warm, each from a CUDA graph of calls back to
     back (`graph_ms`, so the host's launch is out of them): each
     shape's launch and its plain chain, the bound from its bytes (the
     map read and written once, the residual read once, at 3.35 TB/s),
     the sums over a batch (two trunks of 104), and one trunk's 104
     launches in order; and the wrapper's host time a call. K5's
     `kernels` entry counts its launches by path: those of phases 1-14
     (the extraction backbones and the detectors' evals, all eager, by
     the wrapper's count) and 15a's traced mode0 encodes; this phase's
     checks and timings are not in it.
Prints one `kernels` JSON line, the card line, and as the last line
{"ok": true, "device": {...}}, after a `record:` line with every number
as JSON. Without a CUDA device, or outside the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
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
ROLLED_SETS = 8                    # K1 on other weights: f32 gated, bf16
                                   # recorded
# a near-tie: the plain version's two best logprobs closer than K1's f32
# logprob error measured in phase 3, or than this floor
NEAR_TIE_FLOOR = 1e-6
ROI_F32_GATE = 1e-5                # K2/K3 vs plain, f32 max abs error
EXTRACT_BATCHES = 3
# ROIs whose long side takes the level bump (on a 1024^2 image)
ELONGATED_ROIS = ((0.0, 300.0, 1000.0, 350.0), (100.0, 0.0, 160.0, 900.0))
# the boundary ROIs' distance from each level boundary, in f32 ulps
BOUNDARY_ULPS = 8
# K4's IoU pass, f32 operations per live row and step: iw and ih (min,
# max, subtract, clamp each), the product, the union (add, subtract),
# the quotient, the threshold test and the arg-max comparison
NMS_OPS_PER_ROW = 14
# phase 10: the training path
TRAIN_B = 8                        # the card-vs-CPU f32 step
TRAIN_LOSS_RTOL = 1e-5
# the card's gradients no further from the step in f64 than this many
# times the CPU's, plus TRAIN_GRAD_TOL; distances of each tensor over
# its largest magnitude, or over GRAD_FLOOR of the largest of all
TRAIN_GRAD_RATIO = 2.0
TRAIN_GRAD_TOL = 2e-4
GRAD_FLOOR = 1e-3
# the updates of elements whose |g| is over UPDATE_SIGNAL x the tensor's
# card-CPU gradient gap: within UPDATE_TOL lr + 2 ulps of the CPU's, on
# at least UPDATE_MIN_SHARE of the elements
UPDATE_SIGNAL = 10.0
UPDATE_TOL = 1e-2
UPDATE_MIN_SHARE = 0.25
TRAIN_STEPS = 8                    # two snapshots, at 4 and 8
EVAL_BATCHES = 4
# phase 11: the inference entry points
EVAL_B = 8                         # eval-driver batches of 64
BEAM = 3
BEAM_PAIRS = 8                     # the card-vs-CPU f32 beam decode
SERVE_REQUESTS = 128
SERVE_CLIENTS = 16
PLAIN_REQUESTS = 16
DET_IMAGES = 8
# phase 12: the detector's training path
DET_F32_SIZE = 256                 # the card-vs-CPU f32 loss step
DET_F32_B = 2
DET_LOSS_RTOL = 1e-4
DET_STEPS = 6                      # the flagship DetectorTrainer
DET_TRAIN_IMAGES = 16
DET_CLI_SIZE = 256
# phase 13: from raw files to answers
PIPE_SYNTHETIC = 16                # 13a: synthetic images
PIPE_DET_STEPS = 4
PIPE_TRAIN_ITERS = 8
RAW_PAIRS = 80                     # 13b: questions; 2 x RAW_PAIRS JPGs
ASK_SAMPLES = 32                   # 13c
MULTI_ROWS = 8                     # the card-vs-CPU multinomial decode
MULTI_LP_GATE = 1e-4
CONV_IMAGES = 8                    # 13d
# phase 14: the eval knobs and the native host library
KNOB_REPS = 10                     # 14a: encodes timed a setting
KNOB_ANSWERS = 10                  # 14a: batch-1 answers timed a setting
PAIR_RTOL = 1e-5                   # 14a: 'on' vs 'off', of max|x|
INT8_B = 8                         # 14c: the card-vs-CPU int8 decode
LOOP_LP_GATE = 1e-4                # 14b-d: logprobs of the equal prefix
GATHER_ROWS = 1000                 # 14e: rows of the memmap
CAPTION_TOL = 1e-12                # 14e: caption scores, native vs Python
M0_B = 64                          # 15a: the flagship batch
M0_SIZE = 128                      # the reference's mode0 images: 128^2
M0_POOL = 256                      # synthetic images (feature_idx < 256)
M0_GATE_ROWS = 4                   # 15a: f32 card vs CPU
M0_ENC_RTOL = 1e-3                 # of each output's largest magnitude
M0_DECODE_REPS = 5
GN_EQUAL_SHARE = 0.99              # 17: K5's outputs bit-equal to plain
GN_REPS = (50, 10)                 # 17: timed calls, kernel and plain
M0_ANSWERS = 10
M0_TRAIN_STEPS = 4
COALESCE = 16                      # 15b: the exported coalescing batch
STARTUP_ITEMS = 4                  # 15b: answers compared bit for bit
STARTUP_TIMEOUT_S = 420
DP_IMAGES = 24                     # 15c: three batches of 8 at 1024^2
MESH_DATA = 2                      # 16: two ranks on one card, gloo
MESH_EVAL_B = 64                   # 16: the eval batch, 32 rows a rank
MESH_LP_GATE = 1e-4                # 16: f32 eval, logprobs of the prefix
MESH_PARAM_RTOL, MESH_PARAM_ATOL = 2e-4, 2e-6   # 16a: Adam's updates
MESH_TIMEOUT_S = 300


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


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of `fn` (CUDA work only, capturable): a
    CUDA graph of `reps` calls back to back, replayed and timed by CUDA
    events, over `reps`. The host's launch of each call is out of it."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 5) / reps


def cold_l2_ms(fn, reps: int) -> float:
    """Mean time of `fn` by CUDA events around each call, with the 50 MB
    L2 flushed before it (a 128 MB buffer written)."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    ts = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.mean(ts)


def profiler_kernels(fn, stem: str, reps: int = 10) -> dict:
    """For each CUDA kernel whose name holds `stem`: its device ms and its
    launches per call of `fn`, from a torch.profiler trace of `reps`
    calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if stem in e.key:
            us = (getattr(e, "device_time_total", 0)
                  or getattr(e, "cuda_time_total", 0))
            out[e.key] = {"ms": us / reps / 1e3, "launches": e.count / reps}
    return out


def profiler_kernel_ms(fn, kernel_name: str, reps: int = 10):
    """Device time per call of the CUDA kernels whose name holds
    `kernel_name`, summed, from a torch.profiler trace of `reps` calls of
    `fn`; None where the trace shows no device time for them."""
    ms = sum(k["ms"] for k in profiler_kernels(fn, kernel_name,
                                               reps).values())
    return ms or None


def device_busy(fn, reps: int = 2, top: int = 8) -> dict:
    """A torch.profiler trace (device activity only) of `reps` calls of
    `fn`: the host wall time a call, the time the card was busy within
    it (the union of its kernel, copy and set intervals), their ratio,
    the launches a call, and the `top` kernels by device time with their
    ms and launches a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (b - a) / 1e3, n + 1)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_us / reps / 1e3, "busy_ms": busy / reps / 1e3,
            "busy_share": busy / wall_us if wall_us else None,
            "launches": len(spans) / reps,
            "device_ms_sum": sum(v[0] for v in by_name.values()) / reps,
            "top": [{"name": k[:80], "ms": v[0] / reps,
                     "launches": v[1] / reps} for k, v in kernels]}


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


def top2_gap(logits, t: int, banned=None):
    """The gap between the two best logprobs of f32 `logits` [B, V] at
    step t, in f64, with the step's bans (NULL at step 0; `banned` [B],
    the previous tokens under the decoding constraint)."""
    import torch
    lg = logits.double()
    lp = lg - torch.logsumexp(lg, -1, keepdim=True)
    if t == 0:
        lp[:, 0] = -math.inf
    elif banned is not None:
        lp[torch.arange(len(lp), device=lp.device), banned.long()] = -math.inf
    top = torch.topk(lp, 2, dim=-1).values
    return top[:, 0] - top[:, 1]


def near_tie_agree(w, sp, policy, fused, feats, ref, out, tol: float,
                   what: str) -> dict:
    """Two greedy decodes agree if each row's tokens are equal to the
    end, or up to the first step where the plain version's two best
    logprobs are closer than `tol` (a near-tie: from there the rows may
    go apart). A difference before any such step fails. `ref` is the
    plain version's decode of (w, sp, policy, fused, feats). Returns
    the rows that differ, each with its first differing step, its first
    near-tie and that tie's gap."""
    from ekaid_torch.models.greedy_decode import greedy_decode_plain
    d = (ref["seq"] != out["seq"]).cpu()
    rows = [int(r) for r in d.any(1).nonzero()[:, 0]]
    r = {"rows_differ": len(rows), "rows": []}
    if not rows:
        return r
    first = {row: int(d[row].nonzero()[0]) for row in rows}
    gaps = []
    for t in range(max(first.values()) + 1):
        lg = greedy_decode_plain(w, sp.replace(seq_length=t + 1), policy,
                                 fused, feats, scratch=True)["logits"]
        banned = ref["seq"][:, t - 1] if (t and sp.decoding_constraint) \
            else None
        gaps.append(top2_gap(lg, t, banned).cpu())
    for row in rows:
        ties = [t for t in range(first[row] + 1) if gaps[t][row] < tol]
        item = {"row": row, "step": first[row],
                "near_tie_step": ties[0] if ties else None,
                "gap": float(gaps[ties[0] if ties else first[row]][row])}
        r["rows"].append(item)
        if not ties:
            raise AssertionError(
                f"{what}: row {row} differs at step {first[row]} with no "
                f"near-tie (< {tol:.3g}) up to it; the plain version's "
                f"top-2 gap there is {item['gap']:.3g}")
    return r


def boundary_rois(n_ulps: int = BOUNDARY_ULPS, scale0: float = 0.25):
    """f32 boxes [N, 4] at the level boundaries of the ROI geometry, and
    up to `n_ulps` f32 ulps either side: squares whose sqrt(area) is 112,
    224 or 448 px (levels 3, 4, 5 begin there), at the origin and
    offset, and thin boxes whose long side x `scale0` is 44 * 2^k px,
    k = 0..2 (the elongated-ROI bump begins there), lying and standing."""
    import numpy as np
    f32 = np.float32

    def around(v):
        bits = np.array([v], f32).view(np.int32)
        return (bits + np.arange(-n_ulps, n_ulps + 1, dtype=np.int32)
                ).view(f32)

    boxes = []
    for side in (112.0, 224.0, 448.0):
        for w in around(side):
            boxes += [[0, 0, w, w], [16, 8, f32(16) + w, f32(8) + w]]
    for k in range(3):
        for ls in around(44.0 * 2.0 ** k / scale0):
            boxes += [[0, 300, ls, 310], [5, 0, 15, ls]]
    return np.array(boxes, f32)


def roi_geometry_checks(rec: dict, fm16, rois) -> None:
    """Phase 6's geometry: how the card divides by a Python scalar
    (recorded), the kernel's geometry against `_roi_geometry` on the card
    bit for bit (gated) on the batch's ROIs and the boundary set, and
    the ROIs whose plain geometry differs between the card and the CPU
    (recorded)."""
    import torch
    from ekaid_torch.models.detector.faster_rcnn import FPN_SCALES
    from ekaid_torch.ops import roi_kernels as rk
    dev = rois.device
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand(2_000_000, generator=g, device=dev) * 1024
    xc = x.cpu()
    rec["scalar_division"] = {
        str(d): {"scalar_vs_0d": int((x / d != x / torch.tensor(
                     d, device=dev)).sum()),
                 "0d_vs_cpu": int((x / torch.tensor(d, device=dev)).cpu()
                                  .ne(xc / d).sum())}
        for d in (7.0, 44.0, 224.0)}
    log(f"  x / d on the card, 2M f32 values, elements where the Python "
        f"scalar's quotient differs from the 0-d tensor's, and the 0-d "
        f"tensor's from the CPU's: {rec['scalar_division']}")
    sets = {"batch": (fm16, rois),
            "boundary": ([f[:1] for f in fm16], torch.as_tensor(
                boundary_rois(), device=dev)[None])}
    r = rec["roi_geometry"] = {}
    for what, (fms, rr) in sets.items():
        _, _, _, _, _, img, lvl, fmeta = rk._prepare(fms, rr, FPN_SCALES,
                                                     7, 2, 2)
        for round_a in (True, False):
            k_img, k_lvl, k_fmeta = rk.kernel_geometry(
                fms, rr, FPN_SCALES, round_a=round_a)
            torch.cuda.synchronize()
            if not (torch.equal(k_img, img) and torch.equal(k_lvl, lvl)
                    and torch.equal(k_fmeta.view(torch.int32),
                                    fmeta.view(torch.int32))):
                bad = ((k_lvl != lvl) | (k_fmeta.view(torch.int32)
                       != fmeta.view(torch.int32)).any(1)).sum().item()
                raise AssertionError(f"kernel geometry ({what}, round_a "
                                     f"{round_a}) differs from "
                                     f"_roi_geometry on {bad} ROIs")
        _, _, _, _, _, _, c_lvl, c_fmeta = rk._prepare(
            [f.cpu() for f in fms], rr.cpu(), FPN_SCALES, 7, 2, 2)
        r[what] = {"rois": int(lvl.numel()),
                   "levels": torch.bincount(lvl, minlength=4).tolist(),
                   "card_vs_cpu_differ": int(
                       ((c_lvl != lvl.cpu())
                        | (c_fmeta.view(torch.int32)
                           != fmeta.cpu().view(torch.int32)).any(1)).sum())}
    log(f"  kernel geometry == _roi_geometry on the card, bit for bit (K2 "
        f"and K3 instances): {r}; card_vs_cpu_differ counts ROIs whose "
        "plain geometry differs between the card and the CPU")


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
    # what the kernel moves through L1/L2: every tap of every bin reads
    # all C channels of its position, and the output is written once
    tap_bytes = float((ny * nx).sum()) * C * esize
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
            "read_mb": n_pos * C * esize / 1e6,
            "out_mb": out_bytes / 1e6,
            "tap_mb": tap_bytes / 1e6,
            "l1l2_mb": (tap_bytes + out_bytes) / 1e6,
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


def extraction(rec: dict, cfg=None, device: str = "cuda",
               keep: dict = None) -> list:
    """Phases 6-8: K2/K3 against their plain versions, the extraction
    path, and the times, at the flagship detector config unless `cfg`
    is given. Returns the kernels-line entries of K2 and K3; `keep`
    receives the extractor and one dispatched batch (phase 14e)."""
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
    roi_geometry_checks(rec, fm16, rois)
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
            """The ctypes launch alone, arguments and output made before."""
            args = rk._kernel_args(fmaps, rois, FPN_SCALES, 7, 2, 2)
            out = torch.empty(args.rois.shape[0], 7, 7,
                              args.fmaps[0].shape[-1],
                              dtype=args.fmaps[0].dtype, device=dev)
            return lambda: rk._kernel_launch(args, out, 2, round_a)

        alone16 = launch_alone(fm16, round_a)
        alone32 = launch_alone(fm32, round_a)
        runs = {"plain": [], "wrapper": [], "kernel": [], "kernel_cold": [],
                "kernel_f32": []}
        for which in ("plain", "wrapper", "kernel", "kernel_cold",
                      "kernel_f32", "kernel_f32", "kernel_cold", "kernel",
                      "wrapper", "plain"):
            if which == "kernel_cold":
                runs[which].append(cold_l2_ms(alone16, 10))
                continue
            f = {"plain": lambda: plain(fm16, rois, FPN_SCALES),
                 "wrapper": lambda: fn(fm16, rois, FPN_SCALES),
                 "kernel": alone16, "kernel_f32": alone32}[which]
            runs[which].append(cuda_ms(f, 2 if which == "plain" else 20))
        b = roi_bound(fm16, rois, FPN_SCALES)
        b32 = roi_bound(fm32, rois, FPN_SCALES)
        r = rec["roi"][name]
        r.update(b, ms=statistics.mean(runs["kernel"]),
                 cold_ms=statistics.mean(runs["kernel_cold"]),
                 wrapper_ms=statistics.mean(runs["wrapper"]),
                 f32_ms=statistics.mean(runs["kernel_f32"]),
                 f32_bound_ms=b32["bound_ms"], f32_l1l2_mb=b32["l1l2_mb"],
                 plain_ms=statistics.mean(runs["plain"]),
                 profiler_kernel_ms=profiler_kernel_ms(alone16,
                                                       "roi_align_kernel"),
                 runs=runs)
        r["warps_per_sm"] = {
            dt: rk.resident_warps_per_sm(getattr(torch, dt), round_a)
            for dt in ("bfloat16", "float32")}
        r["l1l2_tb_per_s"] = b["l1l2_mb"] / r["ms"] / 1e3     # MB/ms=GB/s
        r["f32_l1l2_tb_per_s"] = b32["l1l2_mb"] / r["f32_ms"] / 1e3
        log(f"[8] {name} bf16 {tuple(rois.shape)}: launch alone "
            f"{r['ms']:.4f} ms (runs {['%.4f' % v for v in runs['kernel']]}"
            f"; profiler's device time {r['profiler_kernel_ms']}), L2 "
            f"flushed {r['cold_ms']:.4f} ms, whole wrapper "
            f"{r['wrapper_ms']:.4f} ms, f32 maps {r['f32_ms']:.4f} ms "
            f"(bound {b32['bound_ms']:.4f}); plain {r['plain_ms']:.1f} ms; "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
            f"{b['read_mb']:.1f} MB of the {b['pyramid_mb']:.1f} MB "
            f"pyramid read, {b['out_mb']:.1f} MB written, at 3.35 TB/s; "
            f"{b['gflop']:.2f} GFLOP); through L1/L2 {b['l1l2_mb']:.1f} MB "
            f"({b['tap_mb']:.1f} MB of taps + the output), "
            f"{r['l1l2_tb_per_s']:.2f} TB/s (f32 {b32['l1l2_mb']:.1f} MB, "
            f"{r['f32_l1l2_tb_per_s']:.2f} TB/s); resident warps per SM "
            f"{r['warps_per_sm']}")
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
    if keep is not None:
        keep.update(extractor=ex, dispatched=disp)
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


def nms_edge_set():
    """(name, boxes [B, R, 4], scores [B, R], iou, max_out) cases, numpy
    f32, for the bitmask order and scan: -0.0 / 0.0 ties, NaN scores,
    every row the same box, IoU 0 and -0.1, more slots than live rows, and
    R of 1, 63, 64, 65 and 1000 (a word's edges)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 11)
    b, r = 3, 130

    def boxes_of(shape, lo=100, hi=400):
        c = rng.uniform(lo, hi, (*shape, 2))
        s = rng.uniform(10, 150, (*shape, 2))
        return np.concatenate([c - s / 2, c + s / 2], -1).astype(np.float32)

    bx = boxes_of((b, r))
    sc = rng.uniform(0, 1, (b, r)).astype(np.float32)
    zeros = rng.choice(np.array([-0.0, 0.0, 0.5], np.float32), (b, r))
    nan = sc.copy()
    nan[rng.uniform(size=(b, r)) < 0.2] = np.nan
    same = np.broadcast_to(np.array([[[50, 60, 150, 140]], [[70, 70, 70, 90]],
                                     [[10, 10, 20, 20]]], np.float32),
                           (b, r, 4)).copy()            # one box; zero area
    tied = (rng.integers(1, 4, (b, r)) / 3).astype(np.float32)
    padded = sc.copy()
    padded[:, 70:] = -1e9                               # 70 live rows
    cases = [("signed zeros", bx, zeros, 0.5, 40),
             ("NaN scores", bx, nan, 0.5, 60),
             ("one box", same, tied, 0.5, 20),
             ("IoU 0", bx, sc, 0.0, 50),
             ("IoU -0.1", bx, sc, -0.1, 10),
             ("max_out > L", bx, padded, 0.5, 100)]
    for rr in (1, 63, 64, 65, 1000):
        cases.append((f"R={rr}", boxes_of((2, rr), 100, 900),
                      rng.uniform(0, 1, (2, rr)).astype(np.float32), 0.5,
                      100))
    return cases


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


def bitmask_same(got: dict, want: dict, what: str) -> None:
    """K4's debug output bit-equal to `nms_bitmask_plain`'s: the order of
    every row, L, the mask words the kernels write, and the scan's
    counts."""
    import torch
    for k in ("order", "live", "walked", "chunks", "picks"):
        if not torch.equal(got[k].long(), want[k].long()):
            bad = (got[k].long() != want[k].long()).sum().item()
            raise AssertionError(f"{what}: debug {k} differs in {bad} places")
    written = written_words(want)
    differ = (got["mask"] != want["mask"]) & written
    if differ.any():
        raise AssertionError(f"{what}: {differ.sum().item()} of "
                             f"{written.sum().item()} mask words differ")


def written_words(dbg: dict):
    """bool [n, R, W]: the mask words K4 writes, from its debug output."""
    from ekaid_torch.ops import nms_kernel as nk
    return nk.mask_words_written(dbg["live"].long(), dbg["order"].shape[1])


def bitmask_work(boxes, dbg: dict) -> dict:
    """What the bitmask design computes on these inputs, beside the
    function's least work: the upper-triangle pairs of live rows, those
    whose intersection is not 0 (they take the division), the mask words
    of the whole triangle and their bytes, and the words of the walked
    rows up to the last walked chunk (the most the scan may read)."""
    import torch
    n, r = dbg["order"].shape
    live = dbg["live"].long()
    sb = torch.gather(boxes.reshape(n, r, 4), 1,
                      dbg["order"].long()[..., None].expand(n, r, 4))
    x1, y1, x2, y2 = sb.unbind(-1)
    col = torch.arange(r, device=boxes.device)
    dividing = 0
    for s in range(0, r, 256):
        k = col[s:s + 256, None]
        iw = torch.clamp(torch.minimum(x2[:, None], x2[:, s:s + 256, None])
                         - torch.maximum(x1[:, None], x1[:, s:s + 256, None]),
                         min=0.0)
        ih = torch.clamp(torch.minimum(y2[:, None], y2[:, s:s + 256, None])
                         - torch.maximum(y1[:, None], y1[:, s:s + 256, None]),
                         min=0.0)
        dividing += int(((iw * ih != 0) & (col > k)
                         & (col < live[:, None, None])).sum())
    words = int(written_words(dbg).sum())
    walked, chunks = dbg["walked"].long(), dbg["chunks"].long()
    prefix = sum(int((c - torch.arange(w, device=live.device) // 64).sum())
                 for w, c in zip(walked.tolist(), chunks.tolist()))
    return {"pairs": int((live * (live - 1) // 2).sum()),
            "dividing_pairs": dividing, "mask_words": words,
            "mask_bytes": 8 * words, "walked_prefix_words": prefix}


def nms_phase(rec: dict, cfg, device: str = "cuda") -> dict:
    """Phase 9: K4 against its plain versions and the blocked NMS, its
    debug output against the bitmask model, the NMS A/B entry point, and
    the times. Returns K4's kernels-line entry."""
    import re
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
    # the most rows the order kernel sorts
    mb, ms = bench_nms.make_inputs(2, nk.MAX_ROWS, SEED + 1)
    cases.append((f"R={nk.MAX_ROWS}", T(mb), T(ms), 0.5, 50))
    cases.append(("extraction geometry", *geoms["extraction"]))
    cases += [(n, T(b), T(s), iou, m) for n, b, s, iou, m in nms_edge_set()]

    # ---- 9a. K4 against its plain versions and the blocked NMS -----------
    r9 = rec["nms"] = {"cases": {}}
    debug = {}
    log("[9] K4 vs plain vs blocked NMS, f32, selections equal in order; "
        "with the whole mask built, K4's order, mask and scan counts "
        "bit-equal to the bitmask model")
    for name, boxes, scores, iou, max_out in cases:
        got = nk.nms_kernel(boxes, scores, iou, max_out)
        dbg = {}                     # a call that builds the whole mask
        full = nk.nms_kernel(boxes, scores, iou, max_out, debug=dbg)
        live = torch.zeros(scores.shape[0], dtype=torch.int64, device=dev)
        plain = nk.nms_kernel_plain(boxes, scores, iou, max_out,
                                    live_rows=live)
        blocked = nms_ops.nms(boxes, scores, iou, max_out)
        model = nk.nms_bitmask_plain(boxes, scores, iou, max_out, debug=True)
        torch.cuda.synchronize()
        nms_same(got, plain, f"{name}: K4 vs plain")
        nms_same(got, blocked, f"{name}: K4 vs blocked nms")
        nms_same(full, plain, f"{name}: K4 with the whole mask vs plain")
        nms_same(got, (model["idx"], model["valid"]),
                 f"{name}: K4 vs bitmask model")
        bitmask_same(dbg, model, f"{name}: K4 vs bitmask model")
        debug[name] = dbg
        r9["cases"][name] = c = {
            "shape": list(scores.shape), "iou": iou, "max_out": max_out,
            "picks": got[1].sum(-1).tolist(), "live_rows": live.tolist(),
            "L": dbg["live"].tolist(), "walked": dbg["walked"].tolist(),
            "chunks": dbg["chunks"].tolist()}
        log(f"  {name}: {tuple(scores.shape)} IoU {iou} max_out {max_out}:"
            f" equal, debug bit-equal; picks per image {c['picks']}; live "
            f"rows over the steps {sum(c['live_rows'])}; rows walked "
            f"{c['walked']} in {c['chunks']} chunks of 64")
    hard = r9["cases"]["hard set"]["picks"]
    if hard[3] > 37 or hard[4] != 0:
        raise AssertionError(f"hard set picks {hard}: the padded image has "
                             "37 live rows, the dead one none")
    # a second call gives the same bits
    for g in ("bench geometry", "extraction geometry"):
        boxes, scores, iou, max_out = next(c[1:] for c in cases if c[0] == g)
        again = {}
        got = nk.nms_kernel(boxes, scores, iou, max_out, debug=again)
        first = nk.nms_kernel(boxes, scores, iou, max_out)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], first[0]) and torch.equal(got[1],
                                                              first[1])):
            raise AssertionError(f"{g}: two K4 calls differ")
        written = written_words(debug[g])
        for k, v in debug[g].items():
            same = (torch.equal(v[written], again[k][written]) if k == "mask"
                    else torch.equal(v, again[k]))
            if not same:
                raise AssertionError(f"{g}: two K4 calls differ in {k}")
    log("  two K4 calls bit-equal (indices, valid, order, mask, counts) at "
        "the bench and extraction geometries")

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
        idx, valid, scratch = nk.kernel_buffers(n, r, max_out, dev)

        def alone():
            nk._kernel_launch(boxes, scores, iou, idx, valid, scratch)

        reads = nms_ops._survivor_mask.host_reads
        nms_ops.nms(boxes, scores, iou, max_out)
        reads = nms_ops._survivor_mask.host_reads - reads
        runs = {"kernel": [], "blocked": []}
        for which in ("kernel", "blocked", "blocked", "kernel"):
            runs[which].append(cuda_ms(
                alone if which == "kernel" else
                lambda: nms_ops.nms(boxes, scores, iou, max_out),
                20 if which == "kernel" else 5))
        split = {re.search(r"nms_(\w+?)_kernel", k).group(1): v
                 for k, v in profiler_kernels(alone, "nms_").items()}
        c = r9["cases"][f"{g} geometry"]
        picks, steps = sum(c["picks"]), max(c["picks"])
        live = sum(c["live_rows"])
        t = r9[g] = dict(
            nms_bound(n, r, max_out, live),
            ms=statistics.mean(runs["kernel"]),
            cold_l2_ms=cold_l2_ms(alone, 20),
            wrapper_ms=cuda_ms(lambda: nk.nms_kernel(boxes, scores, iou,
                                                     max_out), 20),
            profiler_kernel_ms=sum(v["ms"] for v in split.values()) or None,
            profiler_split_ms={k: v["ms"] for k, v in split.items()},
            kernels_per_call=sum(v["launches"] for v in split.values()),
            scratch_bytes=nk.scratch_bytes(n, r),
            design=bitmask_work(boxes, debug[f"{g} geometry"]),
            blocked_ms=statistics.mean(runs["blocked"]),
            blocked_host_reads=reads, max_picks=steps, picks=picks,
            live_rows=live, walked=c["walked"], chunks=c["chunks"],
            runs=runs,
            # the plain version at max_out=1000 is a 1000-step loop
            plain_ms=cuda_ms(lambda: nk.nms_kernel_plain(
                boxes, scores, iou, max_out), 2 if g == "bench" else 1))
        t["x_bound"] = t["ms"] / t["bound_ms"]
        d = t["design"]
        # row tiles the producers built in the last timed call, against
        # the whole triangle of the debug call
        d["tiles_built"] = int(nk.scratch_views(scratch, n, r)["tiles"].sum())
        d["tiles_whole"] = int(debug[f"{g} geometry"]["tiles"].sum())
        log(f"    K4 {g} {tuple(scores.shape)}, IoU {iou}, {max_out} slots: "
            f"launch alone {t['ms']:.4f} ms (runs "
            f"{['%.4f' % v for v in runs['kernel']]}; L2 flushed "
            f"{t['cold_l2_ms']:.4f}; profiler's device time "
            f"{t['profiler_kernel_ms']}, by kernel "
            f"{t['profiler_split_ms']}, {t['kernels_per_call']} kernels a "
            f"call), wrapper {t['wrapper_ms']:.4f} ms; {picks} picks, rows "
            f"walked {c['walked']} in {c['chunks']} chunks of 64; bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']}: {t['mflop']:.1f} MFLOP"
            f" over {live} live rows at 67 TFLOP/s, {t['kbytes']:.0f} KB at "
            f"3.35 TB/s), {t['x_bound']:.0f}x; design: {d['pairs']} pairs, "
            f"{d['dividing_pairs']} with an intersection, "
            f"{d['tiles_built']} of {d['tiles_whole']} mask tiles built, "
            f"{d['mask_bytes'] / 1e6:.2f} MB of mask "
            f"words ({d['walked_prefix_words']} of {d['mask_words']} words in "
            f"the walked prefix), scratch {t['scratch_bytes'] / 1e6:.2f} MB; "
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


def rolled_sets_f32(rec: dict, w32, sp, fused, feats) -> None:
    """Gates: K1 at f32 on the ROLLED_SETS parameter sets (the product
    weights rolled by 1..ROLLED_SETS rows), plain and with the decoding
    constraint, against its plain version under the near-tie rule."""
    from ekaid_torch.models.greedy_decode import (
        PRODUCT_WEIGHTS, greedy_decode, greedy_decode_plain)
    from ekaid_torch.utils.dtypes import F32
    products = {n for names in PRODUCT_WEIGHTS.values() for n in names}
    tol = rec["near_tie_tol"]
    r = rec["rolled_sets_f32"] = []
    for shift in range(1, ROLLED_SETS + 1):
        w = {k: v.roll(shift, 0).contiguous() if k in products else v
             for k, v in w32.items()}
        for what, s in (("plain", sp),
                        ("constraint", sp.replace(decoding_constraint=1))):
            ref = greedy_decode_plain(w, s, F32, fused, feats)
            out = greedy_decode(w, s, F32, fused, feats)
            e = near_tie_agree(w, s, F32, fused, feats, ref, out, tol,
                               f"rolled set {shift} f32 {what}")
            r.append({"shift": shift, "decode": what, **e})
    differ = [(e["shift"], e["decode"], e["rows"]) for e in r
              if e["rows_differ"]]
    log(f"  rolled sets 1-{ROLLED_SETS}, f32 B={fused.shape[0]}, plain and "
        f"constraint: agree under the near-tie rule (tol {tol:.3g}); rows "
        f"that differ after a near-tie: {differ or 'none'}")


def rolled_sets_record(rec: dict, w16, sp, fused16, feats16) -> None:
    """Records, not gates: K1 at bf16 on ROLLED_SETS parameter sets (the
    product weights rolled by 1..ROLLED_SETS rows) against its plain
    version on the card (step-0 max |logprob gap|, step-0 tokens equal,
    share of equal tokens), beside the plain version on the CPU against
    the one on the card (step 0: the same rounding points, f32 sums in
    another order). Then, for the set with the largest step-0 gap, the
    one-step intermediates of K1 and of the CPU's plain version against
    the card's plain version, in bf16 ulps, and the first of them (in
    phase order) more than BF16_STEP0_ULPS off."""
    import torch
    from ekaid_torch.models.greedy_decode import (
        PRODUCT_WEIGHTS, SCRATCH_NAMES, greedy_decode, greedy_decode_plain)
    from ekaid_torch.utils.dtypes import BF16
    products = {n for names in PRODUCT_WEIGHTS.values() for n in names}
    sp1 = sp.replace(seq_length=1)
    cpu_in = (fused16.cpu(), feats16.cpu())
    r = rec["rolled_sets"] = {"sets": []}
    worst, worst_gap = None, -1.0
    for shift in range(1, ROLLED_SETS + 1):
        w = {k: v.roll(shift, 0).contiguous() if k in products else v
             for k, v in w16.items()}
        out = greedy_decode(w, sp, BF16, fused16, feats16)
        ref = greedy_decode_plain(w, sp, BF16, fused16, feats16)
        cpu = greedy_decode_plain({k: v.cpu() for k, v in w.items()}, sp1,
                                  BF16, *cpu_in)
        torch.cuda.synchronize()
        e = {"shift": shift,
             "step0_lp_gap": (out["logprobs"][:, 0]
                              - ref["logprobs"][:, 0]).abs().max().item(),
             "step0_tokens_equal": bool(torch.equal(out["seq"][:, 0],
                                                    ref["seq"][:, 0])),
             "token_share": (out["seq"] == ref["seq"]).float().mean().item(),
             "cpu_plain_step0_lp_gap": (cpu["logprobs"][:, 0] - ref[
                 "logprobs"][:, 0].cpu()).abs().max().item(),
             "cpu_plain_step0_tokens_equal": bool(torch.equal(
                 cpu["seq"][:, 0], ref["seq"][:, 0].cpu()))}
        r["sets"].append(e)
        if e["step0_lp_gap"] > worst_gap:
            worst, worst_gap = (shift, w), e["step0_lp_gap"]
        log(f"  record: rolled set {shift}, bf16 B={fused16.shape[0]}: K1 vs "
            f"plain step-0 gap {e['step0_lp_gap']:.3g}, step-0 tokens equal "
            f"{e['step0_tokens_equal']}, tokens equal "
            f"{e['token_share']:.4f}; CPU plain vs card plain step-0 gap "
            f"{e['cpu_plain_step0_lp_gap']:.3g}, tokens equal "
            f"{e['cpu_plain_step0_tokens_equal']}")
    shift, w = worst
    ref = greedy_decode_plain(w, sp1, BF16, fused16, feats16, scratch=True)
    out = greedy_decode(w, sp1, BF16, fused16, feats16, scratch=True)
    cpu = greedy_decode_plain({k: v.cpu() for k, v in w.items()}, sp1, BF16,
                              *cpu_in, scratch=True)
    torch.cuda.synchronize()
    trace = {"shift": shift}
    for who, got in (("kernel", out), ("cpu_plain", cpu)):
        ulps = {k: bf16_gap_ulps(ref[k].cpu(), got[k].cpu())
                for k in SCRATCH_NAMES}
        first = next((k for k in SCRATCH_NAMES
                      if ulps[k]["max_ulps"] > BF16_STEP0_ULPS), None)
        trace[who] = {"ulps": ulps, "first_over": first}
        log(f"  record: rolled set {shift} (largest step-0 gap), one step, "
            f"{who} vs the card's plain version, max bf16 ulps (bit-equal "
            f"share): " + ", ".join(
                f"{k} {v['max_ulps']:.3g} ({v['equal_share']:.4f})"
                for k, v in ulps.items())
            + f"; first over {BF16_STEP0_ULPS} ulps: {first}")
    r["worst"] = trace


def summed_norm_record(rec: dict, cfg, batch) -> None:
    """Phase 3's K1 comparisons on the inputs that two other draws of
    the weight norm give: g at init from `layers.frobenius` (the
    forward's sqrt(sum(v * v))) in place of `torch.linalg.norm` on the
    CPU; and init and forward both from the sum in f64. For each, gated:
    the f32 B=64 decodes, plain and with the decoding constraint,
    against the plain version under the near-tie rule (the rows that
    differ recorded with their first near-tie); recorded: the bf16
    step-0 logprob gap and step-0 tokens at B=64 and BF16_GROUPS_B."""
    import torch
    from ekaid_torch.data.synthetic import synthetic_batch
    from ekaid_torch.models import layers
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.models.greedy_decode import (greedy_decode,
                                                  greedy_decode_plain)
    from ekaid_torch.utils.dtypes import BF16, F32
    sp = cfg.speaker
    ntoken = sp.vocab_size - 1
    b80 = synthetic_batch(cfg, BF16_GROUPS_B, seed=SEED + 2)
    real = layers.frobenius, torch.linalg.norm
    variants = {   # (the norm at init, the forward's)
        "init_sum": (lambda x, *a, **k: real[0](x), real[0]),
        "sum_f64": ((lambda x, *a, **k: torch.sqrt(torch.sum(torch.square(
            x.double()))).float()),) * 2}
    r = rec["summed_norm"] = {}
    grad = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    try:
        for name, (init_norm, norm) in variants.items():
            layers.frobenius = norm
            e = r[name] = {}
            for pol in (F32, BF16):
                torch.linalg.norm = init_norm
                m = EkaidModel(cfg, ntoken, policy=pol, device="cuda",
                               seed=SEED)
                torch.linalg.norm = real[1]
                w = m.speaker.decode_weights()
                for b in ((batch, b80) if pol is BF16 else (batch,)):
                    enc = m.encode(b)
                    f, x = m.speaker._fused(enc["feat_bef"],
                                            enc["feat_diff"],
                                            enc["feat_aft"])
                    B = f.shape[0]
                    if pol is BF16:
                        ref = greedy_decode_plain(w, sp, BF16, f, x)
                        out = greedy_decode(w, sp, BF16, f, x)
                        e[f"bf16_B{B}"] = {
                            "step0_lp_gap": (ref["logprobs"][:, 0] - out[
                                "logprobs"][:, 0]).abs().max().item(),
                            "step0_tokens_equal": bool(torch.equal(
                                ref["seq"][:, 0], out["seq"][:, 0]))}
                        continue
                    for what, s in (("plain", sp), ("constraint", sp.replace(
                            decoding_constraint=1))):
                        ref = greedy_decode_plain(w, s, F32, f, x)
                        out = greedy_decode(w, s, F32, f, x)
                        e[f"f32_B{B}_{what}"] = {
                            "tokens_differ": int((ref["seq"] != out["seq"])
                                                 .sum()),
                            **near_tie_agree(
                                w, s, F32, f, x, ref, out,
                                rec["near_tie_tol"],
                                f"weight norm by {name}, f32 {what}")}
            log(f"  record: weight norm by {name}: " + "; ".join(
                f"{k} {v}" for k, v in e.items()))
    finally:
        layers.frobenius, torch.linalg.norm = real
        torch.set_grad_enabled(grad)
    torch.cuda.synchronize()


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
    rec["near_tie_tol"] = max(rec["f32_max_abs_err"], NEAR_TIE_FLOOR)
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
    rolled_sets_f32(rec, w32, sp, fused, feats)
    rolled_sets_record(rec, w16, sp, fused16, feats16)
    summed_norm_record(rec, cfg, batch)
    return m16, batch, fused16, feats16, w16, out16


def _grad_gaps(got: dict, want: dict) -> dict:
    """Each tensor's largest gap, over the larger of its own largest
    magnitude and GRAD_FLOOR of the largest magnitude of all (tensors
    whose gradient is zero in exact arithmetic hold rounding noise)."""
    top = max(float(w.abs().max()) for w in want.values())
    return {n: float((got[n].float().cpu() - w.float()).abs().max())
            / max(float(w.abs().max()), GRAD_FLOOR * top)
            for n, w in want.items()}


def _f64_grads(cfg, batch, ntoken: int, device: str) -> dict:
    """The gradients of the train step's loss with every f32 cast of the
    model promoted to f64 (`Tensor.float` patched for the call): the step
    in near-exact arithmetic, for the record."""
    import numpy as np
    import torch
    from ekaid_torch.models.ekaid import EkaidModel, total_loss
    from ekaid_torch.utils.dtypes import Policy
    f64 = Policy(param_dtype=torch.float32, compute_dtype=torch.float64,
                 softmax_dtype=torch.float64)
    model = EkaidModel(cfg, ntoken, policy=f64, device=device,
                       seed=SEED).double()
    b = {k: torch.as_tensor(v, device=device).double()
         if np.asarray(v).dtype == np.float32 else v
         for k, v in batch.items()}
    real = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        out = model(b)
        loss, _ = total_loss(out, model.tensors(b, train=True),
                             cfg.train.att_reg_weight)
        loss.backward()
    finally:
        torch.Tensor.float = real
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()
            if p.grad is not None}


def train_card_vs_cpu(rec: dict, cfg, device: str = "cuda") -> None:
    """10a. One f32 train step (dropout off, ss_prob 0, the config's
    Adam) at the config's widths and B=TRAIN_B, on the card and on the
    CPU, from the same seeded weights and batch, and the same step's
    gradients with every f32 cast promoted to f64 (on the card). Gates:
    the loss, card against CPU, within TRAIN_LOSS_RTOL; each gradient
    tensor of the card no further from the f64 step than
    TRAIN_GRAD_RATIO x the CPU's distance + TRAIN_GRAD_TOL (distances
    over the larger of the tensor's largest magnitude and GRAD_FLOOR of
    the largest of all; the card-CPU gap is recorded); and the Adam
    updates of the elements whose gradient stands above the card-CPU
    gradient gap (|g| over UPDATE_SIGNAL x the tensor's largest gap, and
    over 1e3 x Adam's eps) within UPDATE_TOL lr + 2 ulps of the CPU's,
    on at least UPDATE_MIN_SHARE of all elements. Adam's first step
    moves each element by about sign(g) lr, so elements whose gradient
    is at noise size may step either way and are not held."""
    import torch
    from ekaid_torch.data.synthetic import synthetic_batch
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.train.step import init_state, train_step
    from ekaid_torch.utils.dtypes import F32
    c32 = cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype="float32"))
    batch = synthetic_batch(c32, TRAIN_B, seed=SEED + 3)
    ntoken = c32.speaker.vocab_size - 1
    lr = c32.train.optim.lr
    runs = {}
    for dev in ("cpu", device):
        model = EkaidModel(c32, ntoken, policy=F32, device=dev, seed=SEED)
        before = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
        state = init_state(model, c32.train.optim)
        t0 = time.perf_counter()
        m = train_step(state, batch, SEED, c32.train.att_reg_weight,
                       train=False)
        loss = float(m["total_loss"])
        runs[dev] = (loss, {n: p.grad.detach().cpu() for n, p in
                            model.named_parameters() if p.grad is not None},
                     before, {n: p.detach().cpu() for n, p in
                              model.named_parameters()},
                     time.perf_counter() - t0)
    l_c, g_c, p0, p_c, s_c = runs["cpu"]
    l_g, g_g, _, p_g, s_g = runs[device]
    rel = abs(l_g - l_c) / abs(l_c)
    ggap = _grad_gaps(g_g, g_c)
    g64 = _f64_grads(cfg, batch, ntoken, device)
    card64, cpu64 = _grad_gaps(g_g, g64), _grad_gaps(g_c, g64)
    over = {n: (card64[n], cpu64[n]) for n in g64
            if not card64[n] <= TRAIN_GRAD_RATIO * cpu64[n] + TRAIN_GRAD_TOL}
    # the updates of elements whose gradient stands above the gap
    checked = total = 0
    worst_u = 0.0
    for n, p in p0.items():
        total += p.numel()
        if n not in g_c:
            continue
        g = g_c[n]
        strong = (g.abs() > UPDATE_SIGNAL * float((g_g[n] - g).abs().max())
                  ) & (g.abs() > 1e3 * c32.train.optim.epsilon)
        ulp = torch.nextafter(p_c[n].abs(), torch.full_like(p, math.inf)
                              ) - p_c[n].abs()
        err = ((p_g[n] - p_c[n]).abs() - 2 * ulp)[strong] / lr
        checked += int(strong.sum())
        if err.numel():
            worst_u = max(worst_u, float(err.max()))
    moved = torch.cat([((p_g[n] - p_c[n]).abs() > 0.01 * lr).flatten()
                       for n in p_c])
    r = rec["train_f32"] = {
        "loss_card": l_g, "loss_cpu": l_c, "loss_rel_err": rel,
        "grad_gap_card_cpu": max(ggap.values()),
        "grad_gap_card_cpu_worst": max(ggap, key=ggap.get),
        "grad_gap_card_cpu_over_1e-4": sum(v > 1e-4 for v in ggap.values()),
        "grad_gap_to_f64": {"card": max(card64.values()),
                            "cpu": max(cpu64.values())},
        "grad_gap_to_f64_worst": max(card64, key=card64.get),
        "grad_gap_to_f64_excess": [
            (n, card64[n], cpu64[n]) for n in sorted(
                g64, key=lambda n: cpu64[n] - card64[n])[:3]],
        "grad_gap_to_f64_margin": min(
            TRAIN_GRAD_RATIO * cpu64[n] + TRAIN_GRAD_TOL - card64[n]
            for n in g64),
        "update_checked_share": checked / total,
        "update_checked_max_gap_lr": worst_u,
        "update_split_share": float(moved.float().mean()),
        "step_s_card": s_g, "step_s_cpu": s_c}
    log(f"[10a] f32 train step B={TRAIN_B}, card vs CPU: loss {l_g:.7f} vs "
        f"{l_c:.7f} (rel {rel:.2e}); gradients to the step in f64: card "
        f"{r['grad_gap_to_f64']['card']:.2e}, CPU "
        f"{r['grad_gap_to_f64']['cpu']:.2e} "
        f"({r['grad_gap_to_f64_worst']}), least margin to the gate "
        f"{r['grad_gap_to_f64_margin']:.2e}, largest excess over the CPU "
        + ", ".join(f"{n} {a:.2e} vs {b:.2e}"
                    for n, a, b in r["grad_gap_to_f64_excess"])
        + f"; card to CPU "
        f"{r['grad_gap_card_cpu']:.2e} ({r['grad_gap_card_cpu_worst']}; "
        f"{r['grad_gap_card_cpu_over_1e-4']} of {len(ggap)} tensors over "
        f"1e-4); updates above the gap: {r['update_checked_share']:.4f} of "
        f"the elements, largest gap {worst_u:.2e} lr past 2 ulps; elements "
        f"apart by over 0.01 lr {r['update_split_share']:.2e}")
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train step loss: card {l_g} vs CPU {l_c}")
    if over:
        raise AssertionError(f"card gradients further from the f64 step "
                             f"than {TRAIN_GRAD_RATIO}x the CPU's + "
                             f"{TRAIN_GRAD_TOL}: {over}")
    if not (worst_u <= UPDATE_TOL and checked / total >= UPDATE_MIN_SHARE):
        raise AssertionError(f"updates above the gradient gap differ: "
                             f"largest {worst_u} lr past 2 ulps, on "
                             f"{checked / total} of the elements")


def train_phase(rec: dict, cfg, device: str = "cuda") -> int:
    """Phase 10, the training path at the config's widths: the card
    against the CPU (10a), then the trainer on the learnable corpus
    (10b), a resume (10c) and times (10d). Returns K1's launches on the
    trainer's path."""
    import shutil
    import numpy as np
    import torch
    from ekaid_torch.models import greedy_decode as gd
    from ekaid_torch.train.step import train_step
    from ekaid_torch.train.train import build_synthetic_trainer
    from ekaid_torch.utils.checkpoint import CheckpointManager
    train_card_vs_cpu(rec, cfg, device)
    sync = (torch.cuda.synchronize if device == "cuda" else (lambda: None))

    # ---- 10b. the trainer ------------------------------------------------
    work = ROOT / "build" / "train_phase"
    shutil.rmtree(work, ignore_errors=True)
    tcfg = cfg.replace(train=cfg.train.replace(
        max_iter=TRAIN_STEPS, snapshot_interval=TRAIN_STEPS // 2,
        log_interval=1))
    tr = build_synthetic_trainer(tcfg, str(work / "a"), corpus="learnable",
                                 device=device)
    model, sp = tr.model, tr.model.speaker
    decode = model.decode
    evals = []                # per eval: each batch's decoded seq
    seen = {}

    def checked_decode(batch):
        """The trainer's decode, held at once against the plain version
        on the same encoded inputs, with decode weights built fresh from
        the current parameters."""
        out = decode(batch)
        with torch.no_grad():
            w = gd.decode_weights(sp, sp.cfg, model.policy)
            enc = model.encode(batch)
            fused, feats = sp._fused(enc["feat_bef"], enc["feat_diff"],
                                     enc["feat_aft"])
            ref = gd.greedy_decode_plain(w, sp.cfg, model.policy, fused,
                                         feats)
        if not torch.equal(out["seq"][:, 0], ref["seq"][:, 0]):
            raise AssertionError(f"eval {len(evals)}: K1's step-0 tokens "
                                 "differ from the plain decode on fresh "
                                 "weights")
        seen["fused"], seen["feats"], seen["w"] = fused, feats, w
        evals[-1].append(out["seq"].clone())
        return out

    model.decode = checked_decode
    real_eval = tr.evaluate
    weights_at_eval = []

    def counted_evaluate(*a, **k):
        evals.append([])
        weights_at_eval.append(sp.decode_weights()["wlogit"].clone())
        return real_eval(*a, **k)

    tr.evaluate = counted_evaluate
    tr.step_seconds = []
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gd.greedy_decode.launches = 0
    tr.train(eval_fraction=EVAL_BATCHES)
    launches = gd.greedy_decode.launches
    decodes = sum(len(e) for e in evals)
    rows = [json.loads(line) for line in
            (work / "a" / "metrics.jsonl").read_text().splitlines()]
    losses = [(r["train/total_loss"], r["train/grad_norm"]) for r in rows
              if "train/total_loss" in r]
    log(f"[10b] trainer, learnable corpus, B={tr.train_ds.batch_size}: "
        f"{tr.state.step} steps, losses "
        f"{[round(x[0], 4) for x in losses]}, {len(evals)} evals of "
        f"{[len(e) for e in evals]} batches, K1 launches {launches} for "
        f"{decodes} decodes")
    if len(losses) != TRAIN_STEPS or not all(
            np.isfinite(x).all() for x in map(np.asarray, losses)):
        raise AssertionError(f"trainer: logged losses {losses}")
    if len(evals) != 2 or any(len(e) != EVAL_BATCHES for e in evals):
        raise AssertionError(f"trainer: evals {[len(e) for e in evals]}")
    if launches != decodes:
        raise AssertionError(f"K1 launched {launches} times for {decodes} "
                             "eval decodes")
    if torch.equal(weights_at_eval[0], weights_at_eval[1]):
        raise AssertionError("the two evals decoded with the same weights")
    # the cached eval against the wire eval, token for token
    n0 = len(evals)
    tr.evaluate(max_batches=EVAL_BATCHES, use_cache=True)
    tr.evaluate(max_batches=EVAL_BATCHES, use_cache=False)
    for i, (a, b) in enumerate(zip(evals[n0], evals[n0 + 1])):
        if not torch.equal(a, b):
            raise AssertionError(f"eval batch {i}: cached and wire evals "
                                 "decode different tokens")
    launches = gd.greedy_decode.launches
    decodes = sum(len(e) for e in evals)
    if launches != decodes:
        raise AssertionError(f"K1 launched {launches} times for {decodes} "
                             "eval decodes")
    rec["train_launches"] = launches
    rec["train_peak_mb"] = (torch.cuda.max_memory_allocated() / 2**20
                            if device == "cuda" else None)
    rec["train_losses"] = losses
    log(f"     cached and wire evals equal over {EVAL_BATCHES} batches; "
        f"K1 launches {launches} = decodes {decodes}; every eval batch's "
        "step-0 tokens equal the plain decode's on fresh weights")

    # ---- 10c. resume -------------------------------------------------------
    rcfg = tcfg.replace(train=tcfg.train.replace(snapshot_interval=10 ** 6))
    tb = build_synthetic_trainer(rcfg, str(work / "b"), corpus="learnable",
                                 device=device)
    CheckpointManager(str(work / "a" / "snapshots")).restore(
        tb.state, name=TRAIN_STEPS // 2)
    tb.train()
    gap = _grad_gaps({n: p.detach() for n, p in tb.model.named_parameters()},
                     {n: p.detach().cpu() for n, p in
                      tr.model.named_parameters()})
    rec["resume_param_max_gap"] = max(gap.values())
    log(f"[10c] resumed at step {TRAIN_STEPS // 2} to {tb.state.step}: "
        f"largest parameter gap to the uninterrupted run "
        f"{rec['resume_param_max_gap']:.3e} (recorded)")
    del tb

    # ---- 10d. times ---------------------------------------------------
    steps = tr.step_seconds[2:TRAIN_STEPS]
    rec["train_step_ms"] = statistics.median(steps) * 1e3
    rec["train_step_ms_all"] = [x * 1e3 for x in tr.step_seconds]
    B = tr.train_ds.batch_size
    rec["train_pairs_per_s"] = B / statistics.median(steps)
    from ekaid_torch.data.pipeline import Loader
    from ekaid_torch.models.ekaid import total_loss
    from ekaid_torch.train.train import to_device
    batch = to_device(next(iter(Loader(tr.train_ds, shuffle=False))),
                      tr.device)
    st = tr.state
    split = {}
    for _ in range(2):                 # the first warms up
        model.zero_grad(set_to_none=True)
        sync()
        t0 = time.perf_counter()
        out = model(batch)
        loss, _ = total_loss(out, model.tensors(batch, train=True),
                             tcfg.train.att_reg_weight)
        sync()
        t1 = time.perf_counter()
        loss.backward()
        sync()
        t2 = time.perf_counter()
        st.opt.step([p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in st.opt.params])
        sync()
        t3 = time.perf_counter()
        split = {"forward_ms": (t1 - t0) * 1e3,
                 "backward_ms": (t2 - t1) * 1e3,
                 "optimizer_ms": (t3 - t2) * 1e3}
    rec["train_split"] = split
    # where the step's time goes: the card's busy share of one step
    prof = rec["train_profile"] = device_busy(lambda: train_step(
        st, batch, tcfg.train.seed, tcfg.train.att_reg_weight)) \
        if device == "cuda" else None
    # memory across evals on changing weights: flat once the packed
    # weight cache (its last 4 sets) is full
    mem = []
    for _ in range(6):
        train_step(st, batch, tcfg.train.seed, tcfg.train.att_reg_weight)
        real_eval(max_batches=1)
        sync()
        mem.append(torch.cuda.memory_allocated() / 2**20
                   if device == "cuda" else 0.0)
    rec["eval_memory_mb"] = mem
    if max(mem[4:]) > mem[3] * 1.01 + 1:
        raise AssertionError(f"device memory grows over evals: {mem}")
    model.decode = decode
    real_eval(max_batches=EVAL_BATCHES)            # warm
    sync()
    t0 = time.perf_counter()
    real_eval(max_batches=EVAL_BATCHES)
    sync()
    rec["eval_pairs_per_s"] = EVAL_BATCHES * B / (time.perf_counter() - t0)
    w, f, x = seen["w"], seen["fused"], seen["feats"]
    rec["train_eval_k1_ms"] = (cuda_ms(lambda: gd.greedy_decode(
        w, sp.cfg, model.policy, f, x), 10) if device == "cuda" else None)
    log(f"[10d] on {rec.get('card', device)}: train step "
        f"{rec['train_step_ms']:.1f} ms (median of steps 3-{TRAIN_STEPS}, "
        f"all {['%.1f' % t for t in rec['train_step_ms_all']]}), "
        f"{rec['train_pairs_per_s']:.1f} QA pairs trained/s; forward "
        f"{split['forward_ms']:.1f} / backward {split['backward_ms']:.1f} / "
        f"optimizer {split['optimizer_ms']:.1f} ms; peak memory "
        f"{rec['train_peak_mb']} MiB; eval {rec['eval_pairs_per_s']:.1f} "
        f"pairs/s; K1 {rec['train_eval_k1_ms']} ms per eval decode; "
        f"memory over evals {['%.0f' % m for m in mem]} MiB")
    if prof:
        log(f"     one train step under the profiler: {prof['wall_ms']:.1f} "
            f"ms host wall, the card busy {prof['busy_ms']:.1f} ms "
            f"({prof['busy_share']:.3f}), {prof['launches']:.0f} device "
            "activities; top by device time: " + "; ".join(
                f"{k['name']} {k['ms']:.2f} ms x{k['launches']:.0f}"
                for k in prof["top"]))
    return rec["train_launches"]


def beam_cut_margins(model, batch, beam_size: int) -> list:
    """`decode_beam` of `model` with every ranking of candidates traced:
    per step and group, each row's margin between the last candidate kept
    and the first dropped (the beam search's near-ties). Returns
    (the decode, the margins [steps, B])."""
    import torch
    real, margins = torch.sort, []

    def traced(x, *a, **k):
        out = real(x, *a, **k)
        margins.append((out.values[:, beam_size - 1]
                        - out.values[:, beam_size]).double().cpu())
        return out

    torch.sort = traced
    try:
        out = model.decode_beam(batch, beam_size=beam_size)
    finally:
        torch.sort = real
    return out, torch.stack(margins)


class RecordSink(MemorySink):
    """H5Writer's interface for the extraction runner, in memory (the
    card's machine has no h5py)."""

    made = []

    def __init__(self, path, num_nodes, feat_dim, adj_pad=100,
                 feat_dtype="float32", mode="w", run_meta=None):
        super().__init__()
        self.n, self.run_meta = 0, run_meta
        RecordSink.made.append(self)


def http(base: str, path: str, payload=None, timeout: float = 60.0):
    """(status, JSON body) of a request; an HTTP error raises."""
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data,
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
        return r.status, (json.loads(body) if "json" in r.headers.get(
            "Content-Type", "") else body)


def plain_step0(model, batch):
    """Step-0 tokens of the plain decode of `batch` on weights built
    fresh from the model's parameters."""
    import torch
    from ekaid_torch.models import greedy_decode as gd
    sp = model.speaker
    with torch.no_grad():
        w = gd.decode_weights(sp, sp.cfg, model.policy)
        enc = model.encode(batch)
        fused, feats = sp._fused(enc["feat_bef"], enc["feat_diff"],
                                 enc["feat_aft"])
        return gd.greedy_decode_plain(w, sp.cfg, model.policy, fused,
                                      feats)["seq"][:, 0]


def inference_phase(rec: dict, cfg, device: str = "cuda",
                    keep: dict = None) -> tuple:
    """Phase 11, the inference entry points on phase 10's snapshots:
    (a) the eval driver and score analysis, (b) beam search, (c) the
    coalescing HTTP server and the batch-1 engine, (d) the extraction
    runner on detector weights read from files. Returns the launches of
    K1 and of K2 on these paths; `keep` receives 11a's ground truth and
    answers (phase 14e)."""
    import contextlib
    import io
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from ekaid_torch.extract import runner
    from ekaid_torch.extract.pipeline import Extractor
    from ekaid_torch.models import greedy_decode as gd
    from ekaid_torch.models.detector import FasterRCNN
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.models.layers import init_params
    from ekaid_torch.ops import roi_kernels as rk
    from ekaid_torch.serving.engine import InferenceEngine
    from ekaid_torch.serving.server import (CoalescingEngine, Server,
                                            make_handler)
    from ekaid_torch.train import score, test as eval_driver
    from ekaid_torch.train.train import build_synthetic_trainer
    from ekaid_torch.utils.dtypes import F32
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    work = ROOT / "build" / "train_phase"
    snaps = work / "a" / "snapshots"
    tcfg = cfg.replace(train=cfg.train.replace(
        max_iter=TRAIN_STEPS, snapshot_interval=TRAIN_STEPS // 2))
    r = rec["inference"] = {}
    k1 = 0

    # ---- 11a. the eval driver -------------------------------------------
    bs = tcfg.data.test.batch_size
    # the learnable corpus holds n_pairs x 8 pairs, a tenth of them in
    # its test split: EVAL_B full batches
    tr = build_synthetic_trainer(tcfg, str(work / "c"),
                                 n_pairs=EVAL_B * bs * 10 // 8,
                                 corpus="learnable", device=device)
    model = tr.model
    decode, batches = model.decode, []

    def checked_decode(batch):
        out = decode(batch)
        if not torch.equal(out["seq"][:, 0], plain_step0(model, batch)):
            raise AssertionError(f"eval driver batch {len(batches)}: K1's "
                                 "step-0 tokens differ from the plain "
                                 "decode's")
        batches.append(out["seq"].shape[0])
        return out

    model.decode = checked_decode
    results = work / "c" / "results.json"
    gd.greedy_decode.launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        scores, preds = eval_driver.run_test(
            tr, str(snaps), TRAIN_STEPS, str(results), max_batches=EVAL_B)
    launches = gd.greedy_decode.launches
    model.decode = decode
    took = next(line for line in printed.getvalue().splitlines()
                if line.startswith("Test took"))
    if tr.state.step != TRAIN_STEPS or batches != [bs] * EVAL_B:
        raise AssertionError(f"eval driver: step {tr.state.step}, batches "
                             f"{batches}")
    if launches != len(batches):
        raise AssertionError(f"eval driver: K1 launched {launches} times "
                             f"for {len(batches)} batches")
    k1 += launches
    # timed again without the checks, the image cache warm
    gd.greedy_decode.launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _, again = eval_driver.run_test(tr, max_batches=EVAL_B)
    if again != preds or gd.greedy_decode.launches != EVAL_B:
        raise AssertionError("eval driver: a second run differs")
    k1 += EVAL_B
    took_warm = next(line for line in printed.getvalue().splitlines()
                     if line.startswith("Test took"))
    gt = work / "c" / "gt.json"
    gt.write_text(json.dumps(tr._gt_annotations(preds)))
    if keep is not None:
        keep["captions"] = (tr._gt_annotations(preds), dict(preds))
    with contextlib.redirect_stdout(io.StringIO()):
        acc = score.main(["-d", str(results), "-g", str(gt), "-a"])
        caption = score.main(["-d", str(results), "-g", str(gt)])
    if list(acc) != [scores["acc_total"], scores["acc_open"],
                     scores["acc_closed"]] or any(
            abs(caption[k] - scores[k]) > 1e-9 for k in caption):
        raise AssertionError(f"score.main {acc} {caption} against the eval "
                             f"driver's {scores}")
    gd.greedy_decode.launches = 0
    cli = io.StringIO()
    with contextlib.redirect_stdout(cli):
        # the synthetic test split's 52 pairs in 2 batches of 32
        eval_driver.main(["--synthetic", "--max_batches", "2",
                          "--batch_size", "32", "--workdir",
                          str(work / "d"), "--device", device])
    cli_took = next(line for line in cli.getvalue().splitlines()
                    if line.startswith("Test took"))
    if gd.greedy_decode.launches != 2:
        raise AssertionError(f"eval driver CLI: K1 launched "
                             f"{gd.greedy_decode.launches} times for 2 "
                             "batches")
    k1 += 2
    r["eval"] = {"line": took, "pairs": len(preds),
                 "pairs_per_s_checked": float(took.split("(")[1].split()[2]),
                 "line_warm": took_warm,
                 "pairs_per_s": float(took_warm.split("(")[1].split()[2]),
                 "scores": scores, "cli_line": cli_took}
    log(f"[11a] eval driver on the step-{TRAIN_STEPS} snapshot, {EVAL_B} "
        f"batches of {bs} (learnable eval split), each batch checked: "
        f"{took}; again, unchecked: {took_warm}; Bleu_1 "
        f"{scores['Bleu_1']:.4f}, acc_total {scores['acc_total']:.4f}; "
        f"K1 launches {launches} = batches, each batch's step-0 tokens "
        f"equal the plain decode's; score.main -a and the caption metrics "
        f"equal the driver's; CLI --synthetic --max_batches 2 --batch_size "
        f"32: {cli_took}")

    # ---- 11b. beam search -----------------------------------------------
    gd.greedy_decode.launches = 0
    tr.evaluate(beam_size=BEAM, max_batches=1)          # warm
    sync()
    t0 = time.perf_counter()
    b_scores, b_preds = tr.evaluate(beam_size=BEAM, max_batches=1)
    sync()
    beam_ms = (time.perf_counter() - t0) * 1e3
    if gd.greedy_decode.launches:
        raise AssertionError("beam search launched K1")
    sd = torch.load(snaps / f"{TRAIN_STEPS}.pt", map_location="cpu",
                    weights_only=True)["params"]
    pair_idx = tr.eval_ds.split_idxs[:BEAM_PAIRS]
    host = {k: v for k, v in tr.eval_ds.sample_batch(pair_idx).items()
            if k != "pair_index"}
    outs = {}
    for dev in (device, "cpu"):
        m = EkaidModel(tr.cfg, len(tr.vocab.word_to_idx), policy=F32,
                       device=dev, seed=None)
        m.load_state_dict(sd)
        outs[dev] = beam_cut_margins(m, host, BEAM)
    (card, _), (cpu, margins) = outs[device], outs["cpu"]
    tol = rec["near_tie_tol"]
    differ = [int(i) for i in (card["group_seqs"].cpu() != cpu["group_seqs"])
              .flatten(1).any(1).nonzero()[:, 0]]
    near = [int(i) for i in (margins < tol).any(0).nonzero()[:, 0]]
    if not set(differ) <= set(near):
        raise AssertionError(f"beam f32 card vs CPU: rows {differ} differ, "
                             f"rows with a near-tied cut {near}")
    lp_gap = (card["logprob"].cpu() - cpu["logprob"]).abs().max().item()
    r["beam"] = {"ms_per_batch": beam_ms, "batch": bs, "beam_size": BEAM,
                 "Bleu_1": b_scores["Bleu_1"],
                 "f32_rows_differ": differ, "f32_near_tie_rows": near,
                 "f32_min_cut_margin": float(margins.min()),
                 "f32_logprob_gap": lp_gap}
    log(f"[11b] beam search, beam {BEAM}, one batch of {bs} on the card: "
        f"{beam_ms:.1f} ms (no kernel; K1 launches 0), Bleu_1 "
        f"{b_scores['Bleu_1']:.4f}; f32 {BEAM_PAIRS} pairs card vs CPU: "
        f"rows differ {differ} (near-tied cuts in rows {near}), smallest "
        f"cut margin {float(margins.min()):.3g}, logprob gap {lp_gap:.3g}")

    # ---- 11c. the server --------------------------------------------------
    gd.greedy_decode.launches = 0
    engine = CoalescingEngine(tr, coalesce_batch=16)
    warm = gd.greedy_decode.launches
    served = []
    real_execute = engine._execute

    def recorded_execute(items, work_, dev):
        """The pool thread's whole job for a batch: assembly, decode,
        fetch, futures resolved; host clock."""
        t = time.perf_counter()
        real_execute(items, work_, dev)
        served.append(([(i, None if q is None else tuple(q))
                        for i, q, _, _ in items], work_, dev,
                       (time.perf_counter() - t) * 1e3))

    engine._execute = recorded_execute
    srv = Server(("127.0.0.1", 0), make_handler(engine))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    idxs = [int(i) for i in tr.eval_ds.split_idxs]
    words = tr.vocab.idx_to_word
    reqs = []
    for n in range(SERVE_REQUESTS):
        idx = idxs[n % len(idxs)]
        q = tr.vocab.decode(tr.eval_ds.questions[idx]).split()
        q = " ".join(q[:1 + n % 4] + [words[5 + n % 97]])
        reqs.append({"question": q, "index": idx, "detail": n % 5 == 0})

    def ask(req):
        t = time.perf_counter()
        status, body = http(base, "/question", req)
        return status, body, (time.perf_counter() - t) * 1e3

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=SERVE_CLIENTS) as ex:
        replies = list(ex.map(ask, reqs))
    wall = time.perf_counter() - t0
    launches = gd.greedy_decode.launches - warm
    stats = dict(engine.stats)
    status = {p: http(base, p)[0] for p in ("/health", "/sample", "/")}
    status["/refresh"] = http(base, "/refresh", {})[0]
    if any(s != 200 for s, _, _ in replies) or any(
            v != 200 for v in status.values()):
        raise AssertionError(f"server: statuses {status}")
    if stats["requests"] != SERVE_REQUESTS or launches != stats["batches"]:
        raise AssertionError(f"server: stats {stats}, K1 launches "
                             f"{launches} after the warm-up's {warm}")
    # each reply against its own row of its batch, decoded again
    want = {}
    for items, (rows, questions), dev, _ in served:
        batch = {k: torch.cat([x[k] for x in rows]) for k in rows[0]}
        batch["question"] = torch.as_tensor(questions, device=dev)
        again = model.decode(batch)["seq"]
        if not torch.equal(again[:, 0], plain_step0(model, batch)):
            raise AssertionError("a served batch's step-0 tokens differ "
                                 "from the plain decode's")
        for k, key in enumerate(items):
            want[key] = tr.vocab.decode(again[k].cpu().numpy())
    b1_equal = 0
    for req, (_, body, _) in zip(reqs, replies):
        key = (req["index"], tuple(engine.question_to_ids(req["question"])))
        if body["answer"] != want[key] or body["index"] != req["index"]:
            raise AssertionError(f"request {req}: answer {body['answer']!r}"
                                 f", its batch row decodes {want[key]!r}")
        if req["detail"] and len(body["tokens"]) != len(
                body["module_weights"]):
            raise AssertionError(f"request {req}: detail {body}")
        b1 = InferenceEngine.answer(engine, req["question"], req["index"])
        b1_equal += b1["answer"] == body["answer"]
    srv.shutdown()
    srv.server_close()
    if not engine.drain(timeout_s=30):
        raise AssertionError("server: drain timed out")
    lat = sorted(x for _, _, x in replies)
    k1 += warm + launches
    # the plain batch-1 engine, one request at a time
    gd.greedy_decode.launches = 0
    plain = InferenceEngine(tr)
    srv = Server(("127.0.0.1", 0), make_handler(plain))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    plain_lat = [ask(req)[2] for req in reqs[:PLAIN_REQUESTS]]
    srv.shutdown()
    srv.server_close()
    if gd.greedy_decode.launches != PLAIN_REQUESTS + 1:
        raise AssertionError(f"plain engine: K1 launched "
                             f"{gd.greedy_decode.launches} times for "
                             f"{PLAIN_REQUESTS} requests and the warm-up")
    k1 += gd.greedy_decode.launches
    r["server"] = {
        "requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS,
        "requests_per_s": SERVE_REQUESTS / wall,
        "latency_ms_p50": lat[len(lat) // 2],
        "latency_ms_p99": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "batches": stats["batches"], "coalesced": stats["coalesced"],
        "max_batch": stats["max_batch"], "warmup_launches": warm,
        "batch_ms_p50": statistics.median(x[3] for x in served),
        "batch_ms_sum_over_wall": sum(x[3] for x in served) / (wall * 1e3),
        "batch_sizes": sorted(len(x[0]) for x in served),
        "coalesced_equal_batch1_share": b1_equal / SERVE_REQUESTS,
        "plain_b1_latency_ms_p50": statistics.median(plain_lat)}
    s_ = r["server"]
    log(f"[11c] server, CoalescingEngine(16) over HTTP, {SERVE_CLIENTS} "
        f"clients, {SERVE_REQUESTS} requests: {s_['requests_per_s']:.1f} "
        f"requests/s, latency p50 {s_['latency_ms_p50']:.1f} ms, p99 "
        f"{s_['latency_ms_p99']:.1f} ms; {s_['batches']} batches "
        f"({s_['coalesced']} coalesced, largest {s_['max_batch']}; sizes "
        f"{s_['batch_sizes']}; a batch's execution {s_['batch_ms_p50']:.1f} "
        f"ms p50, executions summed {s_['batch_ms_sum_over_wall']:.3f} of "
        f"the wall), K1 "
        f"launches {launches} = batches (+{warm} warm-up); every reply is "
        f"its own batch row's decode, each batch's step-0 tokens equal the "
        f"plain decode's; coalesced answers equal to batch-1 answers "
        f"{s_['coalesced_equal_batch1_share']:.4f} (recorded); "
        f"/health /sample / /refresh 200; drained. Plain batch-1 engine, "
        f"{PLAIN_REQUESTS} requests one at a time: p50 "
        f"{s_['plain_b1_latency_ms_p50']:.1f} ms")

    # ---- 11d. the extraction runner on imported detector weights --------
    det = cfg.detector
    gen = torch.Generator().manual_seed(SEED)
    paths = []
    for name, k in (("ana", det.num_anatomy_classes),
                    ("dis", det.num_disease_classes)):
        m = FasterRCNN(det, num_classes=k, norm=det.norm,
                       stride_in_1x1=det.stride_in_1x1)
        init_params(m, gen)
        paths.append(work / f"{name}.pt")
        torch.save(m.state_dict(), paths[-1])
    real_writer, RecordSink.made = runner.H5Writer, []
    runner.H5Writer = RecordSink
    rk.multilevel_roi_align_canvas.launches = 0
    try:
        runner.main(["--ana_ckpt", str(paths[0]), "--dis_ckpt",
                     str(paths[1]), "--synthetic", str(DET_IMAGES),
                     "--out", str(work / "graph.h5"), "--device", device])
    finally:
        runner.H5Writer = real_writer
    sync()
    k2 = rk.multilevel_roi_align_canvas.launches
    got = RecordSink.made[0]
    ana_apply, dis_apply = runner.build_detector_fns(
        cfg, gen=torch.Generator().manual_seed(SEED), device=device)
    sink = MemorySink()
    Extractor(ana_apply, dis_apply, det.num_disease_classes).run(
        runner.synthetic_batches(DET_IMAGES, det.image_size,
                                 det.extract_batch_size), sink)
    if k2 != 2 * DET_IMAGES // det.extract_batch_size or \
            len(got.records) != DET_IMAGES:
        raise AssertionError(f"runner: K2 launches {k2}, records "
                             f"{len(got.records)}")
    if got.run_meta["ana_ckpt"] != str(paths[0]) or \
            got.run_meta["dis_ckpt"] != str(paths[1]):
        raise AssertionError(f"runner: run_meta {got.run_meta}")
    for i, (a, b) in enumerate(zip(got.records, sink.records)):
        for key in b:
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"runner record {i}: {key} differs "
                                     "from the in-process path")
    r["runner"] = {"images": DET_IMAGES, "k2_launches": k2}
    log(f"[11d] extraction runner --ana_ckpt/--dis_ckpt (.pt state dicts "
        f"of the seeded detectors), --synthetic {DET_IMAGES}: records "
        f"bit-equal to the in-process path on the same weights and "
        f"images; K2 launches {k2}; run_meta names both checkpoints")
    return k1, k2


class KinkReplay:
    """The branch taken at every kink of the detector's loss step (each
    ReLU, the stem's max-pool, `floor` in ROIAlign's level and sample
    taps, the proposals' clip, the L1 losses' `abs`), recorded on one
    run and imposed on later runs, which count where their own branch
    differs (`flips`). Runs under one tape evaluate the same smooth
    piece of the loss, so their gradients differ by arithmetic alone:
    at f32 an element within rounding of a kink takes either branch,
    and in a ReLU network each such element moves the gradients below
    it by far more than rounding does."""

    def __init__(self):
        self.tape, self.flips, self.sites = [], 0, 0

    def run(self, record: bool):
        import contextlib
        import torch
        import torch.nn.functional as F
        from ekaid_torch.models.detector import rpn
        real = {"relu": torch.relu, "floor": torch.floor,
                "abs": torch.Tensor.abs, "pool": F.max_pool2d,
                "clip": rpn.clip_boxes}
        pos = iter(range(1 << 62))

        def take(natural):
            if record:
                self.tape.append(natural.detach().cpu())
                return natural
            want = self.tape[next(pos)].to(natural.device)
            self.flips += int((want != natural).sum())
            self.sites += 1
            return want

        def zero(x):
            return torch.zeros((), dtype=x.dtype, device=x.device)

        def relu(x):
            return torch.where(take(x > 0), x, zero(x))

        def floor(x):
            return take(real["floor"](x)).to(x.dtype)

        def abs_(x):
            return torch.where(take(x >= 0), x, -x)

        def pool(x, k, stride=None, padding=0, **kw):
            out, idx = real["pool"](x, k, stride, padding=padding,
                                    return_indices=True)
            idx = take(idx)
            return x.flatten(2).gather(2, idx.flatten(2)).view(out.shape)

        def clip(boxes, size):
            lo, hi = take(boxes < 0), take(boxes > size)
            return torch.where(lo, zero(boxes), torch.where(
                hi, torch.full((), float(size), dtype=boxes.dtype,
                               device=boxes.device), boxes))

        @contextlib.contextmanager
        def patched():
            torch.relu, torch.floor, torch.Tensor.abs = relu, floor, abs_
            F.max_pool2d, rpn.clip_boxes = pool, clip
            try:
                yield self
            finally:
                torch.relu, torch.floor = real["relu"], real["floor"]
                torch.Tensor.abs, F.max_pool2d = real["abs"], real["pool"]
                rpn.clip_boxes = real["clip"]
        return patched()


def _det_f64_grads(det, state, images, gt, choices, device: str):
    """The gradients of `FasterRCNN.losses` with every f32 cast promoted
    to f64 (`Tensor.float` patched for the call), the given choices
    replayed: the step in near-exact arithmetic."""
    import torch
    from ekaid_torch.models.detector import FasterRCNN
    from ekaid_torch.utils.dtypes import Policy
    f64 = Policy(param_dtype=torch.float64, compute_dtype=torch.float64,
                 softmax_dtype=torch.float64)
    model = FasterRCNN(det, num_classes=det.num_anatomy_classes,
                       policy=f64)
    model.load_state_dict(state)
    model.double().to(device)
    real = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        out, _ = model.losses(
            images.double().to(device), gt[0].double().to(device),
            gt[1].to(device), gt[2].to(device),
            choices={k: v.to(device) for k, v in choices.items()})
        out["total"].backward()
    finally:
        torch.Tensor.float = real
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def det_card_vs_cpu(rec: dict, cfg, device: str = "cuda") -> None:
    """12a. One f32 `FasterRCNN.losses` step at the config's widths,
    K=26, DET_F32_SIZE^2 images, batch DET_F32_B, on the card and on the
    CPU from the same seeded weights, images, gts and draws (drawn on the
    CPU, copied to the card), and in f64. The card's own choices are
    compared with the CPU's (recorded); the card and f64 steps then
    replay the CPU's choices and the branch of each of its kinks
    (`KinkReplay`; the elements where theirs would differ are recorded).
    Gates: every loss within DET_LOSS_RTOL card to CPU, and each
    gradient tensor of the card no further from f64 than
    TRAIN_GRAD_RATIO x the CPU's + TRAIN_GRAD_TOL (phase 10a's rule)."""
    import torch
    from ekaid_torch.models.detector import FasterRCNN
    from ekaid_torch.models.detector.faster_rcnn import loss_draws
    from ekaid_torch.models.layers import init_params
    from ekaid_torch.ops import roi_kernels as rk
    from ekaid_torch.train.train_detector import synthetic_blob_dataset
    from ekaid_torch.utils.dtypes import F32
    det = cfg.detector.replace(image_size=DET_F32_SIZE,
                               batch_size=DET_F32_B)
    k = det.num_anatomy_classes
    cpu = FasterRCNN(det, num_classes=k, policy=F32)
    init_params(cpu, torch.Generator().manual_seed(SEED))
    state = {n: t.clone() for n, t in cpu.state_dict().items()}
    images, boxes, classes, valid = (torch.as_tensor(a) for a in
                                     synthetic_blob_dataset(
                                         DET_F32_B, DET_F32_SIZE, k,
                                         seed=SEED + 5))
    # two gts an image on the largest proposals, moved by 6-12% of their
    # side: foreground ROIs, so the ROI box loss and its route through
    # the box targets to the RPN's deltas are exercised
    with torch.no_grad():
        props = cpu.proposals(cpu.features(images), train=True)[0]
    side = torch.minimum(props[..., 2] - props[..., 0],
                         props[..., 3] - props[..., 1])
    move = torch.empty(DET_F32_B, 2, 4).uniform_(
        0.06, 0.12, generator=torch.Generator().manual_seed(SEED + 7))
    move = move * torch.tensor([1.0, -1.0, -1.0, 1.0])
    for b in range(DET_F32_B):
        big = torch.argsort(side[b], descending=True, stable=True)[:2]
        boxes[b, :2] = props[b, big] + move[b] * side[b, big][:, None]
        valid[b, :2] = True
    gt = (boxes, classes, valid)
    draws = loss_draws(DET_F32_B, cpu.num_anchors(), det.post_nms_topk,
                       torch.Generator().manual_seed(SEED + 6))

    def step(model, dev, choices=None):
        t0 = time.perf_counter()
        out, made = model.losses(
            images.to(dev), *(g.to(dev) for g in gt),
            draws={n: d.to(dev) for n, d in draws.items()},
            choices=None if choices is None else {
                n: c.to(dev) for n, c in choices.items()})
        out["total"].backward()
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        return ({n: float(v.detach()) for n, v in out.items()},
                {n: c.cpu() for n, c in made.items()}, grads,
                time.perf_counter() - t0)

    kinks = KinkReplay()
    _, ch_c, _, _ = step(cpu, "cpu")
    cpu.zero_grad(set_to_none=True)
    with kinks.run(record=True):            # the choices' own path
        l_c, _, g_c, s_c = step(cpu, "cpu", ch_c)
    card = FasterRCNN(det, num_classes=k, policy=F32)
    card.load_state_dict(state)
    card.to(device)
    _, ch_own, _, _ = step(card, device)
    same = {n: bool(torch.equal(ch_own[n], ch_c[n])) for n in ch_c}
    card.zero_grad(set_to_none=True)
    with kinks.run(record=False):
        l_g, ch_g, g_g, s_g = step(card, device, ch_c)
    flips_card, kinks.flips = kinks.flips, 0
    if not all(torch.equal(ch_g[n], ch_c[n]) for n in ch_c):
        raise AssertionError("12a: the replayed choices came back changed")
    with kinks.run(record=False):
        g64 = _det_f64_grads(det, state, images, gt, ch_c, device)
    flips_64 = kinks.flips
    rel = {n: abs(l_g[n] - l_c[n]) / max(abs(l_c[n]), 1e-30) for n in l_c}
    card64, cpu64 = _grad_gaps(g_g, g64), _grad_gaps(g_c, g64)
    ggap = _grad_gaps(g_g, g_c)
    over = {n: (card64[n], cpu64[n]) for n in g64
            if not card64[n] <= TRAIN_GRAD_RATIO * cpu64[n] + TRAIN_GRAD_TOL}
    # K2 has no backward: with grad mode on it refuses such a pyramid
    pyr = card.features(images.to(device).float())
    try:
        rk.multilevel_roi_align_canvas(pyr[:4], boxes.to(device),
                                       (0.25, 0.125, 0.0625, 0.03125))
        refused = False
    except rk.NoGradKernelError:
        refused = True
    del pyr
    r = rec["det_train_f32"] = {
        "losses_card": l_g, "losses_cpu": l_c, "loss_rel_err": rel,
        "own_choices_equal": same,
        "grad_gap_card_cpu": max(ggap.values()),
        "grad_gap_card_cpu_worst": max(ggap, key=ggap.get),
        "grad_gap_to_f64": {"card": max(card64.values()),
                            "cpu": max(cpu64.values())},
        "grad_gap_to_f64_worst": max(card64, key=card64.get),
        "grad_gap_to_f64_margin": min(
            TRAIN_GRAD_RATIO * cpu64[n] + TRAIN_GRAD_TOL - card64[n]
            for n in g64),
        "grad_gap_to_f64_excess": [
            (n, card64[n], cpu64[n]) for n in sorted(
                g64, key=lambda n: cpu64[n] - card64[n])[:3]],
        "k2_refuses_grad": refused, "kink_sites": len(kinks.tape),
        "kink_flips": {"card": flips_card, "f64": flips_64},
        "step_s_card": s_g, "step_s_cpu": s_c}
    log(f"[12a] f32 detector loss step, {DET_F32_SIZE}^2 x {DET_F32_B}, "
        f"K={k}: the card's own choices equal the CPU's: "
        + ", ".join(f"{n} {v}" for n, v in same.items())
        + f"; kinks replayed ({len(kinks.tape)} sites; the card's own "
        f"branch differs at {flips_card} elements, f64's at {flips_64})"
        + f"; replaying the CPU's choices: total {l_g['total']:.7f} vs "
        f"{l_c['total']:.7f}, largest loss rel err {max(rel.values()):.2e} "
        f"({max(rel, key=rel.get)}); gradients to f64: card "
        f"{r['grad_gap_to_f64']['card']:.2e}, CPU "
        f"{r['grad_gap_to_f64']['cpu']:.2e} ({r['grad_gap_to_f64_worst']}), "
        f"least margin {r['grad_gap_to_f64_margin']:.2e}; card to CPU "
        f"{r['grad_gap_card_cpu']:.2e} ({r['grad_gap_card_cpu_worst']}); "
        f"K2 refuses a pyramid that requires grad: {refused}")
    if not max(rel.values()) <= DET_LOSS_RTOL:
        raise AssertionError(f"12a losses: card {l_g} vs CPU {l_c}")
    if over:
        raise AssertionError(f"12a: card gradients further from the f64 "
                             f"step than {TRAIN_GRAD_RATIO}x the CPU's + "
                             f"{TRAIN_GRAD_TOL}: {over}")
    if device == "cuda" and not refused:
        raise AssertionError("12a: K2 took an input that requires grad")


def detector_train_phase(rec: dict, cfg, device: str = "cuda") -> int:
    """Phase 12, the detector's training path: the card against the CPU
    and f64 (12a), the flagship `DetectorTrainer` (12b), its weights
    through the extraction runner (12c), the CLI (12d) and times (12e).
    Returns K2's launches on the trainer's and the runner's paths."""
    import shutil
    import numpy as np
    import torch
    from ekaid_torch.extract import runner
    from ekaid_torch.extract.pipeline import Extractor
    from ekaid_torch.models.detector.faster_rcnn import FPN_SCALES
    from ekaid_torch.ops import nms as nms_ops
    from ekaid_torch.ops import roi_kernels as rk
    from ekaid_torch.train import train_detector as td
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if device == "cuda":
        torch.cuda.empty_cache()
    det_card_vs_cpu(rec, cfg, device)

    # ---- 12b. the flagship trainer ---------------------------------------
    det = cfg.detector
    k = det.num_anatomy_classes
    work = ROOT / "build" / "det_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    arrays = td.synthetic_blob_dataset(DET_TRAIN_IMAGES, det.image_size, k,
                                       seed=SEED)
    data_s = time.perf_counter() - t0
    tr = td.DetectorTrainer(cfg, k, total_steps=DET_STEPS, device=device)
    p0 = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    logged, first_equal, nms_reads, select_ms, last_args = [], [], [], [], []
    step, generate = tr.train_step, tr.model._generate

    def timed_generate(*a, **kw):
        """The proposals' top-k and blocked NMS, timed (synchronised)."""
        sync()
        t = time.perf_counter()
        out = generate(*a, **kw)
        sync()
        select_ms[-1] += (time.perf_counter() - t) * 1e3
        return out

    def logged_step(*a, **kw):
        reads = nms_ops._survivor_mask.host_reads
        select_ms.append(0.0)
        last_args[:] = a
        out = step(*a, **kw)
        nms_reads.append(nms_ops._survivor_mask.host_reads - reads)
        logged.append({n: float(v) for n, v in out.items()})
        if len(logged) == 1:
            first_equal.append(all(torch.equal(p, p0[n]) for n, p in
                                   tr.model.named_parameters()))
        return out

    tr.train_step, tr.model._generate = logged_step, timed_generate
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.fit(arrays, DET_STEPS, log_every=DET_STEPS)
    fit_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() / 2**20
            if device == "cuda" else None)
    del p0
    tr.train_step = step
    del tr.model._generate
    val = tr.validation_loss(arrays)
    rk.multilevel_roi_align_canvas.launches = 0
    scores = tr.evaluate(arrays, proposals=True)
    sync()
    k2 = rk.multilevel_roi_align_canvas.launches
    eval_batches = DET_TRAIN_IMAGES // det.batch_size
    r = rec["det_train"] = {
        "losses": logged, "first_update_equal": first_equal[0],
        "val": val, "scores": {n: v for n, v in scores.items()
                               if not n.startswith("AP50-")},
        "k2_launches_eval": k2, "peak_mb": peak, "data_s": data_s,
        "fit_images_per_s": DET_STEPS * det.batch_size / fit_s,
        "proposal_select_ms": select_ms, "nms_host_reads": nms_reads}
    log(f"[12b] DetectorTrainer, anatomy K={k}, {cfg.dtypes.compute_dtype}, "
        f"{det.image_size}^2, batch {det.batch_size}, {DET_TRAIN_IMAGES} "
        f"images: {len(logged)} steps, totals "
        f"{[round(x['total'], 4) for x in logged]}, grad norms "
        f"{[round(x['grad_norm'], 2) for x in logged]}; proposal top-k + "
        f"blocked NMS ms a step {['%.0f' % x for x in select_ms]} with "
        f"{nms_reads} host reads; first update left "
        f"every parameter bit-equal: {first_equal[0]}; val_total "
        f"{val['val_total']:.4f}; eval {r['scores']}; K2 launches {k2} for "
        f"{eval_batches} eval batches")
    if len(logged) != DET_STEPS or not all(
            np.isfinite(list(x.values())).all() for x in logged):
        raise AssertionError(f"12b: logged losses {logged}")
    if not first_equal[0]:
        raise AssertionError("12b: the first update (lr 0) moved a "
                             "parameter")
    if not np.isfinite(list(val.values())).all():
        raise AssertionError(f"12b: validation losses {val}")
    if k2 != eval_batches:
        raise AssertionError(f"12b: K2 launched {k2} times for "
                             f"{eval_batches} eval batches")
    # one eval batch's pooled features against K2's plain version
    with torch.no_grad():
        x = torch.as_tensor(arrays[0][:det.batch_size]).to(device)
        pyr = tr.model.features(x)
        boxes, _, _ = tr.model.proposals(pyr)
        fm = [p.contiguous() for p in pyr[:4]]
        out = rk.multilevel_roi_align_canvas(fm, boxes, FPN_SCALES)
        ref = rk.multilevel_roi_align_canvas_plain(fm, boxes, FPN_SCALES)
        sync()
    o, p = out.float(), ref.float()
    gap = (o - p).abs()
    r["k2_pool_equal_share"] = (gap == 0).sum().item() / gap.numel()
    r["k2_pool_max_gap"] = gap.max().item()
    log(f"     K2 on an eval batch's pyramid ({fm[0].dtype}, rois "
        f"{tuple(boxes.shape)}) vs its plain version: equal "
        f"{r['k2_pool_equal_share']:.6f}, max gap {r['k2_pool_max_gap']:.3g}")
    if not torch.isfinite(o).all() or \
            (gap > bf16_ulp(torch.maximum(o.abs(), p.abs()))).any():
        raise AssertionError("12b: K2 on an eval batch exceeds one bf16 ulp "
                             "of its plain version")
    del pyr, fm, out, ref, o, p, gap

    # ---- 12c. the trained weights through the extraction runner ---------
    path = work / "ana.pt"
    sd = tr.state_dict()
    torch.save(sd, path)
    real_writer, RecordSink.made = runner.H5Writer, []
    runner.H5Writer = RecordSink
    rk.multilevel_roi_align_canvas.launches = 0
    try:
        runner.main(["--ana_ckpt", str(path), "--allow_random",
                     "--synthetic", str(DET_IMAGES),
                     "--out", str(work / "graph.h5"), "--device", device])
    finally:
        runner.H5Writer = real_writer
    sync()
    k2_runner = rk.multilevel_roi_align_canvas.launches
    got = RecordSink.made[0]
    ana_apply, dis_apply = runner.build_detector_fns(
        cfg, ana_params=sd, gen=torch.Generator().manual_seed(0),
        device=device)
    sink = MemorySink()
    Extractor(ana_apply, dis_apply, det.num_disease_classes).run(
        runner.synthetic_batches(DET_IMAGES, det.image_size,
                                 det.extract_batch_size), sink)
    want_k2 = 2 * DET_IMAGES // det.extract_batch_size
    if k2_runner != want_k2 or len(got.records) != DET_IMAGES:
        raise AssertionError(f"12c runner: K2 launches {k2_runner}, "
                             f"records {len(got.records)}")
    for i, (a, b) in enumerate(zip(got.records, sink.records)):
        for key in b:
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"12c runner record {i}: {key} differs "
                                     "from the in-process path")
    found = check_records(got.records, det, "trained")
    r["runner"] = {"k2_launches": k2_runner, "anatomy_found": found}
    log(f"[12c] runner --ana_ckpt on the trained .pt: {len(got.records)} "
        f"records bit-equal to the in-process path, anatomy found "
        f"{found:.3f}, K2 launches {k2_runner}")

    # ---- 12d. the CLI ------------------------------------------------------
    cli_pt = work / "cli.pt"
    t0 = time.perf_counter()
    cli_scores = td.main(["--synthetic", "8", "--steps", "2",
                          "--image_size", str(DET_CLI_SIZE),
                          "--batch_size", "4", "--ckpt_out", str(cli_pt),
                          "--device", device])
    r["cli_s"] = time.perf_counter() - t0
    cli_sd = torch.load(cli_pt, weights_only=True)
    if set(cli_sd) != set(sd) or "AP50" not in cli_scores:
        raise AssertionError("12d: the CLI's checkpoint or scores")
    log(f"[12d] train_detector.main --synthetic 8 --steps 2 --image_size "
        f"{DET_CLI_SIZE}: {r['cli_s']:.1f} s, AP50 {cli_scores['AP50']:.4f}, "
        f"{cli_pt.name} with {len(cli_sd)} tensors")

    # ---- 12e. times ---------------------------------------------------------
    steps = tr.step_seconds[2:DET_STEPS]
    r["step_ms"] = statistics.median(steps) * 1e3
    r["step_ms_all"] = [x * 1e3 for x in tr.step_seconds[:DET_STEPS]]
    r["images_per_s"] = det.batch_size / statistics.median(steps)
    r["augment_ms_per_batch"] = statistics.median(tr.augment_seconds) * 1e3
    r["augment_ms_all"] = [x * 1e3 for x in tr.augment_seconds]
    batch = next(td.batches(arrays, det.batch_size, shuffle=False, seed=0))
    tensors = tr._tensors(*batch)
    draws = tr.draws(det.batch_size, SEED, 0, td.TRAIN_DRAWS)
    m = tr.model
    split = {}
    for _ in range(2):                 # the first warms up
        m.zero_grad(set_to_none=True)
        sync()
        t0 = time.perf_counter()
        losses, _ = m.losses(*tensors, draws)
        sync()
        t1 = time.perf_counter()
        losses["total"].backward()
        sync()
        t2 = time.perf_counter()
        tr.opt.step([p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in tr.opt.params])
        sync()
        t3 = time.perf_counter()
        split = {"forward_ms": (t1 - t0) * 1e3,
                 "backward_ms": (t2 - t1) * 1e3,
                 "optimizer_ms": (t3 - t2) * 1e3}
    r["split"] = split
    tr.evaluate(arrays)                 # warm
    sync()
    t0 = time.perf_counter()
    tr.evaluate(arrays)
    sync()
    r["eval_images_per_s"] = DET_TRAIN_IMAGES / (time.perf_counter() - t0)
    prof = r["profile"] = device_busy(lambda: tr.train_step(
        *tensors, draws)) if device == "cuda" else None
    # the last fit step's batch and draws again (its step was the slowest
    # in earlier runs), on the weights of now
    prof_last = r["profile_last_batch"] = device_busy(
        lambda: tr.train_step(*last_args), reps=1) \
        if device == "cuda" else None
    log(f"[12e] on {rec.get('card', device)}: train step "
        f"{r['step_ms']:.1f} ms (median of steps 3-{DET_STEPS}, all "
        f"{['%.1f' % t for t in r['step_ms_all']]}), "
        f"{r['images_per_s']:.2f} images trained/s (the whole `fit`, "
        f"augmentation and first steps included: "
        f"{r['fit_images_per_s']:.2f}); forward "
        f"{split['forward_ms']:.1f} / backward {split['backward_ms']:.1f} / "
        f"optimizer {split['optimizer_ms']:.1f} ms; augmentation "
        f"{r['augment_ms_per_batch']:.1f} ms a batch on the host (median; "
        f"all {['%.0f' % t for t in r['augment_ms_all']]}); peak memory "
        f"{peak} MiB; eval {r['eval_images_per_s']:.2f} images/s; data "
        f"made in {data_s:.1f} s")
    for what, pr in (("the first batch", prof),
                     (f"step {DET_STEPS}'s batch", prof_last)):
        if pr:
            log(f"     one train step on {what} under the profiler: "
                f"{pr['wall_ms']:.1f} ms host wall, the card busy "
                f"{pr['busy_ms']:.1f} ms ({pr['busy_share']:.3f}), "
                f"{pr['launches']:.0f} device activities; top by device "
                "time: " + "; ".join(
                    f"{kk['name']} {kk['ms']:.2f} ms x{kk['launches']:.0f}"
                    for kk in pr["top"]))
    shutil.rmtree(work, ignore_errors=True)
    return k2 + k2_runner


# ---------------------------------------------------------------------------
# phase 13: from raw files to answers
# ---------------------------------------------------------------------------

class _StandinDataset:
    """The part of an h5py dataset the port's writer and reader use, on
    a numpy array (rows grow along axis 0)."""

    # not raw-readable: the feature store reads through this object
    compression, shuffle, fletcher32, scaleoffset = "standin", False, \
        False, None

    def __init__(self, array):
        self.a = array

    shape = property(lambda self: self.a.shape)
    dtype = property(lambda self: self.a.dtype)

    def resize(self, n, axis=0):
        import numpy as np
        if axis:
            raise ValueError("the stand-in grows along axis 0 only")
        new = np.zeros((n,) + self.a.shape[1:], self.a.dtype)
        m = min(n, self.a.shape[0])
        new[:m] = self.a[:m]
        self.a = new

    def __getitem__(self, key):
        return self.a[key]

    def __setitem__(self, key, value):
        self.a[key] = value

    def __len__(self):
        return self.a.shape[0]


class _StandinFile:
    """h5py.File's surface for the port's HDF5 writer and feature store,
    kept as one .npz at `path` (attributes as JSON beside the arrays)."""

    def __init__(self, path, mode="r"):
        import numpy as np
        self.path, self.mode = str(path), mode
        self.sets, self.attrs = {}, {}
        if mode != "w":
            with np.load(self.path) as z:
                self.attrs = json.loads(str(z["__attrs__"]))
                self.sets = {k: _StandinDataset(z[k]) for k in z.files
                             if k != "__attrs__"}

    def create_dataset(self, name, shape, maxshape=None, chunks=None,
                       dtype="float32"):
        import numpy as np
        self.sets[name] = _StandinDataset(np.zeros(shape, dtype))
        return self.sets[name]

    def __contains__(self, name):
        return name in self.sets

    def __getitem__(self, name):
        return self.sets[name]

    def keys(self):
        return self.sets.keys()

    def flush(self):
        pass

    def close(self):
        import numpy as np
        if self.mode != "r":
            with open(self.path, "wb") as f:
                np.savez(f, __attrs__=np.array(json.dumps(self.attrs)),
                         **{k: d.a for k, d in self.sets.items()})


def h5py_module():
    """h5py, or where it is not installed a module with the part of its
    API the port uses, writing .npz files: the pipeline's feature file
    then round-trips through the port's own writer and reader. Returns
    (the module, what it is)."""
    try:
        import h5py
        return h5py, f"h5py {h5py.__version__}"
    except ImportError:
        import types
        mod = types.ModuleType("h5py")
        mod.File = _StandinFile
        sys.modules["h5py"] = mod
        return mod, "numpy stand-in (h5py not installed)"


class Patches:
    """Attributes replaced for a block and put back after it."""

    def __init__(self):
        self.saved = []

    def set(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        return False


class PipelineProbe(Patches):
    """Watches the stage pipeline from outside: each stage entry point
    timed by the host clock (seconds, and K1's and K2's launches
    within), the greedy decodes counted (and, with `check_step0`, each
    held against the plain decode on fresh weights), the detector
    trainer's eval batches counted and its losses kept, and the test
    stage's predictions and split size kept. Every train step's losses (VQA and
    detector) are read back as they come."""

    def __init__(self, check_step0: bool = False):
        super().__init__()
        import torch
        from ekaid_torch.data import images, preprocess
        from ekaid_torch.extract import runner
        from ekaid_torch.models import greedy_decode as gd
        from ekaid_torch.models.ekaid import EkaidModel
        from ekaid_torch.ops import roi_kernels as rk
        from ekaid_torch.train import test as tst
        from ekaid_torch.train import train as trn
        from ekaid_torch.train import train_detector as td
        self.k1, self.k2 = gd.greedy_decode, rk.multilevel_roi_align_canvas
        self.stages, self.decodes, self.det_evals = {}, 0, 0
        self.det_losses, self.vqa_losses = [], []
        self.tests, self.printed = [], []
        for mod, name, stage in ((images, "convert_tree", "convert"),
                                 (td, "main", "detector"),
                                 (runner, "main", "extract"),
                                 (preprocess, "transform_questions",
                                  "preprocess"),
                                 (trn, "main", "train"),
                                 (tst, "main", "test")):
            self.set(mod, name, self._timed(stage, getattr(mod, name)))
        decode, detect = EkaidModel.decode, td.DetectorTrainer.detect
        step, run_test = td.DetectorTrainer.train_step, tst.run_test
        vqa_step = trn.train_step

        def counted_decode(model, batch, sample_max=True, **kw):
            out = decode(model, batch, sample_max=sample_max, **kw)
            if sample_max:
                self.decodes += 1
                if check_step0 and not torch.equal(
                        out["seq"][:, 0], plain_step0(model, batch)):
                    raise AssertionError(
                        f"decode {self.decodes}: K1's step-0 tokens differ "
                        "from the plain decode on fresh weights")
            return out

        def counted_detect(trainer, images):
            self.det_evals += 1
            return detect(trainer, images)

        def logged_step(trainer, *a, **kw):
            out = step(trainer, *a, **kw)
            self.det_losses.append({n: float(v) for n, v in out.items()})
            return out

        def logged_vqa_step(*a, **kw):
            out = vqa_step(*a, **kw)
            self.vqa_losses.append({n: float(v) for n, v in out.items()})
            return out

        def kept_test(trainer, *a, **kw):
            scores, preds = run_test(trainer, *a, **kw)
            self.tests.append({"pairs": len(trainer.eval_ds),
                               "predictions": len(preds)})
            return scores, preds

        self.set(EkaidModel, "decode", counted_decode)
        self.set(td.DetectorTrainer, "detect", counted_detect)
        self.set(td.DetectorTrainer, "train_step", logged_step)
        self.set(trn, "train_step", logged_vqa_step)
        self.set(tst, "run_test", kept_test)

    def _timed(self, stage, fn):
        def run(*a, **kw):
            k1, k2 = self.k1.launches, self.k2.launches
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            dt = time.perf_counter() - t0
            s = self.stages.setdefault(stage, {"s": 0.0, "calls": 0,
                                               "k1": 0, "k2": 0})
            s["s"] += dt
            s["calls"] += 1
            s["k1"] += self.k1.launches - k1
            s["k2"] += self.k2.launches - k2
            return out
        return run

    def run(self, argv):
        """`tools.pipeline.main(argv)`, its output echoed and kept."""
        import contextlib
        import io
        from ekaid_torch.tools import pipeline
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                pipeline.main(argv)
        finally:
            text = buf.getvalue()
            self.printed.append(text)
            for line in text.splitlines():
                if line.startswith("[") or "took" in line:
                    log(f"      | {line[:150]}")
        return text


def _finite(values) -> bool:
    return all(math.isfinite(float(v)) for v in values)


def write_raw_inputs(root: Path, n_pairs: int, seed: int = SEED):
    """2 x n_pairs grayscale JPGs of assorted sizes (not square, not
    1024^2), named so that sorted order is write order (image 2i is pair
    i's main image, 2i + 1 its reference), and a question CSV of n_pairs
    rows over the seven question types. Returns ({stem: (h, w)}, csv)."""
    import csv as csvmod
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    jpgs = root / "jpgs"
    jpgs.mkdir(parents=True)
    sizes = {}
    for i in range(2 * n_pairs):
        h = int(rng.integers(600, 1400))
        w = int(rng.integers(500, 1300))
        if w == h or 1024 in (h, w):
            w += 7
        sizes[f"cxr{i:04d}"] = (h, w)
    coarse = rng.integers(0, 256, (2 * n_pairs, 24, 20), dtype=np.uint8)
    noise = rng.integers(0, 24, (2 * n_pairs, 64, 64), dtype=np.uint8)

    def write(i_stem):
        i, stem = i_stem
        h, w = sizes[stem]
        img = Image.fromarray(coarse[i]).resize((w, h), Image.BILINEAR)
        px = np.asarray(img, np.uint16) + np.tile(
            noise[i], (h // 64 + 1, w // 64 + 1))[:h, :w]
        Image.fromarray(np.clip(px, 0, 255).astype(np.uint8)).save(
            jpgs / f"{stem}.jpg", quality=90)

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(write, enumerate(sizes)))
    types = ("abnormality", "presence", "view", "location", "level",
             "type", "difference")
    findings = ("effusion", "edema", "atelectasis", "pneumonia",
                "cardiomegaly", "pneumothorax", "opacity")
    places = ("left lung", "right lung", "both lungs", "the heart")
    csv_path = root / "questions.csv"
    with open(csv_path, "w", newline="") as f:
        w = csvmod.writer(f)
        w.writerow(["question", "answer", "question_type", "study_id",
                    "ref_id"])
        for i in range(n_pairs):
            t = types[i % len(types)]
            find = findings[int(rng.integers(len(findings)))]
            place = places[int(rng.integers(len(places)))]
            q, a = {
                "abnormality": ("what abnormalities are seen in this image?",
                                f"{find}, {findings[i % 7]}."),
                "presence": (f"is there evidence of {find} in this image?",
                             "yes" if i % 3 else "no"),
                "view": ("which view is this image taken?",
                         "PA view" if i % 2 else "AP view"),
                "location": (f"where in the image is the {find} located?",
                             f"{place}."),
                "level": (f"what level is the {find}?",
                          ("mild", "moderate", "severe")[i % 3]),
                "type": (f"what type is the {find}?", "interstitial"),
                "difference": ("what has changed compared to the reference "
                               "image?", f"the main image has additional "
                               f"findings of {find} than the reference "
                               "image."),
            }[t]
            w.writerow([q, a, t, 50000 + i, 60000 + i])
    return sizes, csv_path


def multinomial_agree(card_out, cpu_out, cpu_scores, tol: float,
                      what: str) -> dict:
    """The multinomial decode on the card against the CPU's on the same
    weights and Gumbel draws: each row's tokens equal to the end, or up
    to the first step where the CPU's two best scores (draw + logp /
    temp, with the step's bans) are closer than `tol`. Returns the rows
    that differ and the logprob error over the rows' equal prefix."""
    import torch
    a, b = card_out["seq"].cpu(), cpu_out["seq"].cpu()
    d = a != b
    prefix = ~(d.cumsum(1) > 0)
    lp_err = ((card_out["logprobs"].cpu() - cpu_out["logprobs"].cpu())
              .abs() * prefix).max().item()
    r = {"rows_differ": int(d.any(1).sum()), "prefix_lp_err": lp_err,
         "rows": []}
    for row in d.any(1).nonzero()[:, 0].tolist():
        first = int(d[row].nonzero()[0])
        gaps = []
        for t in range(first + 1):
            top = torch.topk(cpu_scores[t][row], 2).values
            gaps.append(float(top[0] - top[1]))
        ties = [t for t, g in enumerate(gaps) if g < tol]
        r["rows"].append({"row": row, "step": first,
                          "near_tie_step": ties[0] if ties else None})
        if not ties:
            raise AssertionError(
                f"{what}: row {row} differs at step {first} with no "
                f"near-tie (< {tol:.3g}) up to it; the CPU's top-2 score "
                f"gap there is {gaps[-1]:.3g}")
    return r


def d2_state(seed: int, num_classes: int) -> dict:
    """A Detectron2 GeneralizedRCNN R50-FPN state dict at full widths
    from seeded arrays (He-scaled convs, FrozenBatchNorm2d buffers), with
    the zoo's pixel_mean/pixel_std."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k, bias=False):
        sd[f"{name}.weight"] = (rng.standard_normal((cout, cin, k, k))
                                * math.sqrt(2.0 / (cin * k * k))
                                ).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = np.zeros(cout, np.float32)

    def bn(name, c):
        sd[f"{name}.norm.weight"] = rng.uniform(0.5, 1.0, c).astype(
            np.float32)
        sd[f"{name}.norm.bias"] = (rng.standard_normal(c) * 0.1).astype(
            np.float32)
        sd[f"{name}.norm.running_mean"] = (rng.standard_normal(c) * 0.1
                                           ).astype(np.float32)
        sd[f"{name}.norm.running_var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)

    bu = "backbone.bottom_up"
    conv(f"{bu}.stem.conv1", 64, 3, 7)
    bn(f"{bu}.stem.conv1", 64)
    cin = 64
    for s, (depth, cout) in enumerate(zip((3, 4, 6, 3),
                                          (256, 512, 1024, 2048))):
        width = cout // 4
        for b in range(depth):
            p = f"{bu}.res{s + 2}.{b}"
            c_in = cin if b == 0 else cout
            for i, (co, ci, k) in enumerate(((width, c_in, 1),
                                             (width, width, 3),
                                             (cout, width, 1)), 1):
                conv(f"{p}.conv{i}", co, ci, k)
                bn(f"{p}.conv{i}", co)
            if b == 0:
                conv(f"{p}.shortcut", cout, c_in, 1)
                bn(f"{p}.shortcut", cout)
        cin = cout
    for lvl, c in zip((2, 3, 4, 5), (256, 512, 1024, 2048)):
        conv(f"backbone.fpn_lateral{lvl}", 256, c, 1, bias=True)
        conv(f"backbone.fpn_output{lvl}", 256, 256, 3, bias=True)
    rp = "proposal_generator.rpn_head"
    conv(f"{rp}.conv", 256, 256, 3, bias=True)
    conv(f"{rp}.objectness_logits", 3, 256, 1, bias=True)
    conv(f"{rp}.anchor_deltas", 12, 256, 1, bias=True)
    for name, (o, i) in (("roi_heads.box_head.fc1", (1024, 256 * 49)),
                         ("roi_heads.box_head.fc2", (1024, 1024)),
                         ("roi_heads.box_predictor.cls_score",
                          (num_classes + 1, 1024)),
                         ("roi_heads.box_predictor.bbox_pred",
                          (num_classes * 4, 1024))):
        sd[f"{name}.weight"] = (rng.standard_normal((o, i))
                                * math.sqrt(1.0 / i)).astype(np.float32)
        sd[f"{name}.bias"] = np.zeros(o, np.float32)
    sd["pixel_mean"] = np.array([103.53, 116.28, 123.675],
                                np.float32).reshape(3, 1, 1)
    sd["pixel_std"] = np.ones((3, 1, 1), np.float32)
    return sd


def raw_files_phase(rec: dict, cfg, device: str = "cuda",
                    image_size: int = 1024, det_size: int = DET_CLI_SIZE,
                    raw_pairs: int = RAW_PAIRS) -> tuple:
    """Phase 13, from raw files to answers: (a) the stage pipeline on
    synthetic data, (b) on JPGs and a question CSV the phase writes,
    (c) ask and draw, (d) a converted Detectron2 detector. `cfg` is the
    VQA and detector config of the runs with --cfg (the synthetic runs
    read the entry points' defaults). Returns K1's and K2's launches."""
    import pickle
    import shutil
    import numpy as np
    import torch
    import yaml
    from ekaid_torch.models import greedy_decode as gd
    from ekaid_torch.models.decoder import gumbel_draws
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.tools import torch_convert
    from ekaid_torch.utils.dtypes import BF16, F32
    from ekaid_torch.viz import ask, examples
    t_phase = time.perf_counter()
    h5py, rec["p13_h5"] = h5py_module()
    try:
        import matplotlib  # noqa: F401
        draw = True
    except ImportError:
        draw = False
    rec["p13_figures"] = ("drawn" if draw else
                          "not drawn: matplotlib is not installed here")
    work = ROOT / "build" / "phase13"
    shutil.rmtree(work, ignore_errors=True)
    k1_total = k2_total = 0
    dev = ["--device", device]

    # ---- 13a. the synthetic pipeline --------------------------------------
    root_a = work / "a"
    argv_a = ["--data_root", str(root_a), "--synthetic",
              str(PIPE_SYNTHETIC), "--image_size", str(image_size)] + dev
    with PipelineProbe() as pa:
        pa.run(argv_a + ["--stage", "all", "--detector_steps",
                         str(PIPE_DET_STEPS), "--train_iters",
                         str(PIPE_TRAIN_ITERS)])
        st = pa.stages
        for f in ("ckpt_anatomy.pt", "ckpt_disease.pt",
                  "cmb_bbox_di_feats.hdf5", "run/metrics.jsonl",
                  "run/snapshots/best.pt", "run/test_results.json"):
            if not (root_a / f).exists():
                raise AssertionError(f"13a: no {f}")
        vqa_losses = [d["total_loss"] for d in pa.vqa_losses]
        det_losses = [v for d in pa.det_losses for v in d.values()]
        if len(vqa_losses) != PIPE_TRAIN_ITERS or not _finite(
                [v for d in pa.vqa_losses for v in d.values()]):
            raise AssertionError(f"13a: VQA losses {pa.vqa_losses}")
        if len(pa.det_losses) != 2 * PIPE_DET_STEPS or not _finite(
                det_losses):
            raise AssertionError(f"13a: detector losses {pa.det_losses}")
        f = h5py.File(str(root_a / "cmb_bbox_di_feats.hdf5"), "r")
        n_rows = f["image_features"].shape[0]
        f.close()
        batches = -(-n_rows // cfg.detector.extract_batch_size)
        results = json.loads((root_a / "run" / "test_results.json")
                             .read_text())
        test = pa.tests[0]
        if n_rows != PIPE_SYNTHETIC:
            raise AssertionError(f"13a: {n_rows} feature rows")
        if st["extract"]["k2"] != 2 * batches:
            raise AssertionError(f"13a: K2 launched {st['extract']['k2']} "
                                 f"times in extraction for {batches} "
                                 "batches")
        if st["detector"]["k2"] != pa.det_evals:
            raise AssertionError(f"13a: K2 launched {st['detector']['k2']}"
                                 f" times for {pa.det_evals} detector-eval "
                                 "batches")
        k1 = st["train"]["k1"] + st["test"]["k1"]
        if k1 != pa.decodes:
            raise AssertionError(f"13a: K1 launched {k1} times for "
                                 f"{pa.decodes} eval and test batches")
        if not (len(results) == test["pairs"] == test["predictions"]):
            raise AssertionError(f"13a: {len(results)} predictions for "
                                 f"{test['pairs']} test pairs")
        k1_total += k1
        k2_total += st["detector"]["k2"] + st["extract"]["k2"]
        rec["p13a_stage_s"] = {k: v["s"] for k, v in st.items()}
        rec["p13a_launches"] = {k: {"k1": v["k1"], "k2": v["k2"]}
                                for k, v in st.items()}
        log(f"[13a] pipeline --stage all --synthetic {PIPE_SYNTHETIC} at "
            f"{image_size}^2: stages (s) " + ", ".join(
                f"{k} {v['s']:.1f}" for k, v in st.items())
            + f"; detector losses finite over {len(pa.det_losses)} steps, "
            f"VQA losses {[round(x, 3) for x in vqa_losses]}; K2 "
            f"{st['detector']['k2']} (= {pa.det_evals} detector-eval "
            f"batches) + {st['extract']['k2']} (= 2 x {batches} extraction "
            f"batches); K1 {k1} (= {pa.decodes} eval and test batches); "
            f"{len(results)} test predictions for {test['pairs']} pairs")
        k2 = pa.k2.launches
        text = pa.run(argv_a + ["--stage", "extract"])
        if "[extract] skipped (exists)" not in text or pa.k2.launches != k2:
            raise AssertionError("13a: a second extract stage ran")
        mtime = (root_a / "cmb_bbox_di_feats.hdf5").stat().st_mtime_ns
        pa.run(argv_a + ["--stage", "extract", "--force"])
        if pa.k2.launches - k2 != 2 * batches or (
                root_a / "cmb_bbox_di_feats.hdf5").stat().st_mtime_ns \
                == mtime:
            raise AssertionError("13a: --force did not redo extraction")
        k2_total += 2 * batches
    log(f"      a second --stage extract: skipped (exists); with --force: "
        f"redone, K2 {2 * batches} more")
    if device == "cuda":
        torch.cuda.empty_cache()

    # ---- 13b. raw files ----------------------------------------------------
    root_b = work / "b"
    t0 = time.perf_counter()
    sizes, csv_path = write_raw_inputs(work / "raw", raw_pairs)
    rec["p13b_write_inputs_s"] = time.perf_counter() - t0
    n_img = len(sizes)
    argv_b = ["--data_root", str(root_b), "--image_size", str(image_size),
              "--image_dir", str(work / "raw" / "jpgs"),
              "--question_csv", str(csv_path)] + dev
    data = {"vocab_json": str(root_b / "vocab_mimic_VQA.json"),
            "splits_json": str(root_b / "splits_mimic_VQA.json"),
            "feature_h5": str(root_b / "cmb_bbox_di_feats.hdf5"),
            "gt_captions": str(root_b / "mimic_gt_captions_%s.json")}
    bcfg = cfg.replace(data=cfg.data.replace(**data))
    yaml_path = work / "raw.yaml"
    yaml_path.write_text(yaml.safe_dump(json.loads(json.dumps(
        bcfg.to_dict()))))
    with PipelineProbe(check_step0=True) as pb:
        pb.run(argv_b + ["--stage", "convert"])
        with open(root_b / "pngs" / "mimic_shape_full.pkl", "rb") as f:
            shapes = pickle.load(f)
        got = {s["image"]: tuple(s["shape"]) for s in shapes}
        if got != sizes:
            raise AssertionError("13b: mimic_shape_full.pkl holds other "
                                 "sizes than the phase wrote")
        (root_b / "ckpt_anatomy.pt").write_bytes(
            (root_a / "ckpt_anatomy.pt").read_bytes())
        (root_b / "ckpt_disease.pt").write_bytes(
            (root_a / "ckpt_disease.pt").read_bytes())
        if "[detector] skipped (exists)" not in pb.run(
                argv_b + ["--stage", "detector"]):
            raise AssertionError("13b: the detector stage ran")
        for stage in ("extract", "preprocess"):
            pb.run(argv_b + ["--stage", stage])
        f = h5py.File(data["feature_h5"], "r")
        n_rows = f["image_features"].shape[0]
        feats_ok = bool(np.isfinite(f["image_features"][:]).all())
        f.close()
        fidx = np.load(root_b / "vqa_dataset.npz")["feature_idx"]
        if n_rows != n_img or not feats_ok:
            raise AssertionError(f"13b: {n_rows} feature rows for {n_img} "
                                 f"images (finite: {feats_ok})")
        if int(fidx.max()) >= n_rows or len(fidx) != raw_pairs:
            raise AssertionError(f"13b: feature_idx up to {fidx.max()} "
                                 f"over {n_rows} rows")
        for stage in ("train", "test"):
            pb.run(argv_b + ["--stage", stage, "--train_iters",
                             str(PIPE_TRAIN_ITERS), "--cfg", str(yaml_path)])
        st = pb.stages
        batches = -(-n_img // cfg.detector.extract_batch_size)
        if st["extract"]["k2"] != 2 * batches:
            raise AssertionError(f"13b: K2 launched {st['extract']['k2']} "
                                 f"times for {batches} batches")
        vqa_losses = [d["total_loss"] for d in pb.vqa_losses]
        if len(vqa_losses) != PIPE_TRAIN_ITERS or not _finite(
                [v for d in pb.vqa_losses for v in d.values()]):
            raise AssertionError(f"13b: VQA losses {pb.vqa_losses}")
        k1 = st["train"]["k1"] + st["test"]["k1"]
        if k1 != pb.decodes:
            raise AssertionError(f"13b: K1 launched {k1} times for "
                                 f"{pb.decodes} eval and test batches")
        results = json.loads((root_b / "run" / "test_results.json")
                             .read_text())
        split = json.loads(Path(data["splits_json"]).read_text())["test"]
        if sorted(int(r["image_id"]) for r in results) != sorted(split):
            raise AssertionError(f"13b: predictions for "
                                 f"{[r['image_id'] for r in results]}, test "
                                 f"questions {split}")
        k1_total += k1
        k2_total += st["extract"]["k2"]
        rec["p13b_stage_s"] = {k: v["s"] for k, v in st.items()}
        rec["p13b_extract_images_per_s"] = n_img / st["extract"]["s"]
        rec["p13b_launches"] = {k: {"k1": v["k1"], "k2": v["k2"]}
                                for k, v in st.items()}
    log(f"[13b] raw files: {n_img} JPGs ({rec['p13b_write_inputs_s']:.1f} s "
        f"to write) and {raw_pairs} questions -> stages (s) " + ", ".join(
            f"{k} {v:.1f}" for k, v in rec["p13b_stage_s"].items())
        + f"; VQA losses {[round(x, 3) for x in vqa_losses]}; extraction "
        f"{rec['p13b_extract_images_per_s']:.1f} images/s "
        f"(the stage, PNG decode and model build included); shapes pickle "
        f"equal to the sizes written; {n_rows} feature rows "
        f"({rec['p13_h5']}), feature_idx < {n_rows}; K2 "
        f"{st['extract']['k2']} = 2 x {batches}; K1 {k1} = {pb.decodes} "
        f"decodes, each batch's step-0 tokens equal the plain decode's; "
        f"{len(results)} predictions for the {len(split)} test questions")

    # ---- 13c. ask and draw ---------------------------------------------------
    snaps = root_b / "run" / "snapshots"
    png = work / "ask.png"
    question = "what has changed compared to the reference image?"
    k1 = gd.greedy_decode.launches
    with Patches() as pc:
        kept, ask_q = {}, ask.ask_question

        def timed_ask(trainer, *a, **kw):
            kept["trainer"] = trainer
            if device == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = ask_q(trainer, *a, **kw)
            if device == "cuda":
                torch.cuda.synchronize()
            rec["p13c_ask_ms"] = (time.perf_counter() - t) * 1e3
            return out

        pc.set(ask, "ask_question", timed_ask)
        res = ask.main(["--cfg", str(yaml_path), "--checkpoint_dir",
                        str(snaps), "--checkpoint", "best", "--question",
                        question, "--n_samples", str(ASK_SAMPLES)] + dev
                       + (["--out", str(png)] if draw else []))
    k1 = gd.greedy_decode.launches - k1
    if sum(res["counts"].values()) != ASK_SAMPLES:
        raise AssertionError(f"13c: answer counts {res['counts']}")
    if device == "cuda" and k1 != 1:
        raise AssertionError(f"13c: K1 launched {k1} times for one greedy "
                             "answer")
    if draw and not png.stat().st_size:
        raise AssertionError("13c: no figure")
    k1_total += k1
    rec["p13c_answers"] = {"distinct": len(res["counts"]),
                           "greedy": res["greedy"]}
    tr = kept["trainer"]
    sd = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    eb = tr.eval_ds.sample_batch(np.arange(min(MULTI_ROWS,
                                               len(tr.eval_ds))))
    ntoken, sp = len(tr.vocab.word_to_idx), tr.cfg.speaker
    T, V = sp.seq_length, sp.vocab_size
    g = gumbel_draws((T, len(eb["question"]), V),
                     torch.Generator().manual_seed(SEED))
    outs = {}
    for policy, tag in ((F32, "f32"), (BF16, "bf16")):
        for d in (device, "cpu"):
            m = EkaidModel(tr.cfg, ntoken, policy=policy, device=d, seed=None)
            m.load_state_dict(sd)
            scores = []
            if d == "cpu" and tag == "f32":
                out_lp = m.speaker._out_logprobs

                def kept_lp(h, dpos, mask=None, _f=out_lp):
                    lp = _f(h, dpos, mask)
                    t = len(scores)
                    s = g[t].double() + lp[0].double() / sp.temperature
                    if t == 0:
                        s[:, 0] = -math.inf
                    scores.append(s)
                    return lp
                m.speaker._out_logprobs = kept_lp
            if d == device:
                if device == "cuda":
                    torch.cuda.synchronize()
                t = time.perf_counter()
            outs[tag, d] = m.decode(eb, sample_max=False, gumbel=g.to(d))
            if d == device:
                if device == "cuda":
                    torch.cuda.synchronize()
                rec[f"p13c_multinomial_{tag}_ms"] = (time.perf_counter()
                                                     - t) * 1e3
            if scores:
                outs["scores"] = scores
            del m
    tol = rec.get("near_tie_tol", NEAR_TIE_FLOOR)    # phase 3 sets it
    r = multinomial_agree(outs["f32", device], outs["f32", "cpu"],
                          outs["scores"], tol, "13c multinomial f32")
    if r["prefix_lp_err"] > MULTI_LP_GATE:
        raise AssertionError(f"13c: multinomial logprobs of the equal "
                             f"prefix {r['prefix_lp_err']} > "
                             f"{MULTI_LP_GATE}")
    rec["p13c_multinomial_f32"] = r
    a16, b16 = outs["bf16", device]["seq"].cpu(), outs["bf16", "cpu"]["seq"]
    rec["p13c_multinomial_bf16_token_share"] = (a16 == b16).float().mean(
        ).item()
    gt_test = data["gt_captions"] % "test"
    kind = json.loads(Path(gt_test).read_text())["annotations"][0][
        "question_type"]
    ex = examples.find_examples(gt_test, question_type=kind)
    examples.main(["--gt_json", gt_test, "--question_type", kind])
    if not ex or any(r["question_type"] != kind for r in ex):
        raise AssertionError(f"13c: examples of type {kind!r}: {ex}")
    if draw:
        from PIL import Image
        fi = np.load(root_b / "vqa_dataset.npz")["feature_idx"]
        order = sorted(sizes)

        def lookup(i):
            a, b = fi[int(i)]
            return tuple(np.asarray(Image.open(
                root_b / "pngs" / f"{order[j]}.png")) for j in (a, b))

        examples.render_sheet(ex, lookup, save=str(work / "sheet.png"))
        if not (work / "sheet.png").stat().st_size:
            raise AssertionError("13c: no example sheet")
    log(f"[13c] viz.ask on the best snapshot: {ASK_SAMPLES} samples, "
        f"{len(res['counts'])} distinct answers, greedy "
        f"{res['greedy'][:50]!r}, K1 launched {k1} time(s), "
        f"ask {rec['p13c_ask_ms']:.1f} ms; figure and sheet "
        f"{rec['p13_figures']}; multinomial decode of {len(eb['question'])} "
        f"pairs, card vs CPU on the same draws: f32 rows differing "
        f"{r['rows_differ']} (each after a near-tie), equal-prefix logprob "
        f"error {r['prefix_lp_err']:.3g} (gate {MULTI_LP_GATE}), "
        f"{rec['p13c_multinomial_f32_ms']:.1f} ms; bf16 token share "
        f"{rec['p13c_multinomial_bf16_token_share']:.4f} (recorded); "
        f"viz.examples found {len(ex)} {kind!r} questions")

    # ---- 13d. a converted detector -------------------------------------------
    k = cfg.detector.num_anatomy_classes
    sd = {n: torch.from_numpy(v) for n, v in d2_state(SEED, k).items()}
    pth, pt = work / "model_final.pth", work / "d2_converted.pt"
    torch.save({"model": sd}, pth)
    del sd
    t0 = time.perf_counter()
    torch_convert.main([str(pth), str(pt), "--kind", "detector"])
    rec["p13d_convert_s"] = time.perf_counter() - t0
    root_d = work / "d"
    with PipelineProbe() as pd:
        pd.run(["--data_root", str(root_d), "--stage", "detector",
                "--synthetic", str(CONV_IMAGES), "--detector_steps", "2",
                "--image_size", str(det_size), "--detector_init", str(pt)]
               + dev)
        losses = [v for d in pd.det_losses for v in d.values()]
        if len(pd.det_losses) != 4 or not _finite(losses):
            raise AssertionError(f"13d: detector losses {pd.det_losses}")
        if pd.stages["detector"]["k2"] != pd.det_evals:
            raise AssertionError("13d: K2 launches != detector-eval batches")
        k2 = pd.k2.launches
        out = work / "d2_feats.hdf5"
        from ekaid_torch.extract import runner
        runner.main(["--ana_ckpt", str(pt), "--norm", "frozen_bn",
                     "--stride_in_1x1", "--preprocess", "detectron2",
                     "--synthetic", str(CONV_IMAGES), "--image_size",
                     str(det_size), "--out", str(out)] + dev)
        k2 = pd.k2.launches - k2
        f = h5py.File(str(out), "r")
        feats = np.asarray(f["image_features"][:])
        f.close()
        if k2 != 2 or feats.shape[0] != CONV_IMAGES or not np.isfinite(
                feats).all():
            raise AssertionError(f"13d: K2 {k2}, records {feats.shape}, "
                                 f"finite {np.isfinite(feats).all()}")
        k2_total += pd.stages["detector"]["k2"] + k2
        rec["p13d_stage_s"] = {k: v["s"] for k, v in pd.stages.items()}
    log(f"[13d] a Detectron2 R50-FPN state dict (full widths) converted in "
        f"{rec['p13d_convert_s']:.1f} s; --detector_init at {det_size}^2: "
        f"losses finite over {len(pd.det_losses)} steps; the runner on the "
        f"converted .pt (frozen_bn, stride_in_1x1, detectron2 "
        f"preprocessing) over {CONV_IMAGES} images: K2 {k2} (one batch, "
        f"two detectors), records finite")
    shutil.rmtree(work, ignore_errors=True)
    for d in ("ekaid_test", "ekaid_ask"):
        shutil.rmtree(ROOT / "build" / d, ignore_errors=True)
    rec["p13_s"] = time.perf_counter() - t_phase
    log(f"     phase 13 took {rec['p13_s']:.1f} s")
    return k1_total, k2_total


class Knobs:
    """`module.cfg` replaced by a copy with `kw` set, for a `with`
    block."""

    def __init__(self, module, **kw):
        self.module, self.kw = module, kw

    def __enter__(self):
        self.old = self.module.cfg
        self.module.cfg = self.old.replace(**self.kw)
        return self.module

    def __exit__(self, *exc):
        self.module.cfg = self.old


def keep_scores(speaker, gumbel=None, temperature: float = 1.0) -> list:
    """Wrap the speaker's `_out_logprobs` so that each step of its torch
    loop appends the step's scores [B, V], f64 on the CPU: logp for a
    greedy loop, draw + logp / temperature for a multinomial one, with
    the step-0 NULL ban. `del speaker._out_logprobs` undoes it."""
    scores = []
    f = speaker._out_logprobs

    def kept(h, dpos, mask=None):
        lp = f(h, dpos, mask)
        t = len(scores)
        s = lp[0].double()
        if gumbel is not None:
            s = gumbel[t].to(s.device).double() + s / temperature
        if t == 0:
            s[:, 0] = -math.inf
        scores.append(s.cpu())
        return lp

    speaker._out_logprobs = kept
    return scores


def loop_agree(out, ref, scores, tol: float, what: str) -> dict:
    """`multinomial_agree` of two torch-loop decodes (the scores are
    `ref`'s), and the equal prefix's logprobs within LOOP_LP_GATE."""
    r = multinomial_agree(out, ref, scores, tol, what)
    if r["prefix_lp_err"] > LOOP_LP_GATE:
        raise AssertionError(f"{what}: logprobs of the equal prefix "
                             f"{r['prefix_lp_err']} > {LOOP_LP_GATE}")
    return r


def prefix_lp_err(a, b) -> float:
    d = (a["seq"] != b["seq"]).cpu()
    prefix = ~(d.cumsum(1) > 0)
    return ((a["logprobs"].cpu() - b["logprobs"].cpu()).abs()
            * prefix).max().item()


def knobs_phase(rec: dict, cfg, m16, batch, engine, keep: dict,
                device: str = "cuda") -> int:
    """Phase 14: the eval knobs and the native host library at `cfg`'s
    widths. m16: the engine's bf16 model; batch: phase 3's numpy batch;
    keep: phase 8's extractor and dispatched batch, phase 11a's captions.
    Returns K1's launches on the path (the batch-1 answers of 14a)."""
    import shutil
    import numpy as np
    import torch
    from ekaid_torch.extract import pipeline as xp
    from ekaid_torch.metrics import caption as cap
    from ekaid_torch.metrics.coco import CaptionEvaluator, CocoCaptions
    from ekaid_torch.models import greedy_decode as gd
    from ekaid_torch.models import quant
    from ekaid_torch.models.decoder import DynamicSpeaker, gumbel_draws
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.native import bindings
    from ekaid_torch.ops.graph import spatial_adjacency
    from ekaid_torch.utils.dtypes import F32
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_phase = time.perf_counter()
    r = rec["knobs"] = {}
    sp = cfg.speaker
    B = len(batch["question"])
    tol = rec.get("near_tie_tol", NEAR_TIE_FLOOR)    # phase 3 sets it
    dt16 = str(m16.policy.compute_dtype).replace("torch.", "")

    def host_ms(fn, reps: int) -> float:
        """Median of `reps` synced host clocks of fn, after one warm-up."""
        ts = []
        for _ in range(reps + 1):
            sync()
            t = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts[1:])

    # ---- 14a. pair_batch ---------------------------------------------------
    dev_batch = m16.tensors(batch)
    idxs = engine.ds.split_idxs
    a = r["pair_batch"] = {"encode_ms": {}, "device": {}, "answer_ms": {}}
    turns = {"off": ([], []), "on": ([], [])}
    gd.greedy_decode.launches = 0
    for pb in ("off", "on", "on", "off"):            # in turns
        with Knobs(m16.change_detector, pair_batch=pb):
            turns[pb][0].append(host_ms(lambda: m16.encode(dev_batch),
                                        KNOB_REPS // 2))
            turns[pb][1].extend(
                engine.answer(None, int(idxs[i % len(idxs)]))["latency_ms"]
                for i in range(KNOB_ANSWERS // 2))
    k1 = gd.greedy_decode.launches
    for pb, (enc_ms, answer_ms) in turns.items():
        a["encode_ms"][pb] = statistics.mean(enc_ms)
        a["answer_ms"][pb] = statistics.median(answer_ms)
        with Knobs(m16.change_detector, pair_batch=pb):
            busy = (device_busy(lambda: m16.encode(dev_batch)) if cuda
                    else {})
            a["device"][pb] = {k: busy.get(k) for k in (
                "launches", "wall_ms", "busy_ms", "busy_share")}
    if cuda and k1 != 2 * KNOB_ANSWERS:
        raise AssertionError(f"14a: K1 launched {k1} times for "
                             f"{2 * KNOB_ANSWERS} answers")
    ntoken = sp.vocab_size - 1               # the identity vocab's words
    m32 = EkaidModel(cfg, ntoken, policy=F32, device=device, seed=SEED)
    b32 = m32.tensors(batch)
    encs = {}
    for pb in ("off", "on"):
        with Knobs(m32.change_detector, pair_batch=pb):
            encs[pb] = m32.encode(b32)
    a["f32_gap_of_max"] = {}
    for k, v in encs["off"].items():
        gap = (encs["on"][k] - v).abs().max().item()
        top = v.abs().max().item()
        a["f32_gap_of_max"][k] = gap / top if top else gap
        if gap > PAIR_RTOL * top:
            raise AssertionError(f"14a: {k} of 'on' is {gap} off 'off' "
                                 f"(> {PAIR_RTOL} x {top})")
    sp32 = m32.speaker
    w32 = sp32.decode_weights()
    fx = {pb: sp32._fused(e["feat_bef"], e["feat_diff"], e["feat_aft"])
          for pb, e in encs.items()}
    plain = gd.greedy_decode_plain(w32, sp, F32, *fx["off"])
    k1_out = {pb: gd.greedy_decode(w32, sp, F32, *fx[pb]) for pb in fx}
    sync()
    # the near-tie threshold covers the scores' move between the inputs
    step0 = (k1_out["on"]["logprobs"][:, 0]
             - k1_out["off"]["logprobs"][:, 0]).abs().max().item()
    a["k1_step0_lp_gap"] = step0
    tol_a = max(tol, 4 * step0)
    a["k1_vs_plain"] = {pb: near_tie_agree(
        w32, sp, F32, *fx["off"], plain, k1_out[pb], tol_a,
        f"14a K1 pair_batch {pb!r}") for pb in fx}
    small = {k: v[:TRAIN_B] for k, v in batch.items()}
    fwd = {}
    with torch.no_grad():
        for pb in ("train", "on", "off"):
            with Knobs(m32.change_detector, pair_batch=pb):
                fwd[pb] = m32(small, gen=torch.Generator(
                    device=device).manual_seed(SEED))
    for k, v in fwd["on"].items():
        if not torch.equal(fwd["train"][k], v):
            raise AssertionError(f"14a: training-mode {k} of 'train' "
                                 "differs from 'on' under one generator")
    if torch.equal(fwd["off"]["feat_diff"], fwd["on"]["feat_diff"]):
        raise AssertionError("14a: 'off' drew the same dropout as 'on'")
    log(f"[14a] pair_batch, {dt16} B={B}: encoder ms off "
        f"{a['encode_ms']['off']:.2f} / on {a['encode_ms']['on']:.2f} "
        f"(two turns each, off-on-on-off, of the median of "
        f"{KNOB_REPS // 2}); torch.profiler, an encode: " + ("; ".join(
            f"{pb} {d['launches']:.0f} device operations, the card busy "
            f"{d['busy_ms']:.2f} of {d['wall_ms']:.2f} ms"
            for pb, d in a["device"].items()) if cuda else "not on the CPU")
        + "; batch-1 "
        f"answer ms off {a['answer_ms']['off']:.2f} / on "
        f"{a['answer_ms']['on']:.2f} (median of {KNOB_ANSWERS}; K1 "
        f"{k1} launches)")
    log(f"      f32: 'on' vs 'off' outputs within "
        f"{max(a['f32_gap_of_max'].values()):.3g} of max|x| (gate "
        f"{PAIR_RTOL}); K1 on both vs the plain decode: rows differing "
        f"off {a['k1_vs_plain']['off']['rows_differ']}, on "
        f"{a['k1_vs_plain']['on']['rows_differ']} (near-tie tol "
        f"{tol_a:.3g}); training mode 'train' == 'on' bit for bit")

    # ---- 14b. decode_kernel='xla': the torch loop --------------------------
    feats32 = (encs["off"]["feat_bef"], encs["off"]["feat_aft"],
               encs["off"]["feat_diff"])
    gd.greedy_decode.launches = 0
    with Knobs(sp32, decode_kernel="xla"):
        loop32 = sp32.sample(*feats32)
    sync()
    if gd.greedy_decode.launches:
        raise AssertionError("14b: the torch loop launched K1")
    b_ = r["xla_loop"] = {"vs_k1": near_tie_agree(
        w32, sp, F32, *fx["off"], k1_out["off"], loop32, tol,
        "14b loop vs K1 f32"), "prefix_lp_err": prefix_lp_err(
            loop32, k1_out["off"])}
    if b_["prefix_lp_err"] > LOOP_LP_GATE:
        raise AssertionError(f"14b: loop vs K1 logprobs {b_['prefix_lp_err']}"
                             f" > {LOOP_LP_GATE}")
    sp16 = m16.speaker
    e16 = m16.encode(dev_batch)
    feats16 = (e16["feat_bef"], e16["feat_aft"], e16["feat_diff"])
    with Knobs(sp16, decode_kernel="xla"):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else 0
        loop16 = sp16.sample(*feats16)
        b_["peak_mib"] = ((torch.cuda.max_memory_allocated() - base) / 2**20
                          if cuda else None)
    b_["steps"] = steps_run(loop16["seq"])
    log(f"[14b] decode_kernel='xla', B={B}: f32 loop vs K1 rows differing "
        f"{b_['vs_k1']['rows_differ']}, equal prefix's logprobs within "
        f"{b_['prefix_lp_err']:.3g} (gate {LOOP_LP_GATE}); {dt16} loop "
        f"{b_['steps']} steps, peak {b_['peak_mib']} MiB over the model")

    # ---- 14c. int8 -------------------------------------------------------
    c_ = r["int8"] = {"matrices": []}
    for name, p in sp32.core.named_parameters():
        if p.dim() == 2 and p.numel() >= quant.QUANT_MIN_ELEMS:
            qd, sd = quant.quantize_matrix(p)
            qc, sc = quant.quantize_matrix(p.detach().cpu())
            if not (torch.equal(qd.cpu(), qc) and torch.equal(sd.cpu(), sc)):
                raise AssertionError(f"14c: quantize_matrix of {name} on "
                                     f"{device} differs from the CPU's")
            c_["matrices"].append(name)
    cpu_sp = DynamicSpeaker(sp, F32)
    cpu_sp.load_state_dict({k: v.detach().cpu()
                            for k, v in sp32.state_dict().items()})
    f8 = tuple(x[:INT8_B] for x in feats32)
    with Knobs(sp32, decode_kernel="xla", weight_quant="int8"), \
            Knobs(cpu_sp, decode_kernel="xla", weight_quant="int8"):
        card8 = sp32.sample(*f8)
        scores8 = keep_scores(cpu_sp)
        cpu8 = cpu_sp.sample(*(x.cpu() for x in f8))
        del cpu_sp._out_logprobs
    c_["f32_card_vs_cpu"] = loop_agree(card8, cpu8, scores8, tol,
                                       "14c int8 f32 card vs CPU")
    with Knobs(sp16, decode_kernel="xla", weight_quant="int8"):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        q16 = sp16.sample(*feats16)
        c_["peak_mib"] = ((torch.cuda.max_memory_allocated() - base)
                          / 2**20 if cuda else None)
    c_["bf16_token_share_vs_unquantized"] = (
        q16["seq"] == loop16["seq"]).float().mean().item()
    T, V = sp.seq_length, sp.vocab_size
    g = gumbel_draws((T, INT8_B, V), torch.Generator().manual_seed(SEED))
    ask = {k: v[:INT8_B] for k, v in dev_batch.items()}
    outs = {}
    for wq in ("int8", "none"):
        with Knobs(sp16, decode_kernel="xla", weight_quant=wq):
            outs[wq] = m16.decode(ask, sample_max=False, gumbel=g.to(device))
        if not torch.isfinite(outs[wq]["logprobs"]).all() or tuple(
                outs[wq]["seq"].shape) != (INT8_B, T):
            raise AssertionError(f"14c: multinomial {wq} decode malformed")
    if torch.equal(outs["int8"]["logprobs"], outs["none"]["logprobs"]):
        raise AssertionError("14c: the int8 multinomial decode equals the "
                             "unquantized one: weight_quant is not applied")
    c_["multinomial_lp_gap"] = (outs["int8"]["logprobs"]
                                - outs["none"]["logprobs"]).abs().max().item()
    log(f"[14c] int8: {len(c_['matrices'])} core matrices quantized on the "
        f"card bit-equal to the CPU ({', '.join(c_['matrices'])}); f32 "
        f"B={INT8_B} card vs CPU rows differing "
        f"{c_['f32_card_vs_cpu']['rows_differ']}, prefix logprobs within "
        f"{c_['f32_card_vs_cpu']['prefix_lp_err']:.3g}; {dt16} B={B} "
        f"tokens equal to the unquantized "
        f"loop {c_['bf16_token_share_vs_unquantized']:.4f}, peak "
        f"{c_['peak_mib']} MiB over the model (unquantized loop "
        f"{b_['peak_mib']}); multinomial of {INT8_B} pairs: logprobs move "
        f"{c_['multinomial_lp_gap']:.3g} from the unquantized decode")

    # ---- 14d. fused_core: the core's own step ----------------------------
    with Knobs(sp32, decode_kernel="xla", fused_core=True):
        fused32 = sp32.sample(*feats32)
    if not all(torch.equal(fused32[k], loop32[k]) for k in loop32):
        raise AssertionError("14d: the fused_core loop differs from the "
                             "unfused loop")
    r["fused_core"] = {"f32_equal_to_unfused": True}
    log(f"[14d] fused_core: f32 B={B} loop bit-equal to the unfused loop "
        "(the knob takes the core's step)")
    # the decode paths' times, in turns (K1, loop, int8, then back)
    paths = {"k1": {}, "loop": {"decode_kernel": "xla"},
             "int8": {"decode_kernel": "xla", "weight_quant": "int8"}}
    order = list(paths) + list(paths)[::-1]
    runs = {k: [] for k in paths}
    for name in order:
        with Knobs(sp16, **paths[name]):
            runs[name].append(host_ms(lambda: sp16.sample(*feats16), 2))
    ms = r["decode_ms"] = {k: statistics.mean(v) for k, v in runs.items()}
    r["decode_runs_ms"] = runs
    log(f"[14b-c] {dt16} B={B} decode ms a batch ({b_['steps']} steps; host "
        f"clock, synced; turns {'-'.join(order)}, 2 decodes a turn): K1 "
        f"{ms['k1']:.2f}, torch loop {ms['loop']:.2f}, int8 loop "
        f"{ms['int8']:.2f}")

    # ---- 14e. the native host library -------------------------------------
    e_ = r["native"] = {}
    work = ROOT / "build" / "phase14"
    shutil.rmtree(work, ignore_errors=True)
    for what in ("build_cold_s", "build_warm_s"):
        t = time.perf_counter()
        bindings.build(work / "native")
        e_[what] = time.perf_counter() - t
    ex, disp = keep["extractor"], keep["dispatched"]
    recs = ex.finish(disp)
    boxes = np.stack([x["image_bb"] for x in recs])
    pad = recs[0]["image_adj_matrix"].shape[0]
    got = bindings.spatial_adjacency_batch(boxes, pad=pad)
    want = np.stack([spatial_adjacency(b, pad_to=pad) for b in boxes])
    if not np.array_equal(got, want) or not all(
            np.array_equal(x["image_adj_matrix"], w)
            for x, w in zip(recs, want)):
        raise AssertionError("14e: the native adjacency differs from numpy")
    e_["adjacency_boxes"] = list(boxes.shape)
    rng = np.random.default_rng(SEED)
    rows = rng.integers(0, 11, (GATHER_ROWS, pad, pad))
    path = work / "rows.bin"
    rows.tofile(path)
    mm = np.memmap(path, np.uint8, "r")
    perm = rng.permutation(GATHER_ROWS)
    rowbytes = pad * pad * 8
    starts = perm * rowbytes
    out = np.empty((GATHER_ROWS, rowbytes), np.uint8)
    out32 = np.empty((GATHER_ROWS, pad * pad), np.int32)
    bindings.gather_rows(mm.ctypes.data, starts, rowbytes, out)  # warm
    t = time.perf_counter()
    ref = np.stack([mm[s:s + rowbytes] for s in starts])
    e_["gather_numpy_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    bindings.gather_rows(mm.ctypes.data, starts, rowbytes, out)
    e_["gather_ms"] = (time.perf_counter() - t) * 1e3
    bindings.gather_rows_i64_i32(mm.ctypes.data, starts, pad * pad, out32)
    if not (np.array_equal(out, ref) and np.array_equal(
            out32, rows[perm].reshape(GATHER_ROWS, -1).astype(np.int32))):
        raise AssertionError("14e: the native gathers differ from numpy")
    del mm, ref, out
    gts, preds = keep["captions"]
    tok_gts = {}
    for ann in gts["annotations"]:
        tok_gts.setdefault(ann["image_id"], []).append(
            cap.ptb_tokenize(ann["caption"]))
    tok_res = {k: cap.ptb_tokenize(v) for k, v in preds.items()}

    def caption_scores():
        res = CocoCaptions(annotations={"annotations": [
            {"image_id": k, "caption": v, "id": k} for k, v in
            preds.items()]})
        t = time.perf_counter()
        s = CaptionEvaluator(CocoCaptions(annotations=gts), res).evaluate()
        secs = time.perf_counter() - t
        t = time.perf_counter()
        cap.bleu(tok_gts, tok_res)
        cap.rouge_l(tok_gts, tok_res)
        return s, secs, time.perf_counter() - t

    def assembly_ms():
        ts = []
        for _ in range(5):
            t = time.perf_counter()
            ex.finish(disp)
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts[1:])

    saved = cap._native, xp._native
    times = {"native": ([], [], []), "plain": ([], [], [])}
    scores = {}
    for how in ("native", "plain", "plain", "native"):   # in turns
        if how == "plain":
            cap._native = xp._native = lambda: None
        try:
            scores[how], secs, bleu_rouge_s = caption_scores()
            times[how][0].append(secs)
            times[how][1].append(assembly_ms())
            times[how][2].append(bleu_rouge_s)
        finally:
            cap._native, xp._native = saved
    nat_scores, py_scores = scores["native"], scores["plain"]
    e_["caption_s"], e_["caption_python_s"] = (
        statistics.mean(times[h][0]) for h in ("native", "plain"))
    e_["graph_assembly_ms"], e_["graph_assembly_numpy_ms"] = (
        statistics.mean(times[h][1]) for h in ("native", "plain"))
    e_["bleu_rouge_s"], e_["bleu_rouge_python_s"] = (
        statistics.mean(times[h][2]) for h in ("native", "plain"))
    e_["caption_tokens"] = sum(map(len, tok_res.values())) + sum(
        len(t) for refs in tok_gts.values() for t in refs)
    for k in ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "METEOR"):
        if abs(nat_scores[k] - py_scores[k]) > CAPTION_TOL:
            raise AssertionError(f"14e: {k} native {nat_scores[k]} vs "
                                 f"Python {py_scores[k]}")
    e_["captions"] = len(preds)
    shutil.rmtree(work, ignore_errors=True)
    r["seconds"] = time.perf_counter() - t_phase
    log(f"[14e] native: g++ build {e_['build_cold_s']:.2f} s cold, "
        f"{e_['build_warm_s']:.3f} s warm (hash hit); adjacency of "
        f"{boxes.shape[0]} x {boxes.shape[1]} boxes bit-equal to numpy")
    log(f"      host graph assembly, a batch of {len(recs)}: native "
        f"{e_['graph_assembly_ms']:.2f} ms, numpy "
        f"{e_['graph_assembly_numpy_ms']:.2f} ms (turns native-numpy-"
        f"numpy-native, each the median of 4)")
    log(f"      gather of {GATHER_ROWS} rows of {rowbytes} bytes: native "
        f"{e_['gather_ms']:.2f} ms, numpy {e_['gather_numpy_ms']:.2f} ms; "
        "both gathers byte-equal to numpy")
    log(f"      caption metrics of {len(preds)} answers (11a, "
        f"{e_['caption_tokens']} tokens with the references): native "
        f"{e_['caption_s']:.4f} s, Python {e_['caption_python_s']:.4f} s; "
        f"of which BLEU + ROUGE-L native {e_['bleu_rouge_s']:.4f} s, Python "
        f"{e_['bleu_rouge_python_s']:.4f} s (means of two turns); BLEU-1..4, "
        f"ROUGE-L, METEOR equal within {CAPTION_TOL}")
    log(f"     phase 14 took {r['seconds']:.1f} s")
    return k1


# ---- phase 15: the last modules of the port --------------------------------

def mode0_config(cfg):
    """`cfg` in the pixels-in mode0: both knobs set, the seed SEED."""
    return cfg.replace(data=cfg.data.replace(feature_mode="mode0"),
                       train=cfg.train.replace(setting="mode0", seed=SEED))


def mode0_images(size: int):
    """M0_POOL synthetic grayscale images [M0_POOL, size, size] in [0, 1)
    from the seed."""
    import numpy as np
    return np.random.default_rng(SEED).random((M0_POOL, size, size),
                                              dtype=np.float32)


def mode0_trainer(cfg, workdir: str, device: str, size: int):
    """A `Trainer` on the synthetic corpus in mode0, each dataset's
    `image_loader` reading the pool of `mode0_images(size)`."""
    from ekaid_torch.data.pipeline import synthetic_dataset
    from ekaid_torch.data.vocab import identity_vocab
    from ekaid_torch.train.train import Trainer
    pool = mode0_images(size)
    sets = []
    for split in ("train", "test"):
        ds = synthetic_dataset(cfg, split, n_pairs=512)
        ds.image_loader = lambda i: pool[i % len(pool)]
        sets.append(ds)
    return Trainer(cfg, workdir, sets[0], sets[1],
                   identity_vocab(cfg.speaker.vocab_size), device=device)


def startup_items(ds, n: int = STARTUP_ITEMS) -> list:
    """(pair index, question text) pairs the 15b answers are held on."""
    idxs = [int(i) for i in ds.split_idxs[:n]]
    texts = ["what has changed", "is there a change in the left lung", None,
             "w5 w9 what"]
    return [(i, texts[k % len(texts)]) for k, i in enumerate(idxs)]


def answer_digests(engine, items, coalesced=None) -> dict:
    """Each item's batch-1 decode (seq, and a digest of its logprobs and
    module weights) through `engine`, and the items' coalesced decode
    through `coalesced` (a CoalescingEngine) when given."""
    import hashlib

    def digest(out, rows):
        h = hashlib.sha256()
        for k in ("seq", "logprobs", "module_weights"):
            h.update(out[k][:rows].detach().cpu().contiguous().numpy()
                     .tobytes())
        return {"seq": out["seq"][:rows].cpu().numpy().tolist(),
                "sha": h.hexdigest()}

    qids = [engine.question_to_ids(q) if q else None for _, q in items]
    r = {"b1": []}
    for (idx, _), q in zip(items, qids):
        with engine._decode_lock:
            out = engine._decode1(engine.model, engine._batch_for(idx, q))
        r["b1"].append(digest(out, 1))
    if coalesced is not None:
        out = coalesced._decode_on(coalesced.devices[0],
                                   *coalesced._gather_rows(
                                       list(zip([i for i, _ in items],
                                                qids))))
        r["coalesced"] = digest(out, len(items))
    return r


def startup_child(mode: str, art_dir: str, build_dir: str, workdir: str,
                  cfg_json: str, size: str, device: str = "cuda") -> None:
    """15b, in a fresh interpreter: build the mode0 trainer of the config
    at `cfg_json` (images size^2) and serve its first answer, 'cold'
    (the kernels built by nvcc into the empty `build_dir`) or from the
    artifact at `art_dir` (`build_dir` empty too). Prints one JSON line:
    the wall clock at start and at the first answer, the nvcc processes
    started, the answers of `startup_items` (artifact only)."""
    t_start = time.time()
    nvcc_runs = []
    real_init = subprocess.Popen.__init__

    def watch(self, args, *a, **k):
        argv = [args] if isinstance(args, (str, bytes)) else list(args)
        if argv and "nvcc" in os.path.basename(str(argv[0])):
            nvcc_runs.append(" ".join(map(str, argv[:2])))
        return real_init(self, args, *a, **k)

    subprocess.Popen.__init__ = watch
    sys.path.insert(0, str(ROOT))
    from ekaid_torch import kernels
    from ekaid_torch.config import load_config
    kernels.BUILD = Path(build_dir)
    from ekaid_torch.serving.artifact import load_artifact
    from ekaid_torch.serving.engine import InferenceEngine
    from ekaid_torch.serving.server import CoalescingEngine
    with open(cfg_json) as f:
        cfg = load_config(overrides=json.load(f))
    tr = mode0_trainer(cfg, workdir, device, int(size))
    art = load_artifact(art_dir, device) if mode == "artifact" else None
    engine = InferenceEngine(tr, artifact=art)
    idx, text = startup_items(tr.eval_ds, 1)[0]
    first = engine.answer(text or "what has changed", idx)
    t_first = time.time()
    out = {"mode": mode, "t_start": t_start, "t_first": t_first,
           "first_answer": first["answer"], "nvcc_runs": nvcc_runs,
           "build_dir_files": sorted(os.listdir(build_dir))}
    if art is not None:
        co = CoalescingEngine(tr, coalesce_batch=max(
            art.meta["batch_sizes"]), artifact=art)
        out["answers"] = answer_digests(engine, startup_items(tr.eval_ds),
                                        co)
    print(json.dumps(out), flush=True)


def run_startup(mode: str, art_dir, build_dir, workdir, cfg_json,
                device: str = "cuda") -> dict:
    """`startup_child` in a fresh interpreter; its JSON line, with the
    seconds from the spawn to its first answer."""
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke;"
            " chip_smoke.startup_child(*sys.argv[2:])")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT), mode, str(art_dir),
         str(build_dir), str(workdir), str(cfg_json), str(M0_SIZE), device],
        capture_output=True,
        text=True, timeout=STARTUP_TIMEOUT_S, cwd=str(ROOT))
    if proc.returncode != 0:
        raise AssertionError(f"15b {mode} start failed ({proc.returncode}):"
                             f"\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    r["first_answer_s"] = r["t_first"] - t0
    r["interpreter_s"] = r["t_start"] - t0
    return r


def mode0_k5(model, b) -> dict:
    """15a's K5 check on the inference-cast mode0 `model` and the batch
    tensors `b`, its graphs dropped first: the first encode runs eagerly
    and launches K5 once per GroupNorm of each trunk call (two an
    encode; counted by the wrapper, and by `ekaid.gn.kernel` once a
    trunk call); the second is captured, and each of those launches is
    recorded into the graph; the third replays it (the wrapper counts
    nothing). The first and the third are traced: K5 at work and no
    RowwiseMomentsCUDAKernel. Returns the K5 launches on each path: the
    eager encode's and a replay's. (The trace's own count of K5 is
    recorded, not gated: the profiler may drop a few of an encode's
    ~2,000 kernel records.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ekaid_torch.models.detector import backbone
    from ekaid_torch.models.ekaid import EncodeGraphs
    from ekaid_torch.ops.group_norm import group_norm_kernel as k5
    from ekaid_torch.utils import observability as obs
    norms = sum(isinstance(m, backbone.GroupNorm)
                for m in model.change_detector.extractor.trunk.modules())

    def traced(fn):
        obs.reset_recorded()
        start = k5.launches
        torch.cuda.synchronize()
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        counts = obs.recorded()["counts"]
        obs.reset_recorded()
        return {"wrapper": k5.launches - start,
                "moments": sum("RowwiseMoments" in n for n in names),
                **{k: counts.get(f"ekaid.{k.replace('_', '.')}", 0)
                   for k in ("gn_kernel", "gn_plain", "encode_eager",
                             "encode_graph")},
                "traced": sum("group_norm_kernel" in n for n in names)}

    model.graphs = EncodeGraphs()
    eager = traced(lambda: model.encode(b))
    recorded = []

    def counting(*args, **kw):       # the trunk's calls of K5, captured
        recorded.append(torch.cuda.is_current_stream_capturing())
        return k5(*args, **kw)

    backbone.group_norm_kernel = counting
    try:
        model.encode(b)
    finally:
        backbone.group_norm_kernel = k5
    graphed = traced(lambda: model.encode(b))
    want_e = {"wrapper": 2 * norms, "moments": 0, "gn_kernel": 2,
              "gn_plain": 0, "encode_eager": 1, "encode_graph": 0}
    want_g = {"wrapper": 0, "moments": 0, "gn_kernel": 0, "gn_plain": 0,
              "encode_eager": 0, "encode_graph": 1}
    log(f"      K5 on the main path (R101, {norms} GroupNorms a trunk, two "
        f"trunks an encode): eager encode {eager}; captured "
        f"{sum(recorded)} of {len(recorded)} calls; replay {graphed}")
    if norms != 104 or recorded != [True] * (2 * norms) or any(
            {k: d[k] for k in want} != want or not d["traced"]
            for d, want in ((eager, want_e), (graphed, want_g))):
        raise AssertionError(f"15a: K5 on the main path: {norms} norms a "
                             f"trunk, eager {eager} (want {want_e}), "
                             f"captured {recorded}, replay {graphed} "
                             f"(want {want_g})")
    return {"mode0_eager_encode": eager["wrapper"],
            "mode0_graph_replay": len(recorded),
            "traced": [eager["traced"], graphed["traced"]]}


def mode0_phase(rec: dict, cfg, keep: dict, device: str = "cuda") -> int:
    """15a and 15b. Returns K1's launches on the path."""
    import shutil
    import torch
    from ekaid_torch.models import decoder
    from ekaid_torch.models import greedy_decode as gd
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.ops.group_norm import group_norm_kernel as k5
    from ekaid_torch.serving.artifact import save_artifact
    from ekaid_torch.serving.engine import InferenceEngine
    from ekaid_torch.serving.server import CoalescingEngine
    from ekaid_torch.utils.dtypes import F32
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    work = ROOT / "build" / "phase15"
    shutil.rmtree(work, ignore_errors=True)
    r = rec["mode0"] = {}
    cfg0 = mode0_config(cfg)
    cfg0 = cfg0.replace(train=cfg0.train.replace(
        max_iter=M0_TRAIN_STEPS, snapshot_interval=10 ** 9, log_interval=1))

    # ---- 15a. the main path: train, evaluate, serve, decode -------------
    t_phase = time.perf_counter()
    k1 = decoder.greedy_decode
    k1.launches = 0
    k5.launches = 0
    decodes = 0
    tr = mode0_trainer(cfg0, str(work / "trainer"), device, M0_SIZE)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tr.step_seconds = []
    tr.train()
    sync()
    if k5.launches:                  # gradients: the plain chain
        raise AssertionError(f"15a: the train steps launched K5 "
                             f"{k5.launches} times")
    from ekaid_torch.utils.logging import read_metrics
    losses = [m["train/total_loss"] for m in read_metrics(tr.workdir)
              if "train/total_loss" in m]
    r["train_step_ms"] = statistics.median(tr.step_seconds[1:]) * 1e3
    r["train_step_ms_all"] = [s * 1e3 for s in tr.step_seconds]
    r["train_pairs_per_s"] = M0_B / (r["train_step_ms"] / 1e3)
    r["train_peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                           if cuda else None)
    r["train_losses"] = losses
    if tr.state.step != M0_TRAIN_STEPS or len(losses) != M0_TRAIN_STEPS \
            or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"15a: {tr.state.step} steps, losses {losses}")
    scores, preds = tr.evaluate(max_batches=1)
    decodes += 1
    r["eval_answers"] = len(preds)
    engine = InferenceEngine(tr)                 # casts the model for eval
    decodes += 1
    m16 = engine.model
    ds = tr.train_ds
    batch = ds.sample_batch(ds.split_idxs[:M0_B])
    dev = m16.tensors(batch)
    out = m16.decode(dev)
    decodes += 1
    sync()
    t0 = time.perf_counter()
    for _ in range(M0_DECODE_REPS):
        out = m16.decode(dev)
        out["seq"].cpu()
    r["decode_pairs_per_s"] = M0_DECODE_REPS * M0_B / (
        time.perf_counter() - t0)
    decodes += M0_DECODE_REPS
    m16.encode(dev)
    sync()
    t0 = time.perf_counter()
    for _ in range(M0_DECODE_REPS):
        m16.encode(dev)
    sync()
    r["encode_b64_ms"] = (time.perf_counter() - t0) / M0_DECODE_REPS * 1e3
    idxs = tr.eval_ds.split_idxs
    lat = []
    for i in range(M0_ANSWERS):
        idx = int(idxs[i % len(idxs)])
        a = engine.answer(tr.vocab.decode(tr.eval_ds.questions[idx]), idx)
        lat.append(a["latency_ms"])
    decodes += M0_ANSWERS
    r["b1_latency_ms_median"] = statistics.median(lat)
    if tuple(out["seq"].shape) != (M0_B, cfg0.speaker.seq_length) or not \
            torch.isfinite(out["logprobs"].float()).all():
        raise AssertionError(f"15a: decode seq {tuple(out['seq'].shape)}")
    if tuple(out["att_bef"].shape) != (M0_B, 1, (M0_SIZE // 32) ** 2):
        raise AssertionError(f"15a: att_bef {tuple(out['att_bef'].shape)}")

    # ---- 15b. the serving artifact (its live decodes are on the path) ---
    art_dir = work / "artifact"
    items = startup_items(tr.eval_ds)
    t0 = time.perf_counter()
    save_artifact(str(art_dir), m16, {
        k: v for k, v in tr.eval_ds.sample(int(idxs[0])).items()
        if k != "pair_index"}, batch_sizes=(1, COALESCE))
    r["artifact_export_s"] = time.perf_counter() - t0
    r["artifact_mb"] = sum(f.stat().st_size for f in art_dir.iterdir()) / 1e6
    engine._wire = dict                          # the artifact's wire
    engine._dev_cache.clear()
    co = CoalescingEngine(tr, coalesce_batch=COALESCE)
    decodes += 3                                 # its three warm-ups
    co._wire = dict
    co._dev_cache.clear()
    live = answer_digests(engine, items, co)
    decodes += len(items) + 1
    sync()
    launches = k1.launches
    log(f"[15a] mode0 (pixels in, R101-GN, {M0_SIZE}^2, flagship widths, "
        f"bf16): {M0_TRAIN_STEPS} train steps at B={M0_B}, median "
        f"{r['train_step_ms']:.1f} ms ({r['train_pairs_per_s']:.1f} pairs "
        f"trained/s; all {['%.1f' % x for x in r['train_step_ms_all']]}), "
        f"peak {r['train_peak_gib']} GiB; eval of one batch; "
        f"encode+decode B={M0_B} {r['decode_pairs_per_s']:.1f} pairs/s "
        f"(encode {r['encode_b64_ms']:.2f} ms); batch-1 answer median "
        f"{r['b1_latency_ms_median']:.2f} ms over {M0_ANSWERS}; K1 launches "
        f"{launches} for {decodes} decodes")
    if launches != decodes:
        raise AssertionError(f"15: K1 launched {launches} times for "
                             f"{decodes} decodes")
    if cuda:
        r["k5_launches"] = mode0_k5(m16, dev)

    # gates, outside the count: bf16 step-0 tokens, then f32 card vs CPU
    if not torch.equal(plain_step0(m16, dev), out["seq"][:, 0]):
        raise AssertionError("15a: bf16 step-0 tokens differ from the plain "
                             "decode's")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    c32 = cfg0.replace(dtypes=cfg0.dtypes.replace(compute_dtype="float32"))
    rows = {k: v[:M0_GATE_ROWS] for k, v in batch.items()}
    ntoken = len(tr.vocab.word_to_idx)
    encs = {}
    for d in ("cpu", device):
        m = EkaidModel(c32, ntoken, policy=F32, device=d, seed=SEED)
        encs[d] = (m, m.encode(rows))
    m32, e32 = encs[device]
    gaps = {k: float((e32[k].cpu() - encs["cpu"][1][k]).abs().max()
                     / encs["cpu"][1][k].abs().max())
            for k in ("feat_bef", "feat_aft", "feat_diff", "att_bef",
                      "att_aft", "pred")}
    r["f32_encoder_gap"] = gaps
    if max(gaps.values()) > M0_ENC_RTOL:
        raise AssertionError(f"15a: f32 encoder card vs CPU {gaps}")
    sp = m32.speaker
    with torch.no_grad():
        w = gd.decode_weights(sp, sp.cfg, F32)
        fused, feats = sp._fused(e32["feat_bef"], e32["feat_diff"],
                                 e32["feat_aft"])
        ref = gd.greedy_decode_plain(w, sp.cfg, F32, fused, feats)
        got = k1(w, sp.cfg, F32, fused, feats)
    r["f32_k1_vs_plain"] = near_tie_agree(
        w, sp.cfg, F32, fused, feats, ref, got,
        rec.get("near_tie_tol", NEAR_TIE_FLOOR), "15a f32 K1")
    r["f32_k1_lp_err"] = float((got["logprobs"] - ref["logprobs"]).abs()
                               .max())
    log(f"      gates: bf16 step-0 tokens equal the plain decode's (B="
        f"{M0_B}); f32 (TF32 off) encoder card vs CPU on {M0_GATE_ROWS} "
        f"rows, of max|x|: " + ", ".join(f"{k} {v:.2e}"
                                         for k, v in gaps.items())
        + f" (gate {M0_ENC_RTOL}); K1 f32 vs plain on the card's encoder "
        f"output: rows differing {r['f32_k1_vs_plain']['rows_differ']} "
        f"(near-tie rule), logprobs err {r['f32_k1_lp_err']:.2e}")
    del encs, m32, e32

    # 15b: the cold start and the start from the artifact, fresh processes
    cfg_json = work / "cfg0.json"
    cfg0.to_json(str(cfg_json))
    cold = run_startup("cold", art_dir, work / "build_cold",
                       work / "cold", cfg_json, device)
    warm = run_startup("artifact", art_dir, work / "build_artifact",
                       work / "warm", cfg_json, device)
    r["startup"] = {k: {"first_answer_s": v["first_answer_s"],
                        "interpreter_s": v["interpreter_s"],
                        "nvcc_runs": len(v["nvcc_runs"])}
                    for k, v in (("cold", cold), ("artifact", warm))}
    if cuda and not cold["nvcc_runs"]:
        raise AssertionError("15b: the cold start ran no nvcc")
    if warm["nvcc_runs"] or warm["build_dir_files"]:
        raise AssertionError(f"15b: the artifact start ran nvcc "
                             f"{warm['nvcc_runs']} or built "
                             f"{warm['build_dir_files']}")
    # (a CPU rehearsal holds the tokens only: CPU reductions may round
    # differently in another process, with other buffer alignments)
    same = warm["answers"] == live if cuda else (
        [x["seq"] for x in warm["answers"]["b1"]] ==
        [x["seq"] for x in live["b1"]] and
        warm["answers"]["coalesced"]["seq"] == live["coalesced"]["seq"])
    if not same:
        raise AssertionError(f"15b: the artifact's answers differ from the "
                             f"live engine's on the same inputs: artifact "
                             f"{warm['answers']}, live {live}")
    log(f"[15b] artifact ({r['artifact_mb']:.1f} MB, exported in "
        f"{r['artifact_export_s']:.2f} s, batch sizes 1 and {COALESCE}): "
        f"seconds to the first answer in a fresh process: cold "
        f"{cold['first_answer_s']:.2f} s ({len(cold['nvcc_runs'])} nvcc "
        f"processes: {cold['nvcc_runs']}), from the artifact "
        f"{warm['first_answer_s']:.2f} s (no nvcc process, build dir "
        f"empty); its {len(items)} batch-1 answers and their coalesced "
        f"batch bit-equal to the live engine's (full-width wire on both)")
    r["phase_s"] = time.perf_counter() - t_phase
    shutil.rmtree(work, ignore_errors=True)
    return launches


def dp_phase(rec: dict, cfg, device: str = "cuda") -> tuple:
    """15c. Returns K1's and K2's launches on the path."""
    import shutil
    import socket
    import numpy as np
    import torch
    import torch.distributed as dist
    from ekaid_torch.data.synthetic import synthetic_batch
    from ekaid_torch.extract import runner
    from ekaid_torch.models import decoder
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.ops import roi_kernels as rk
    from ekaid_torch.parallel import mesh
    from ekaid_torch.train.step import Forward, init_state, train_step
    from ekaid_torch.train.train import build_synthetic_trainer
    from ekaid_torch.utils.dtypes import F32
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    work = ROOT / "build" / "phase15c"
    shutil.rmtree(work, ignore_errors=True)
    r = rec["dp"] = {}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(mesh.backend_for(device),
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        c32 = cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype="float32"))
        batch = synthetic_batch(c32, TRAIN_B, seed=SEED + 5)
        ntoken = c32.speaker.vocab_size - 1
        runs, steps = {}, {}
        for name in ("plain", "ddp"):
            grid = (mesh.make_mesh(c32.mesh, device) if name == "ddp"
                    else None)
            model = EkaidModel(c32, ntoken, policy=F32, device=device,
                               seed=SEED, mesh=grid)
            state = init_state(model, c32.train.optim)
            ddp = mesh.wrap(Forward(model), grid) if grid else None
            m = train_step(state, batch, SEED, c32.train.att_reg_weight,
                           train=False, ddp=ddp)
            runs[name] = (float(m["total_loss"]), {
                n: p.grad.detach().cpu() for n, p in model.named_parameters()
                if p.grad is not None})
            steps[name] = (state, ddp, [])
        for name in ("plain", "ddp", "ddp", "plain"):    # timed in turns
            state, ddp, secs = steps[name]
            sync()
            t0 = time.perf_counter()
            train_step(state, batch, SEED, c32.train.att_reg_weight,
                       train=False, ddp=ddp)
            sync()
            secs.append(time.perf_counter() - t0)
        gaps = _grad_gaps(runs["ddp"][1], runs["plain"][1])
        r["world1_step"] = {
            "loss_plain": runs["plain"][0], "loss_ddp": runs["ddp"][0],
            "grad_gap": max(gaps.values()),
            "bit_equal_tensors": sum(torch.equal(runs["ddp"][1][n], g)
                                     for n, g in runs["plain"][1].items()),
            "tensors": len(gaps),
            "step_ms_plain": [x * 1e3 for x in steps["plain"][2]],
            "step_ms_ddp": [x * 1e3 for x in steps["ddp"][2]]}
        del steps
        w_ = r["world1_step"]
        if abs(w_["loss_ddp"] - w_["loss_plain"]) > \
                TRAIN_LOSS_RTOL * abs(w_["loss_plain"]) or \
                set(runs["ddp"][1]) != set(runs["plain"][1]) or \
                w_["grad_gap"] > TRAIN_GRAD_TOL:
            raise AssertionError(f"15c: the DDP step differs from the plain "
                                 f"step: {w_}")
        # the trainer in DDP: two steps, a snapshot and an eval (K1)
        k1 = decoder.greedy_decode
        k1.launches = 0
        tcfg = cfg.replace(train=cfg.train.replace(
            seed=SEED, max_iter=2, snapshot_interval=2, log_interval=1))
        tr = build_synthetic_trainer(tcfg, str(work / "trainer"),
                                     device=device)
        if tr.ddp is None or tr.mesh.data != 1:
            raise AssertionError("15c: the trainer did not wrap DDP")
        tr.train(eval_fraction=1)
        sync()
        k1_launches = k1.launches
        if tr.state.step != 2 or k1_launches != 1:
            raise AssertionError(f"15c: DDP trainer steps {tr.state.step}, "
                                 f"K1 launches {k1_launches} (want 1)")
        del tr
    finally:
        dist.destroy_process_group()
    log(f"[15c] DDP at world size 1 ({mesh.backend_for(device)}, "
        f"in-process group): f32 step B={TRAIN_B} loss {w_['loss_ddp']:.7f} "
        f"vs plain {w_['loss_plain']:.7f}; gradients: largest gap "
        f"{w_['grad_gap']:.2e} of a tensor's max (gate {TRAIN_GRAD_TOL}), "
        f"{w_['bit_equal_tensors']} of {w_['tensors']} tensors bit-equal; "
        f"steps in turns (warm) DDP {['%.1f' % x for x in w_['step_ms_ddp']]}"
        f" ms, plain {['%.1f' % x for x in w_['step_ms_plain']]} ms; the "
        f"DDP trainer: 2 steps, a snapshot and an eval (K1 once)")

    # extraction: --dp 1 against --dp 0, then --dp 2 refused
    import contextlib
    import io
    import re
    rates, sinks = {}, {}
    rk.multilevel_roi_align_canvas.launches = 0
    with Patches() as p_:
        p_.set(runner, "H5Writer", RecordSink)
        for dp in ("0", "1"):
            RecordSink.made = []
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                runner.main(["--synthetic", str(DP_IMAGES), "--allow_random",
                             "--out", str(work / "graph.h5"), "--device",
                             device, "--dp", dp])
            sinks[dp] = RecordSink.made[0].records
            # the runner's own line: the whole run and its steady window
            m = re.search(r"at ([0-9.]+) img/s \(steady-state ([0-9.]+)",
                          said.getvalue())
            if m is None:
                raise AssertionError(f"15c: no rate in {said.getvalue()!r}")
            rates[dp] = (float(m.group(1)), float(m.group(2)))
    sync()
    k2 = rk.multilevel_roi_align_canvas.launches
    det = cfg.detector
    if k2 != 2 * 2 * DP_IMAGES // det.extract_batch_size:
        raise AssertionError(f"15c: K2 launches {k2}")
    if len(sinks["0"]) != DP_IMAGES or len(sinks["1"]) != DP_IMAGES:
        raise AssertionError("15c: records missing")
    for i, (a, b) in enumerate(zip(sinks["1"], sinks["0"])):
        for key in b:
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"15c: --dp 1 record {i} {key} differs "
                                     "from --dp 0's")
    try:
        runner.main(["--synthetic", str(DP_IMAGES), "--allow_random",
                     "--out", str(work / "graph.h5"), "--device", device,
                     "--dp", str(torch.cuda.device_count() + 1 if cuda
                                 else 2)])
    except SystemExit as e:
        refusal = str(e)
    else:
        raise AssertionError("15c: --dp above the visible devices ran")
    if "--dp" not in refusal:
        raise AssertionError(f"15c: the refusal does not name --dp: "
                             f"{refusal}")
    r["extract"] = {f"dp{k}_images_per_s": v for k, v in rates.items()}
    r["extract"]["k2_launches"] = k2
    r["extract"]["refusal"] = refusal
    log(f"[15c] extraction runner --dp 1 records bit-equal to --dp 0's "
        f"({DP_IMAGES} images at {det.image_size}^2, batch "
        f"{det.extract_batch_size}): images/s over the run (steady window "
        f"past the first batch) --dp 1 {rates['1'][0]:.2f} "
        f"({rates['1'][1]:.2f}), --dp 0 {rates['0'][0]:.2f} "
        f"({rates['0'][1]:.2f}) (the runner's own host clock); K2 launches "
        f"{k2}; refused: {refusal!r}")
    shutil.rmtree(work, ignore_errors=True)
    return k1_launches, k2


def native_match_phase(rec: dict, keep: dict) -> None:
    """15d: the native `match_disease` and `exact_match` against their
    plain versions on phase 8's dispatched extraction batch and phase
    11a's answers."""
    import numpy as np
    from ekaid_torch.extract import pipeline as xp
    from ekaid_torch.native import bindings
    ana_d, dis_d = keep["dispatched"]
    ana = {k: xp._host(v) for k, v in ana_d.items()}
    dis = {k: xp._host(v) for k, v in dis_d.items()}
    n_img = dis["boxes"].shape[0]
    bindings.load()                       # built or loaded before timing
    t_nat = t_py = 0.0
    assigned = {}
    # the detections as the detector marked them; every one of them
    # counted; and, since untrained detectors find little, the next
    # image's anatomy boxes taken as the detections
    cases = (("as_detected", dis["boxes"], dis["valid"]),
             ("all_valid", dis["boxes"], np.ones_like(dis["valid"])),
             ("next_anatomy", np.roll(ana["boxes"], -1, axis=0),
              np.ones(ana["boxes"].shape[:2], bool)))
    for case, boxes, valid in cases:
        assigned[case] = 0
        n_dis = boxes.shape[1]
        for b in range(n_img):
            t = time.perf_counter()
            got = bindings.match_disease(boxes[b], valid[b],
                                         ana["boxes"][b])
            t_nat += time.perf_counter() - t
            t = time.perf_counter()
            _, cls = xp.match_disease_to_anatomy(
                boxes[b], np.arange(n_dis, dtype=np.float32)[:, None],
                np.arange(n_dis), valid[b].astype(bool), ana["boxes"][b],
                n_dis)
            t_py += time.perf_counter() - t
            want = np.where(cls >= n_dis, -1, cls)
            if not np.array_equal(got, want):
                raise AssertionError(f"15d: match_disease ({case}) image "
                                     f"{b} differs")
            assigned[case] += int((got >= 0).sum())
    gts, preds = keep["captions"]
    first_gt = {}
    for ann in gts["annotations"]:
        first_gt.setdefault(str(ann["image_id"]), ann["caption"])
    words = {}
    keys = sorted(preds)
    rows = [(preds[k].split(), first_gt[k].split()) for k in keys]
    T = max(max(len(a), len(b)) for a, b in rows) + 1
    seq = np.zeros((len(rows), T), np.int32)
    gt = np.zeros((len(rows), T), np.int32)
    for i, (a, b) in enumerate(rows):
        seq[i, :len(a)] = [words.setdefault(w, len(words) + 1) for w in a]
        gt[i, :len(b)] = [words.setdefault(w, len(words) + 1) for w in b]
    got = bindings.exact_match(seq, gt)
    want = np.array([preds[k].split() == first_gt[k].split() for k in keys],
                    np.uint8)
    if not np.array_equal(got, want):
        raise AssertionError("15d: exact_match differs from the plain "
                             "comparison")
    rec["native_match"] = {
        "images": n_img, "assigned": assigned,
        "match_native_ms": t_nat * 1e3, "match_python_ms": t_py * 1e3,
        "answers": len(rows), "exact": int(got.sum())}
    log(f"[15d] native match_disease equal to match_disease_to_anatomy on "
        f"phase 8's batch ({n_img} images x {dis['boxes'].shape[1]} "
        f"detections; anatomy boxes assigned {assigned['as_detected']} as "
        f"detected, {assigned['all_valid']} with every detection valid, "
        f"{assigned['next_anatomy']} with the next image's anatomy boxes "
        f"as the detections; {t_nat * 1e3:.3f} ms native, "
        f"{t_py * 1e3:.3f} ms Python, the three cases); exact_match equal "
        f"to the plain "
        f"comparison on phase 11a's {len(rows)} answers ({int(got.sum())} "
        f"exact)")


def mesh_child(rank: str, world: str, work: str, lib: str,
               device: str = "cuda") -> None:
    """16, one rank in a fresh interpreter: joins the gloo group of
    `world` ranks through a `file://` rendezvous in `work`, all on
    cuda:0 (or the CPU), loads K1's library that phase 2 built (no
    nvcc), and places itself on the data axis. Then, at f32 and at
    bf16, the eval decode of the eval batch (its block through K1); at
    f32 also one DDP train step with dropout off on its rows r::data of
    the global batch, whose gradients and parameters rank 0 writes to
    work/full.pt. Writes its results to work/rank<rank>.pt."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from ekaid_torch import kernels
    from ekaid_torch.config import load_config
    from ekaid_torch.models import greedy_decode as gd
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.parallel import mesh
    from ekaid_torch.train.step import Forward, init_state, train_step
    from ekaid_torch.utils.dtypes import Policy
    rank, world, work = int(rank), int(world), Path(work)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        kernels.load_prebuilt("greedy_decode", lib)
    d = torch.load(work / "inputs.pt", weights_only=False)
    dist.init_process_group(
        "gloo", init_method=f"file://{work / 'rendezvous'}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        cfg = load_config(overrides=d["cfg"])
        grid = mesh.make_mesh(cfg.mesh, device)
        out = {"grid": (grid.rank, grid.data)}
        for dt in ("float32", "bfloat16"):
            c = cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype=dt))
            model = EkaidModel(c, d["ntoken"], policy=Policy.from_config(
                c.dtypes), device=device, seed=SEED, mesh=grid)
            gd.greedy_decode.launches = 0
            o = model.decode(d["eval_batch"])
            if cuda:
                torch.cuda.synchronize()
            out[dt] = {"launches": gd.greedy_decode.launches,
                       "eval": {k: o[k].cpu() for k in (
                           "seq", "logprobs", "module_weights")}}
            if dt == "float32":
                state = init_state(model, c.train.optim)
                part = {k: v[grid.rank::grid.data]
                        for k, v in d["batch"].items()}
                m = train_step(state, part, SEED, c.train.att_reg_weight,
                               train=False,
                               ddp=mesh.wrap(Forward(model), grid))
                params = dict(model.named_parameters())
                out[dt]["loss"] = float(m["total_loss"])
                out[dt]["sums"] = torch.stack([
                    p.detach().double().sum().cpu() for p in params.values()])
                if rank == 0:
                    torch.save({
                        "grads": {n: (p.grad if p.grad is not None else
                                      torch.zeros_like(p)).detach().cpu()
                                  for n, p in params.items()},
                        "params": {n: p.detach().cpu()
                                   for n, p in params.items()}},
                        work / "full.pt")
                del state, params
            del model
            if cuda:
                torch.cuda.empty_cache()
        torch.save(out, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _children(fn: str, args: list, n: int, timeout: float,
              logs: Path) -> list:
    """n fresh interpreters running chip_smoke.<fn>(rank, n, *args),
    waited for together, their output in files under `logs`; (return
    code, stdout, stderr) of each (a child still running at the timeout
    is killed: -9)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke;"
            f" chip_smoke.{fn}(*sys.argv[2:])")
    files = [(open(logs / f"{fn}{r}.out", "w+"),
              open(logs / f"{fn}{r}.err", "w+")) for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT), str(r), str(n),
         *map(str, args)], stdout=o, stderr=e, text=True, cwd=str(ROOT))
        for r, (o, e) in enumerate(files)]
    t_end, res = time.time() + timeout, []
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, t_end - time.time()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for p, (o, e) in zip(procs, files):
            o.seek(0)
            e.seek(0)
            res.append((p.returncode, o.read(), e.read()))
            o.close()
            e.close()
    return res


def mesh_phase(rec: dict, cfg, device: str = "cuda") -> int:
    """Phase 16: the data axis, a DDP train step and the data-sharded
    eval. Returns K1's launches on the path (each rank's eval
    decodes)."""
    import shutil
    import torch
    from ekaid_torch import kernels
    from ekaid_torch.data.synthetic import synthetic_batch
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.models.greedy_decode import greedy_decode_plain
    from ekaid_torch.train.step import init_state, train_step
    from ekaid_torch.utils.dtypes import Policy
    cuda = device == "cuda"
    t_phase = time.perf_counter()
    work = ROOT / "build" / "phase16"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    r = rec["mesh"] = {"data": MESH_DATA, "backend": "gloo"}
    world = MESH_DATA
    mcfg = cfg.replace(mesh=cfg.mesh.replace(data=MESH_DATA))
    c32 = cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype="float32"))
    ntoken = cfg.speaker.vocab_size - 1
    inputs = {"cfg": mcfg.to_dict(), "ntoken": ntoken,
              "batch": synthetic_batch(c32, TRAIN_B, seed=SEED + 5),
              "eval_batch": synthetic_batch(cfg, MESH_EVAL_B, seed=SEED + 6)}
    torch.save(inputs, work / "inputs.pt")

    # the one-process references on this card; the step takes the ranks'
    # rows as its microbatches (rows i::MESH_DATA), so its products run
    # at the ranks' shapes
    sp = cfg.speaker
    one = {}
    for dt in ("float32", "bfloat16"):
        c = cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype=dt))
        pol = Policy.from_config(c.dtypes)
        model = EkaidModel(c, ntoken, policy=pol, device=device, seed=SEED)
        o = model.decode(inputs["eval_batch"])
        w = model.speaker.decode_weights()
        fused, feats = model.speaker._fused(o["feat_bef"], o["feat_diff"],
                                            o["feat_aft"])
        one[dt] = {"k1": o, "w": w, "fused": fused, "feats": feats,
                   "policy": pol,
                   "plain": greedy_decode_plain(w, sp, pol, fused, feats)}
        if dt == "float32":
            state = init_state(model, c.train.optim)
            m = train_step(state, inputs["batch"], SEED,
                           c.train.att_reg_weight, train=False,
                           accum_steps=MESH_DATA)
            one["loss"] = float(m["total_loss"])
            one["grads"] = {n: p.grad.detach().cpu() if p.grad is not None
                            else torch.zeros(p.shape)
                            for n, p in model.named_parameters()}
            one["params"] = {n: p.detach().cpu()
                             for n, p in model.named_parameters()}
            del state
        del model
    if cuda:
        torch.cuda.empty_cache()

    # the ranks
    lib = kernels.load("greedy_decode")._name if cuda else ""
    t0 = time.perf_counter()
    res = _children("mesh_child", [work, lib, device], world,
                    MESH_TIMEOUT_S, work)
    r["children_s"] = time.perf_counter() - t0
    for i, (rc, o, e) in enumerate(res):
        if rc != 0:
            raise AssertionError(f"16: rank {i} failed ({rc}):\n{o[-2000:]}"
                                 f"\n{e[-3000:]}")
    ranks = [torch.load(work / f"rank{i}.pt", weights_only=False)
             for i in range(world)]
    full = torch.load(work / "full.pt", weights_only=False)
    for i, rk in enumerate(ranks):
        if rk["grid"] != (i, MESH_DATA):
            raise AssertionError(f"16: rank {i} sits at {rk['grid']}")

    # 16a: the DDP step
    for i, rk in enumerate(ranks):
        if not torch.equal(rk["float32"]["sums"], ranks[0]["float32"]["sums"]):
            raise AssertionError(f"16a: rank {i}'s updated parameters differ "
                                 "from rank 0's")
    losses = [rk["float32"]["loss"] for rk in ranks]
    gaps = _grad_gaps(full["grads"], one["grads"])
    # Adam's first step moves an element by lr g / (|g| + eps): where g
    # is at the size of the two steps' gradient gap it may step either
    # way, so the bar holds on the elements above the gap (10a's rule)
    # and every element stays within 2 lr
    optim = cfg.train.optim
    p_err, checked, over, worst_all = {}, 0, 0, 0.0
    for n, p in one["params"].items():
        got, g = full["params"][n].float(), one["grads"][n]
        gap = float((full["grads"][n] - g).abs().max())
        strong = (g.abs() > UPDATE_SIGNAL * gap) & (
            g.abs() > 1e3 * optim.epsilon)
        diff = (got - p).abs()
        excess = diff - (MESH_PARAM_ATOL + MESH_PARAM_RTOL * p.abs())
        checked += int(strong.sum())
        over += int((excess > 0).sum())
        worst_all = max(worst_all, float(diff.max()))
        p_err[n] = float(excess[strong].max()) if strong.any() else -1.0
    elems = sum(p.numel() for p in one["params"].values())
    step = r["step"] = {
        "loss_ddp": losses, "loss_one": one["loss"],
        "grad_gap": max(gaps.values()),
        "grad_gap_tensor": max(gaps, key=gaps.get),
        "param_excess": max(p_err.values()),
        "param_checked_share": checked / elems,
        "param_over_bar_all": over, "param_gap_max_lr": worst_all / optim.lr,
        "elems": elems}
    if any(abs(x - one["loss"]) > TRAIN_LOSS_RTOL * abs(one["loss"])
           for x in losses):
        raise AssertionError(f"16a: DDP loss {losses} vs one process "
                             f"{one['loss']}")
    if set(gaps) != set(one["params"]) or step["grad_gap"] > TRAIN_GRAD_TOL:
        raise AssertionError(f"16a: gradient gap {step['grad_gap']} in "
                             f"{step['grad_gap_tensor']} > {TRAIN_GRAD_TOL}")
    if step["param_excess"] > 0 or \
            step["param_checked_share"] < UPDATE_MIN_SHARE or \
            step["param_gap_max_lr"] > 2.0:
        bad = max(p_err, key=p_err.get)
        raise AssertionError(f"16a: updated parameters off the one-process "
                             f"step: {bad} past {MESH_PARAM_RTOL} rel + "
                             f"{MESH_PARAM_ATOL} abs above the gradient gap, "
                             f"or too few held: {step}")
    log(f"[16a] data axis of {world} (gloo, {world} processes on one "
        f"{'card' if cuda else 'CPU'}): f32 DDP step B={TRAIN_B} loss "
        f"{losses[0]:.7f} vs one process on the ranks' rows as {world} "
        f"microbatches {one['loss']:.7f}; largest "
        f"gradient gap {step['grad_gap']:.2e} of a tensor's max "
        f"({step['grad_gap_tensor']}; gate {TRAIN_GRAD_TOL}); Adam updates "
        f"within {MESH_PARAM_RTOL} rel + {MESH_PARAM_ATOL} abs on the "
        f"{step['param_checked_share']:.4f} of the elements whose gradient "
        f"stands {UPDATE_SIGNAL:g}x above the gap (past the bar anywhere: "
        f"{step['param_over_bar_all']} elements, at most "
        f"{step['param_gap_max_lr']:.3f} lr apart), ranks equal")

    # 16b: the data-sharded eval through K1
    launches = 0
    for dt in ("float32", "bfloat16"):
        ref = one[dt]
        outs = [rk[dt]["eval"] for rk in ranks]
        for i, (rk, o) in enumerate(zip(ranks, outs)):
            if cuda and rk[dt]["launches"] != 1:
                raise AssertionError(f"16b {dt}: rank {i} launched K1 "
                                     f"{rk[dt]['launches']} times (want 1)")
            if tuple(o["seq"].shape) != (MESH_EVAL_B, sp.seq_length) or not \
                    torch.isfinite(o["logprobs"]).all():
                raise AssertionError(f"16b {dt}: rank {i}'s decode")
            if not all(torch.equal(o[k], outs[0][k]) for k in o):
                raise AssertionError(f"16b {dt}: rank {i}'s gathered decode "
                                     "differs from rank 0's")
            launches += rk[dt]["launches"]
        got = {k: v.to(ref["k1"]["seq"].device) for k, v in outs[0].items()}
        e = r[f"eval_{dt}"] = {
            "token_share": (got["seq"] == ref["k1"]["seq"]).float().mean()
            .item(),
            "rows_equal": int((got["seq"] == ref["k1"]["seq"]).all(1).sum()),
            "step0_lp_gap": (got["logprobs"][:, 0]
                             - ref["k1"]["logprobs"][:, 0]).abs().max().item(),
            "prefix_lp_err": prefix_lp_err(got, ref["k1"])}
        if dt == "float32":
            e["near_tie"] = near_tie_agree(
                ref["w"], sp, ref["policy"], ref["fused"], ref["feats"],
                ref["plain"], got, rec.get("near_tie_tol", NEAR_TIE_FLOOR),
                "16b f32 eval")
            if e["prefix_lp_err"] > MESH_LP_GATE:
                raise AssertionError(f"16b f32: logprobs of the equal prefix "
                                     f"{e['prefix_lp_err']} > {MESH_LP_GATE}")
        else:
            # step 0: equal tokens, except where the one-process plain
            # version's two best step-0 logprobs are within the bf16 bar
            diff = (got["seq"][:, 0] != ref["k1"]["seq"][:, 0]).cpu()
            if diff.any():
                lg = greedy_decode_plain(
                    ref["w"], sp.replace(seq_length=1), ref["policy"],
                    ref["fused"], ref["feats"], scratch=True)["logits"]
                gap = top2_gap(lg, 0).cpu()
                e["step0_differ"] = [(int(i), float(gap[i]))
                                     for i in diff.nonzero()[:, 0]]
                if (gap[diff] >= BF16_STEP0_GAP).any():
                    raise AssertionError(f"16b bf16: step-0 tokens differ "
                                         f"off a near-tie: "
                                         f"{e['step0_differ']}")
        log(f"[16b] eval {dt} B={MESH_EVAL_B}, "
            f"{MESH_EVAL_B // MESH_DATA} rows a rank, K1 once on each of "
            f"the {world} ranks, gathered: "
            f"token share vs one process {e['token_share']:.4f}, rows equal "
            f"{e['rows_equal']}/{MESH_EVAL_B}, step-0 logprob gap "
            f"{e['step0_lp_gap']:.2e}, equal prefix logprobs "
            f"{e['prefix_lp_err']:.2e}"
            + (f" (gate {MESH_LP_GATE}; near-tie rows "
               f"{e['near_tie']['rows_differ']})" if dt == "float32" else
               " (gate: step-0 tokens up to a near-tie)"))

    shutil.rmtree(work, ignore_errors=True)
    r["phase_s"] = time.perf_counter() - t_phase
    log(f"[16] {r['phase_s']:.1f} s")
    return launches


def trunk_gn_shapes(size: int, depths) -> list:
    """(H, W, C, epilogue) of each GroupNorm of a `ResNet` of `depths`
    over size^2 images, in the order it runs them (epilogue 'relu',
    'none' or 'residual'): read by hooks from the real trunk, run on the
    meta device."""
    import torch
    from ekaid_torch.models.detector.backbone import GroupNorm, ResNet
    from ekaid_torch.utils.dtypes import F32
    seen = []

    def hook(mod, args, kw):
        x = args[0]
        epi = ("residual" if kw.get("residual") is not None
               else "relu" if kw.get("relu") else "none")
        seen.append((*x.shape[2:], x.shape[1], epi))

    with torch.device("meta"):
        m = ResNet(3, depths=depths, policy=F32)
    for mod in m.modules():
        if isinstance(mod, GroupNorm):
            mod.register_forward_pre_hook(hook, with_kwargs=True)
    with torch.no_grad():
        m(torch.zeros(1, 3, size, size, device="meta"))
    return seen


def gn_phase(rec: dict) -> None:
    """17. K5 at mode0's GroupNorm shapes: checks and times."""
    import torch
    from ekaid_torch.models.change_detector import R101
    from ekaid_torch.models.detector.backbone import GN_EPS, GN_GROUPS
    from ekaid_torch.ops import group_norm as gn
    r = rec["group_norm"] = {"shapes": []}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    norms = trunk_gn_shapes(M0_SIZE, R101)
    kinds = {"relu": (True, False), "none": (False, False),
             "residual": (True, True)}
    cases = {}

    def ulp(v):
        # at no less than 2^-8: the statistics agree to f32 rounding,
        # which moves an output cancelled to ~1e-6 past its own ulp
        e = torch.frexp(v.float().abs().clamp_min(2.0 ** -8))[1]
        return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)

    for key in dict.fromkeys(norms):
        h, w, c, epi = key
        x = (3 * torch.randn(M0_B, c, h, w, generator=gen, device=dev)
             + torch.randn(1, c, 1, 1, generator=gen, device=dev))
        res = torch.randn(M0_B, c, h, w, generator=gen, device=dev)
        cl = torch.channels_last
        x = x.to(torch.bfloat16).contiguous(memory_format=cl)
        res = res.to(torch.bfloat16).contiguous(memory_format=cl)
        s = (1 + 0.3 * torch.randn(c, generator=gen, device=dev)).bfloat16()
        b = (0.3 * torch.randn(c, generator=gen, device=dev)).bfloat16()
        relu, with_res = kinds[epi]
        args = (x, s, b, GN_GROUPS, GN_EPS)
        rr = res if with_res else None
        cases[key] = (args, relu, rr)
        got = gn.group_norm_kernel(*args, relu, rr)
        want = gn.group_norm_plain(*args, torch.bfloat16, relu, rr)
        y = gn.group_norm_plain(*args, torch.bfloat16)
        tol = ulp(y) + (ulp(want) if with_res else 0)
        gap = (got.float() - want.float()).abs()
        equal = (got == want).float().mean().item()
        what = f"17: {h}x{w}x{c} {epi}"
        if not (gap <= tol).all():
            raise AssertionError(f"{what}: K5 {(gap - tol).max().item()} "
                                 "past one bf16 ulp of the plain chain")
        if equal < GN_EQUAL_SHARE:
            raise AssertionError(f"{what}: {equal:.6f} of K5's outputs "
                                 "bit-equal to the plain chain")
        kernel_ms = graph_ms(lambda: gn.group_norm_kernel(*args, relu, rr),
                             GN_REPS[0])
        plain_ms = graph_ms(lambda: gn.group_norm_plain(
            *args, torch.bfloat16, relu, rr).contiguous(memory_format=cl),
            GN_REPS[1])
        nbytes = gn.norm_bytes(M0_B, h * w, c, with_res)
        pl = gn.plan(M0_B, h * w, c, GN_GROUPS, gn._sms(0))
        r["shapes"].append({
            "shape": [h, w, c], "epilogue": epi, "per_trunk":
            norms.count(key), "equal_share": equal,
            "kernel_us": kernel_ms * 1e3, "plain_us": plain_ms * 1e3,
            "bound_us": nbytes / HBM_BYTES_PER_S * 1e6, "bytes": nbytes,
            "plan": [pl.blocks, pl.split, pl.threads, int(pl.cached)]})
    shapes = r["shapes"]
    for k in ("kernel_us", "plain_us", "bound_us"):
        r[k.replace("_us", "_ms_batch")] = 2 * sum(
            e[k] * e["per_trunk"] for e in shapes) / 1e3
    def trunk():                       # one trunk's launches, in order
        for key in norms:
            args, relu, rr = cases[key]
            gn.group_norm_kernel(*args, relu, rr)

    r["graph_trunk_ms"] = graph_ms(trunk, 1)
    r["graph_ms_batch"] = 2 * r["graph_trunk_ms"]
    # the wrapper's host time a call (checks, plan, output, launch)
    args, relu, rr = cases[norms[-1]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        gn.group_norm_kernel(*args, relu, rr)
    r["host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    log(f"[17] K5 at mode0's GroupNorm shapes (B={M0_B}, {M0_SIZE}^2, "
        f"bf16), us a launch: kernel / plain chain / bound from bytes "
        f"(blocks, split, threads, cached); every shape within one ulp, "
        f"bit-equal share >= {GN_EQUAL_SHARE}")
    for e in shapes:
        log(f"    {'x'.join(map(str, e['shape'])):>12} {e['epilogue']:>8} "
            f"x{e['per_trunk']:<2}: {e['kernel_us']:8.2f} / "
            f"{e['plain_us']:8.2f} / {e['bound_us']:7.2f} {e['plan']} "
            f"equal {e['equal_share']:.5f}")
    log(f"    the wrapper's host time a call {r['host_us']:.1f} us")
    log(f"    a batch (2 trunks x {len(norms)}): kernel "
        f"{r['kernel_ms_batch']:.3f} ms (graph of one trunk's launches "
        f"{r['graph_trunk_ms']:.3f} ms, x2 {r['graph_ms_batch']:.3f}), "
        f"plain chain {r['plain_ms_batch']:.3f} ms, bound "
        f"{r['bound_ms_batch']:.3f} ms")


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
    from ekaid_torch.train.train import build_synthetic_trainer
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
    _, batch, fused16, feats16, w16, out16 = k1_phase(rec, cfg)

    # ---- 4. main path ----------------------------------------------------
    # the synthetic trainer's model is phase 3's bf16 model: the same
    # config, vocab and seed
    tr4 = build_synthetic_trainer(
        cfg.replace(train=cfg.train.replace(seed=SEED)),
        str(ROOT / "build" / "engine_phase"), device="cuda")
    greedy_decode.launches = 0
    engine = InferenceEngine(tr4)
    m16 = engine.model
    decodes = 1                              # the engine's warm-up answer
    idxs = engine.ds.split_idxs
    texts = [engine.vocab.decode(engine.ds.questions[int(i)])
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
        raise AssertionError("main path batch-64 decode (the trainer's "
                             "model) differs from the same decode in "
                             "phase 3")
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
    keep = {}                                # phase 14's inputs
    kernels_line += extraction(rec, keep=keep)
    kernels_line.append(nms_phase(rec, cfg))

    # ---- 10. the training path, whose in-training evals run K1 -----------
    kernels_line[0]["launches"] += train_phase(rec, cfg)

    # ---- 11. the inference entry points on phase 10's snapshots ----------
    k1, k2 = inference_phase(rec, cfg, keep=keep)
    kernels_line[0]["launches"] += k1
    k2_entry = next(k for k in kernels_line
                    if k["name"] == "roi_align_canvas")
    k2_entry["launches"] += k2
    import shutil
    shutil.rmtree(ROOT / "build" / "train_phase", ignore_errors=True)

    # ---- 12. the detector's training path, whose evals run K2 ------------
    k2_entry["launches"] += detector_train_phase(rec, cfg)

    # ---- 13. from raw files to answers: K2 in the detector evals and
    # extraction, K1 in the VQA evals, the test stage and the ask tool ----
    torch.cuda.empty_cache()
    k1, k2 = raw_files_phase(rec, cfg)
    kernels_line[0]["launches"] += k1
    k2_entry["launches"] += k2

    # ---- 14. the eval knobs and the native host library: K1 in the
    # batch-1 answers with pair_batch off and on ---------------------------
    kernels_line[0]["launches"] += knobs_phase(rec, cfg, m16, batch, engine,
                                               keep)

    # ---- 15. the last modules: mode0 (K1 in its evals, answers and
    # decodes), the serving artifact, DDP (K1 in the DDP trainer's eval)
    # and --dp extraction (K2), the native matching ------------------------
    t15 = time.perf_counter()
    del engine, m16
    torch.cuda.empty_cache()
    from ekaid_torch.ops.group_norm import group_norm_kernel
    k5_earlier = group_norm_kernel.launches      # phases 1-14, all eager
    kernels_line[0]["launches"] += mode0_phase(rec, cfg, keep)
    torch.cuda.empty_cache()
    k1, k2 = dp_phase(rec, cfg)
    kernels_line[0]["launches"] += k1
    k2_entry["launches"] += k2
    native_match_phase(rec, keep)
    rec["phase15_s"] = time.perf_counter() - t15
    log(f"[15] {rec['phase15_s']:.1f} s")

    # ---- 16. the data axis: two ranks on the card in a gloo group, a
    # DDP train step and the data-sharded eval through K1 on each rank --
    torch.cuda.empty_cache()
    kernels_line[0]["launches"] += mesh_phase(rec, cfg)

    # ---- 17. the trunk's GroupNorm (K5) at mode0's shapes ------------------
    torch.cuda.empty_cache()
    gn_phase(rec)
    g = rec["group_norm"]
    k5_paths = {"earlier_phases_eager": k5_earlier,
                **{k: v for k, v in rec["mode0"]["k5_launches"].items()
                   if k != "traced"}}
    kernels_line.append({
        "name": "group_norm", "route": "cuda",
        "source": "ekaid_torch/csrc/group_norm.cu", "replaces": None,
        "launches": sum(k5_paths.values()), "launches_by_path": k5_paths,
        "ms": g["kernel_ms_batch"], "plain_ms": g["plain_ms_batch"],
        "bound_ms": g["bound_ms_batch"], "bound_by": "bytes",
        "library_ms": None})
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
