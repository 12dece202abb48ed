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
     forced early exit, decoding constraint), then bf16 (finite, step 0
     equal tokens and a small logprob gap; agreement measured);
  4. the main path: an `EkaidModel` at flagship width under the bf16
     policy behind the batch-1 `InferenceEngine`, answering questions
     over the synthetic pair store, then one batch-64 decode; the
     kernel's launch count must equal the number of decodes, and each
     answer is held against the plain version on the same inputs;
  5. timings of the kernel, its plain version, its bound, the batch-64
     decode and the batch-1 answer.
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
    from ekaid_torch.data.synthetic import synthetic_batch
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.models.greedy_decode import (greedy_decode,
                                                  greedy_decode_plain)
    from ekaid_torch.serving.engine import InferenceEngine
    from ekaid_torch.utils.dtypes import BF16, F32

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
    rec["bf16"] = {}
    for b in BATCHES:
        f, x = fused16[:b].contiguous(), feats16[:b].contiguous()
        ref16 = greedy_decode_plain(w16, sp, BF16, f, x)
        out = greedy_decode(w16, sp, BF16, f, x)
        if b == B:
            out16 = out
        r = rec["bf16"][b] = bf16_agreement(ref16, out, f"bf16 kernel B={b}")
        log(f"  bf16 B={b}: equal tokens {r['token_share']:.4f}, step-0 "
            f"logprob gap {r['step0_lp_gap']:.3g}, steps "
            f"{steps_run(out['seq'])} (hard checks: finite, step-0 tokens "
            f"equal, step-0 gap <= {BF16_STEP0_GAP})")

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

    kline = {"kernels": [{
        "name": "greedy_decode", "route": "cuda",
        "source": "ekaid_torch/csrc/greedy_decode.cu",
        "replaces": "ekaid_tpu/models/pallas_decode.py:70",
        "launches": launches, "max_abs_err": rec["f32_max_abs_err"],
        "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": None}]}
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
