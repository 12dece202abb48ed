"""The batched eval driver with the LM answer decoder (the configuration's
`decoder` 'lm'): `Trainer.evaluate` over a corpus split into slices of
`batches_per_call` x batch rows, walked slice by slice, as
`drivers/eval.py` walks it, through the mode2 change encoder and the
DeepSeek-V2 decoder behind its projector.

Weights. The change encoder's come from the seed by the EKAID
reference's rules (`Ctx.weights`); the LM's and the projector's by
`lm_weight`: each matrix and table N(0, initializer_range 0.02) from a
generator on the device seeded by the run's seed and the parameter's
name, rounded to bf16 (the dtype the program holds them in), norms 1,
biases 0, and EOS's row of lm_head zeroed, so that its logit, 0, never
wins against the other 102,399 and every answer runs to the cap. They
are written into the program's parameters in place; the check makes
them again from the seed after the program is freed (`SeededWeights`),
one layer at a time, so the card never holds the LM twice.

Set-up builds the corpus and the weights, the trainer on them, casts the
encoder's parameters for inference once (as `run_test` does) and runs
`warm_calls` calls. The window runs calls back to back until its seconds
have passed and counts the QA pairs each call answered and scored.
Every decode is recorded (its question rows, tokens and log-probs)
through a wrapper around the model's `decode`. With --trace 1 the
window's first `trace_calls` calls run under torch.profiler, read in
one pass over its events: the trace summary (`benchlib/trace.py`) and
the device time of the kernels launched inside the program's spans
`ekaid.lm.step` and `ekaid.lm.prefill` (`benchlib/launches.py`).

The check draws `check_batches` of the window's decodes from the seed
and holds them against the plain references in f32 with TF32 off: the
EKAID reference's change encoder (its relation-encoded nodes read
through a hook on its last relation encoder) and the DeepSeek-V2
reference (`reference/deepseek_v2.py`), one causal forward over the
prompt and the program's tokens fed back. `token_gap_mean`: the mean
gap by which the program's token lies below the reference's best;
`logprob_rms`: the RMS distance of the program's reported log-prob from
the reference's; `answers_wrong`: rows whose scored answer text differs
from the decoded tokens, or whose question row is not the corpus's.
Positions are read up to and including each row's END.
"""

from __future__ import annotations

import time
import zlib
from collections.abc import Mapping

import numpy as np
import torch

from benchlib import counts_lm, data, launches, program, trace
from reference import deepseek_v2 as ref_lm
from reference.model import fp8

STEP, PREFILL = "ekaid.lm.step", "ekaid.lm.prefill"
#: the published initializer_range
INIT_STD = 0.02


def lm_weight(name: str, shape, seed: int, device, eos: int):
    """The seeded bf16 value of the LM's parameter `name`."""
    if name.endswith("norm.weight"):
        return torch.ones(shape, dtype=torch.bfloat16, device=device)
    if name.endswith(".bias"):
        return torch.zeros(shape, dtype=torch.bfloat16, device=device)
    words = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFFFFFFFFFF, zlib.crc32(name.encode())]
    ).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(words[0]) << 31 | int(words[1]) >> 1)
    t = (torch.randn(shape, generator=g, device=device) * INIT_STD).to(
        torch.bfloat16)
    if name == "lm_head.weight":
        t[eos] = 0.0
    return t


class SeededWeights(Mapping):
    """The LM's weights in f32, each made from the seed when read."""

    def __init__(self, shapes: dict, seed: int, device, eos: int):
        self.shapes, self.seed, self.device, self.eos = (shapes, seed,
                                                         device, eos)

    def __getitem__(self, name):
        return lm_weight(name, self.shapes[name], self.seed, self.device,
                         self.eos).float()

    def __iter__(self):
        return iter(self.shapes)

    def __len__(self):
        return len(self.shapes)


def prompt_length(dims: dict) -> int:
    return 2 * dims["num_nodes"] + 3 + dims["question_len"] + 1


def setup(ctx):
    t = ctx.traffic
    corpus = data.make_corpus(t["corpus"], ctx.dims, ctx.seed, ctx.device)
    cfg = program.program_config(ctx.overlay, seed=None)
    ds = program.dataset(cfg, corpus)
    B = cfg.data.test.batch_size
    per_call = t["batches_per_call"] * B
    n = len(ds)
    slices = [program.view(ds, np.arange(i, min(i + per_call, n)))
              for i in range(0, n, per_call)]
    from ekaid_torch.data.vocab import identity_vocab
    from ekaid_torch.train.train import Trainer
    from ekaid_torch.utils.dtypes import Policy, cast_params_for_inference
    tr = Trainer(cfg, ctx.workdir, ds, slices[0],
                 identity_vocab(cfg.speaker.vocab_size), device=ctx.device)
    enc = {k: v for k, v in ctx.weights().items()
           if k.startswith("change_detector.")}
    missing, unexpected = tr.model.load_state_dict(enc, strict=False)
    if unexpected or not all(k.startswith("lm.") for k in missing):
        raise RuntimeError(f"weights do not fit the program: missing "
                           f"{missing[:5]}, unexpected {unexpected[:5]}")
    eos = cfg.lm.eos_token_id
    with torch.no_grad():
        for name, p in tr.model.lm.named_parameters():
            p.copy_(lm_weight(name, p.shape, ctx.seed, ctx.device, eos))
    cast_params_for_inference(tr.model, Policy.from_config(cfg.dtypes))
    st = {"corpus": corpus, "tr": tr, "slices": slices, "B": B,
          "records": [], "calls": [],
          "lm_dtypes": sorted({str(p.dtype)
                               for p in tr.model.lm.parameters()})}
    _record_decodes(ctx, st)
    for k in range(t["warm_calls"]):
        _call(st, k)
    st["next"] = t["warm_calls"]
    st["records"].clear()
    st["calls"].clear()
    return st


def _record_decodes(ctx, st):
    model = st["tr"].model
    inner = model.decode
    records = st["records"]
    new_cache = model.lm.new_cache

    def cache(batch, length):
        c = new_cache(batch, length)
        st["cache_shape"] = list(c.data.shape)
        return c

    model.lm.new_cache = cache
    vocab = ctx.overlay["lm"]["vocab_size"]

    def decode(batch, *args, **kwargs):
        with torch.profiler.record_function("hb.decode"):
            out = inner(batch, *args, **kwargs)
        if "alter_token" in ctx.faults:
            out = dict(out)
            seq = out["seq"].clone()
            seq[:, 3] = (seq[:, 3] + 7) % vocab
            out["seq"] = seq
        if "half_batch" in ctx.faults:
            # only the first half decoded, the rest left at zero
            out = dict(out)
            for k in ("seq", "logprobs"):
                v = out[k].clone()
                v[v.shape[0] // 2:] = 0
                out[k] = v
        records.append({"call": len(st["calls"]) - 1,
                        "rows": out["seq"].shape[0],
                        "question": batch["question"], "seq": out["seq"],
                        "logprobs": out["logprobs"]})
        st["last_decode"] = time.perf_counter()
        return out

    model.decode = decode


def _call(st, k):
    tr = st["tr"]
    sl = st["slices"][k % len(st["slices"])]
    tr.eval_ds = sl
    st["calls"].append({"rows": sl.split_idxs, "predictions": None})
    with torch.profiler.record_function("hb.evaluate"):
        scores, preds = tr.evaluate()
    st["calls"][-1].update(predictions=preds,
                           tail_s=time.perf_counter() - st["last_decode"])
    return len(preds)


class _Traced:
    """torch.profiler over a block on CUDA (a no-op elsewhere), its
    window marked as `benchlib/trace.py` marks it; on exit its events
    are read once into the trace summary and the device time launched
    inside the LM's spans."""

    def __init__(self, device):
        self.enabled = torch.device(device).type == "cuda"
        self.summary, self.spans = None, {}

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.mark = torch.profiler.record_function(trace.WINDOW)
            self.mark.__enter__()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.t0
            self.mark.__exit__(None, None, None)
            self.prof.__exit__(*exc)
            evs = list(launches.events(self.prof))
            self.summary = trace.reduce_events(
                ((e[0], e[1] / 1e3, e[2] / 1e3, e[3], e[6]) for e in evs),
                wall)
            self.spans = launches.reduce_launches(evs, (STEP, PREFILL))
            del self.prof
        return False


def _reset_program_sums():
    try:
        from ekaid_torch.utils import observability
    except ImportError:
        return None
    reset = getattr(observability, "reset_recorded", None)
    if reset is not None:
        reset()
    return getattr(observability, "recorded", None)


def window(ctx, st, seconds: float, trace_on: bool) -> dict:
    t = ctx.traffic
    k = st["next"]
    pairs = 0
    traced = _Traced(ctx.device if trace_on else "cpu")
    program_sums = None
    t0 = time.perf_counter()
    if trace_on:
        read = _reset_program_sums()
        with traced:
            for _ in range(t["trace_calls"]):
                pairs += _call(st, k)
                k += 1
        program_sums = read() if read is not None else None
    while time.perf_counter() - t0 < seconds:
        pairs += _call(st, k)
        k += 1
    elapsed = time.perf_counter() - t0
    m, lm = ctx.dims, ctx.overlay["lm"]
    L = prompt_length(m)
    done = [(r["rows"], counts_lm.steps_needed(r["seq"]))
            for r in st["records"]
            if trace_on and r["call"] < t["trace_calls"]]
    layer = {"summary": traced.summary, "lm_decodes": len(done),
             "model_ops": sum(counts_lm.eval_ops(m, lm, rows, L, steps)
                              for rows, steps in done),
             "step_bound_s": sum(counts_lm.decode_bound_s(lm, rows, L,
                                                          steps)
                                 for rows, steps in done),
             "lm": traced.spans}
    steps = [counts_lm.steps_needed(r["seq"]) for r in st["records"]]
    log = {"calls": len(st["calls"]), "pairs": pairs, "seconds": elapsed,
           "tail_s": sum(c["tail_s"] for c in st["calls"]),
           "steps": [min(steps), max(steps)],
           "lm_param_dtypes": st["lm_dtypes"],
           "cache_shape": st.get("cache_shape")}
    if traced.summary is not None:
        log.update(traced_decodes=len(done), lm_spans=traced.spans,
                   greedy_decode_kernels=traced.summary.op_count(
                       "greedy_decode_kernel"),
                   program_counts=(program_sums or {}).get("counts"))
    return {"metrics": {"eval_pairs_per_s": pairs / elapsed},
            "attempted": pairs, "failed": 0, "layer": layer, "log": log}


def check(ctx, st) -> dict:
    """The references over `check_batches` decodes drawn from the seed."""
    recs, calls, B = st["records"], st["calls"], st["B"]
    rng = np.random.default_rng([int(ctx.seed) & 0xFFFFFFFFFFFFFFFF, 31])
    n = min(ctx.traffic["check_batches"], len(recs))
    pick = sorted(rng.choice(len(recs), n, replace=False).tolist())
    within = {}
    sampled = []
    for i, r in enumerate(recs):
        j = within.get(r["call"], 0)
        within[r["call"]] = j + 1
        if i in pick:
            rows = calls[r["call"]]["rows"][j * B:(j + 1) * B]
            if len(rows) < r["rows"]:     # the final batch, padded
                rows = np.concatenate(
                    [rows, np.full(r["rows"] - len(rows), rows[-1])])
            sampled.append((r, rows, calls[r["call"]]["predictions"]))
    host = [{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in r.items()}
            for r, _, _ in sampled]
    corpus = st["corpus"]
    st.clear()
    program.free_cuda()
    return reference_numbers(ctx, corpus, host,
                             [rows for _, rows, _ in sampled],
                             [p for _, _, p in sampled])


def _live(seq: torch.Tensor) -> torch.Tensor:
    """[B, T] bool: positions up to and including each row's first END
    (a negative id)."""
    ended = (seq < 0).int().cumsum(dim=1)
    return (ended == 0) | ((ended == 1) & (seq < 0))


def lm_gaps(ref_logp, ids, live, prog_lp) -> dict:
    picked = torch.gather(ref_logp, -1, ids[..., None])[..., 0]
    gap = ref_logp.max(dim=-1).values - picked
    err = (prog_lp.float() - picked).abs()
    return {"token_gap": float(gap[live].max()),
            "token_gap_mean": float(gap[live].mean()),
            "logprob_err": float(err[live].max()),
            "logprob_rms": float(err[live].pow(2).mean().sqrt())}


def _forced(ctx, enc_model, weights, pr, b, ids):
    """Log-probs [B, T, V] of the answer positions: the encoder's nodes
    (read at its last relation encoder) and pooled vectors through the
    projector, the question and BOS, then `ids` fed back."""
    lm = ctx.overlay["lm"]
    nodes = []
    hook = enc_model.change_detector.imp_relation.register_forward_hook(
        lambda mod, inp, out: nodes.append(out))
    try:
        enc = enc_model.encode(b)
    finally:
        hook.remove()
    x = ref_lm.prompt(lm, weights, nodes[0], nodes[1], enc["feat_bef"],
                      enc["feat_diff"], enc["feat_aft"], b["question"],
                      pr=pr)
    return ref_lm.forced_logprobs(lm, weights, x, ids, pr)


def reference_numbers(ctx, corpus, recs, rows_list, preds_list):
    m, lm = ctx.dims, ctx.overlay["lm"]
    eos = lm["eos_token_id"]
    enc_w = ctx.weights()
    weights = SeededWeights(ref_lm.param_shapes(lm, m["att_dim"]), ctx.seed,
                            ctx.device, eos)
    worst = {"token_gap": 0.0, "logprob_err": 0.0}
    means = []
    wrong = 0
    with ctx.f32(), torch.no_grad():
        enc_ref = program.reference(m, ctx.device)
        enc_ref.load_state_dict(enc_w)
        enc_ref.eval()
        enc_low = program.control_reference(ctx, enc_w)
        for r, rows, preds in zip(recs, rows_list, preds_list):
            b = data.batch(corpus, rows, m, ctx.device)
            if not torch.equal(r["question"].long().cpu(),
                               b["question"].long().cpu()):
                wrong += 1
            seq = r["seq"].to(ctx.device)
            live = _live(seq)
            ids = torch.where(seq < 0, eos, seq.long())
            logp = _forced(ctx, enc_ref, weights, ref_lm.F32, b, ids)
            if enc_low is not None:
                low = _forced(ctx, enc_low, weights, fp8(), b, ids)
                tok = low.argmax(dim=-1)
                g = lm_gaps(logp, tok, live, low.gather(
                    -1, tok[..., None])[..., 0])
                del low
            else:
                g = lm_gaps(logp, ids, live, r["logprobs"].to(ctx.device))
            del logp
            for k in worst:
                worst[k] = max(worst[k], g[k])
            means.append(g)
            for row, s in zip(rows, r["seq"].tolist()):
                if preds.get(str(int(row))) != _decode_text(s):
                    wrong += 1
    for k in ("token_gap_mean", "logprob_rms"):
        worst[k] = sum(g[k] for g in means) / max(1, len(means))
    worst["answers_wrong"] = float(wrong)
    return worst


def _decode_text(seq) -> str:
    """The answer's words as the program scores them: LM ids up to the
    first END, id i read as the identity vocabulary's word ('<start>'
    for 1, 'w<i>' else)."""
    words = []
    for i in seq:
        if i < 0:
            break
        words.append("<start>" if i == 1 else f"w{i}")
    return " ".join(words)
