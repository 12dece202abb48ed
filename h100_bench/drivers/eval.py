"""The batched eval driver: `Trainer.evaluate`, the eval behind
`python -m ekaid_torch.train.test`, over a corpus split into slices of
`batches_per_call` x batch rows, walked slice by slice.

Set-up builds the corpus and the weights from the seed, the trainer on
them, casts the parameters for inference once (as `run_test` does) and
runs `warm_calls` calls. The window runs calls back to back until the
window's seconds have passed, and counts the QA pairs each call answered
and scored. Every decode the window drives is recorded (its inputs'
question rows, tokens, log-probs and module weights) through a wrapper
around the model's `decode`; the check draws `check_batches` of them
from the seed and holds them, and the answers that the calls scored for
their rows, against the reference. The window's log (standard error)
gives `tail_s`, the host seconds of its calls from the last decode's
return to the call's end: the last batch's fetch, then detokenizing and
scoring the call's answers; and `steps`, the fewest and most steps a
decode ran.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import counts, data, program
from benchlib.checks import control_gaps, decode_gaps
from benchlib.trace import Trace


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
    weights = ctx.weights()
    tr = program.trainer(cfg, ctx.workdir, ds, slices[0], weights,
                         ctx.device)
    from ekaid_torch.utils.dtypes import Policy, cast_params_for_inference
    cast_params_for_inference(tr.model, Policy.from_config(cfg.dtypes))
    st = {"corpus": corpus, "tr": tr, "slices": slices,
          "weights": weights, "B": B, "records": [], "calls": []}
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

    def decode(batch, *args, **kwargs):
        with torch.profiler.record_function("hb.decode"):
            out = inner(batch, *args, **kwargs)
        if "alter_token" in ctx.faults:
            out = dict(out)
            seq = out["seq"].clone()
            seq[:, 3] = (seq[:, 3] + 7) % (ctx.dims["vocab_size"] - 2) + 2
            out["seq"] = seq
        if "half_batch" in ctx.faults:
            # only the first half decoded, the rest left at zero
            out = dict(out)
            for k in ("seq", "logprobs", "module_weights"):
                v = out[k].clone()
                v[v.shape[0] // 2:] = 0
                out[k] = v
        records.append({"call": len(st["calls"]) - 1,
                        "rows": out["seq"].shape[0],
                        "question": batch["question"], "seq": out["seq"],
                        "logprobs": out["logprobs"],
                        "module_weights": out["module_weights"]})
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


def window(ctx, st, seconds: float, trace: bool) -> dict:
    t = ctx.traffic
    k = st["next"]
    pairs = 0
    summary = None
    t0 = time.perf_counter()
    if trace:
        with Trace(ctx.device) as tr:
            for _ in range(t["trace_calls"]):
                pairs += _call(st, k)
                k += 1
        summary = tr.summary
    while time.perf_counter() - t0 < seconds:
        pairs += _call(st, k)
        k += 1
    elapsed = time.perf_counter() - t0
    traced = [(r["rows"], counts.steps_run(r["seq"])) for r in st["records"]
              if r["call"] < t["trace_calls"]] if trace else []
    m = ctx.dims
    layer = {"summary": summary, "decodes": len(traced),
             "k1_bound_s": sum(counts.k1_bound(m, rows, steps)["bound_s"]
                               for rows, steps in traced),
             "model_ops": sum(counts.eval_ops(m, rows, steps)
                              for rows, steps in traced)}
    steps = [counts.steps_run(r["seq"]) for r in st["records"]]
    return {"metrics": {"eval_pairs_per_s": pairs / elapsed},
            "attempted": pairs, "failed": 0, "layer": layer,
            "log": {"calls": len(st["calls"]), "pairs": pairs,
                    "seconds": elapsed,
                    "tail_s": sum(c["tail_s"] for c in st["calls"]),
                    "steps": [min(steps), max(steps)]}}


def check(ctx, st) -> dict:
    """The reference over `check_batches` decodes drawn from the seed."""
    recs, calls, B = st["records"], st["calls"], st["B"]
    rng = np.random.default_rng([int(ctx.seed) & 0xFFFFFFFFFFFFFFFF, 31])
    n = min(ctx.traffic["check_batches"], len(recs))
    pick = sorted(rng.choice(len(recs), n, replace=False).tolist())
    # each decode's rows: its call's slice, in the loader's order
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
    weights = st["weights"]
    st.clear()
    program.free_cuda()
    return reference_numbers(ctx, corpus, weights, host,
                             [rows for _, rows, _ in sampled],
                             [p for _, _, p in sampled])


def reference_numbers(ctx, corpus, weights, recs, rows_list, preds_list):
    m = ctx.dims
    with ctx.f32():
        ref = program.reference(m, ctx.device)
        ref.load_state_dict(weights)
        ref.eval()
        low = program.control_reference(ctx, weights)
        worst, means = {"token_gap": 0.0, "logprob_err": 0.0,
                        "mw_err": 0.0}, []
        wrong_rows = answers_wrong = 0
        with torch.no_grad():
            for r, rows, preds in zip(recs, rows_list, preds_list):
                b = data.batch(corpus, rows, m, ctx.device)
                if not torch.equal(r["question"].long().cpu(),
                                   b["question"].long().cpu()):
                    wrong_rows += 1
                seq = r["seq"].to(ctx.device)
                logp, mw = ref.forced(b, seq)
                if low is not None:
                    g = control_gaps(logp, mw, *low.forced(b, seq), seq)
                else:
                    g = decode_gaps(logp, mw, seq,
                                    r["logprobs"].to(ctx.device),
                                    r["module_weights"].to(ctx.device))
                for k in worst:
                    worst[k] = max(worst[k], g[k])
                means.append(g)
                for row, s in zip(rows, r["seq"].tolist()):
                    want = _decode_text(s)
                    if preds.get(str(int(row))) != want:
                        answers_wrong += 1
    for k in ("token_gap_mean", "logprob_rms", "mw_mean"):
        worst[k] = sum(g[k] for g in means) / max(1, len(means))
    worst["answers_wrong"] = float(answers_wrong + wrong_rows)
    return worst


def _decode_text(seq) -> str:
    words = []
    for i in seq:
        if i <= 0:
            break
        words.append("<start>" if i == 1 else f"w{i}")
    return " ".join(words)
