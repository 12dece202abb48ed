"""The seeded inputs and weights; the no-JAX check; the trace's
reduction."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from _tiny import dims
from benchlib import data, env, program, trace
from benchlib.weights import make_weights

SEEDS = (7, 2 ** 31 + 12345)


@pytest.mark.parametrize("config", ["ekaid-mode2", "ekaid-mode0"])
def test_corpus_is_a_function_of_the_seed(config):
    _, _, m = dims(config)
    c = {"qa_rows": 32, "images": 16, "pairing": "disjoint",
         "questions_per_pair": 4, "question_types": [[5, 6], [7], [8, 9, 10],
                                                     [11], [12], [13], [14]]}
    a, b = (data.make_corpus(c, m, SEEDS[1], "cpu") for _ in range(2))
    other = data.make_corpus(c, m, SEEDS[0], "cpu")
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    big = "images" if config == "ekaid-mode0" else "feats"
    assert not np.array_equal(a[big], other[big])
    assert a["answers"].max() < m["vocab_size"]
    assert (a["feature_idx"][:, 1] == a["feature_idx"][:, 0] + 1).all()


def test_weights_are_a_function_of_the_seed():
    _, _, m = dims()
    ref = program.reference(m, "cpu")
    a = make_weights(ref, SEEDS[1], "cpu")
    b = make_weights(ref, SEEDS[1], "cpu")
    c = make_weights(ref, SEEDS[0], "cpu")
    assert a.keys() == dict(ref.named_parameters()).keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["speaker.logit.kernel"],
                           c["speaker.logit.kernel"])
    v = a["speaker.core.pos1.kernel"]
    assert v.abs().max() <= 1 / m["rnn_size"] ** 0.5
    emb = a["change_detector.question.WordEmbedding_0.emb"]
    assert emb[-1].abs().sum() == 0 and emb[0].abs().sum() > 0
    g = a["change_detector.question.QuestionSelfAttention_0.FCNet_0"
          ".WNDense_0.g"]
    v = a["change_detector.question.QuestionSelfAttention_0.FCNet_0"
          ".WNDense_0.v"]
    assert torch.allclose(g, torch.linalg.norm(v))


def test_forbidden_modules_by_top_level_name():
    bad = env.forbidden_modules(["jax.numpy", "ekaid_tpu.x", "ekaid_torch",
                                 "ekaid_torch.models", "jaxlib", "flax.core",
                                 "optax", "jaxtyping", "ekaid_tpu_extra",
                                 "numpy"])
    assert bad == ["ekaid_tpu.x", "flax.core", "jax.numpy", "jaxlib", "optax"]


def test_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path[:0] = [%r]; import reference.model, "
            "benchlib.weights; print(sorted({n.split('.')[0] for n in sys.modules}))"
            % str(env.BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(json.loads(out.replace("'", '"')))
    assert not tops & {"ekaid_torch", "ekaid_tpu", "jax", "jaxlib", "flax",
                       "optax"}


def test_reduce_events_busy_idle_and_gaps():
    W = trace.WINDOW
    ev = [(False, 0.0, 1000.0, W, True),
          (False, 100.0, 400.0, "hb.evaluate", True),
          (False, 150.0, 350.0, "host_op", False),
          (True, 50.0, 100.0, "k_a", False),
          (True, 80.0, 120.0, "k_b", False),           # overlaps k_a
          (True, 500.0, 600.0, "k_a", False),
          (True, 900.0, 1100.0, "k_c", False),         # clipped at 1000
          (True, 10.0, 990.0, "hb.evaluate", True)]    # annotation copy
    s = trace.reduce_events(ev, 123.0)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx((70 + 100 + 100) / 1e6)
    assert s.op_count("k_a") == 2 and s.op_time("k_c") == pytest.approx(1e-4)
    assert "hb.evaluate" not in s.device_ops
    assert s.gaps[0] == ("host_op", pytest.approx(380 / 1e6))
    assert len(s.breakdown()["idle_gaps"]) == 3



@pytest.mark.parametrize("config", ["ekaid-mode2", "ekaid-mode0"])
def test_every_answer_runs_to_the_cap(config):
    import run
    from _tiny import patch
    from benchlib import spec
    bench = spec.benchmark()
    cell = next(spec.cell(w["name"], bench) for w in bench["workloads"]
                if w["config"] == config)
    for seed in SEEDS:
        ctx = run.make_ctx(cell, seed, 1.0, torch.device("cpu"), "",
                           patch(cell))
        w = ctx.weights()
        assert float(w["speaker.logit.bias"][0]) == run.EOS_BIAS
        ref = program.reference(ctx.dims, "cpu")
        ref.load_state_dict(w)
        corpus = data.make_corpus(
            {"qa_rows": 8, "images": 16, "pairing": "disjoint",
             "questions_per_pair": 1, "question_types": [[5, 6, 7]]},
            ctx.dims, seed, "cpu")
        with torch.no_grad():
            seq = ref.speaker.greedy(ref.encode(
                data.batch(corpus, list(range(8)), ctx.dims, "cpu")))
        assert (seq > 0).all()
