"""ekaid_torch's spans (`utils/observability.span` and `count`): off
without a profiler, host events with no device-side copy under one,
their host time added up by name, and placed at every
boundary of `Trainer.evaluate` on both input paths without changing
its answers; inside its scoring, a span for each part and a count of
each native or plain metric call. CPU only."""

import json
import threading
from pathlib import Path

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

from ekaid_torch.config import load_config
from ekaid_torch.metrics import caption as cap
from ekaid_torch.train import test as ptest
from ekaid_torch.train.train import Loader, build_synthetic_trainer
from ekaid_torch.utils import observability as obs

ROOT = Path(__file__).resolve().parent.parent
EVAL = ("ekaid.eval.inputs", "ekaid.eval.decode", "ekaid.eval.fetch",
        "ekaid.eval.detok")
DECODE = ("ekaid.decode.encode", "ekaid.decode.sample")
SCORE = ("ekaid.score.tokenize", "ekaid.score.bleu", "ekaid.score.meteor",
         "ekaid.score.rouge", "ekaid.score.cider")


def _profiler(all_threads=False):
    kw = ({"experimental_config": _ExperimentalConfig(
        profile_all_threads=True)} if all_threads else {})
    return torch_profile(activities=[ProfilerActivity.CPU], **kw)


def _spans(prof):
    """(name, start ns, end ns, thread, user annotation?) of the
    profiler's `ekaid.` events."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.start_thread_id(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("ekaid.")]


def _inside(inner, outer):
    return (inner[3] == outer[3] and outer[1] <= inner[1]
            and inner[2] <= outer[2])


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset_recorded()
    yield
    obs.reset_recorded()


def test_off_span_is_one_shared_noop():
    a, b = obs.span("ekaid.a"), obs.span("ekaid.b")
    assert a is b
    with a:
        with obs.span("ekaid.c"):
            torch.ones(4) + 1
    obs.count("ekaid.n", 3)
    assert obs.recorded() == {"spans": {}, "counts": {}}


def test_span_is_a_nested_host_event_not_an_annotation():
    with _profiler() as prof:
        with obs.span("ekaid.outer"):
            with obs.span("ekaid.inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            with obs.span("ekaid.inner"):
                pass
    ev = _spans(prof)
    outer = [e for e in ev if e[0] == "ekaid.outer"]
    inner = [e for e in ev if e[0] == "ekaid.inner"]
    assert len(outer) == 1 and len(inner) == 2
    assert all(_inside(e, outer[0]) for e in inner)
    assert not any(e[4] for e in ev)
    rec = obs.recorded()["spans"]
    assert rec["ekaid.outer"]["count"] == 1
    assert rec["ekaid.inner"]["count"] == 2
    # host time: the outer span's holds its children's
    assert rec["ekaid.outer"]["host_s"] >= rec["ekaid.inner"]["host_s"] > 0


def test_span_on_a_second_thread_is_recorded_on_it():
    def work():
        with obs.span("ekaid.worker"):
            torch.ones(8) * 2

    with _profiler(all_threads=True) as prof:
        with obs.span("ekaid.main"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
    ev = {e[0]: e for e in _spans(prof)}
    assert ev["ekaid.worker"][3] != ev["ekaid.main"][3]
    rec = obs.recorded()["spans"]
    assert rec["ekaid.main"]["count"] == rec["ekaid.worker"]["count"] == 1
    assert rec["ekaid.main"]["host_s"] >= rec["ekaid.worker"]["host_s"] > 0


def test_count_adds_only_while_recording():
    obs.count("ekaid.n", 5)
    with _profiler():
        obs.count("ekaid.n", 2)
        obs.count("ekaid.n")
    obs.count("ekaid.n", 7)
    assert obs.recorded()["counts"] == {"ekaid.n": 3}
    obs.reset_recorded()
    assert obs.recorded() == {"spans": {}, "counts": {}}


def _cfg():
    cfg = load_config(str(ROOT / "configs" / "smoke.yaml"))
    return cfg.replace(
        change_detector=cfg.change_detector.replace(
            att_dim=32, att_head=4, dim=8, pos_emb_dim=16),
        speaker=cfg.speaker.replace(
            input_dim=32, rnn_size=16, embed_input_dim=96, embed_dim=32,
            word_embed_size=8, seq_length=6),
        data=cfg.data.replace(
            num_nodes=6, feature_dim=24, adj_pad=10, num_workers=2,
            eval_device_cache=8,
            test=cfg.data.test.replace(batch_size=2)),
        question=cfg.question.replace(hidden_dim=32))


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    tr = build_synthetic_trainer(_cfg(), str(tmp_path_factory.mktemp("sp")),
                                 n_pairs=60, device="cpu")
    tr.model.eval()
    return tr


def _batches(tr):
    return len(Loader(tr.eval_ds, pad_final=True))


@pytest.mark.parametrize("use_cache", [True, False], ids=["cache", "wire"])
def test_evaluate_spans_every_boundary(trainer, use_cache):
    n = _batches(trainer)
    assert n >= 2
    with _profiler() as prof:
        trainer.evaluate(use_cache=use_cache)
    ev = _spans(prof)
    names = [e[0] for e in ev]
    assert names.count("ekaid.eval.score") == 1
    # the wire path waits once more a call, on the end of the Loader
    inputs = n if use_cache else n + 1
    assert names.count("ekaid.eval.inputs") == inputs
    for name in EVAL[1:] + DECODE:
        assert names.count(name) == n, name
    decodes = [e for e in ev if e[0] == "ekaid.eval.decode"]
    for name in DECODE:
        for e in ev:
            if e[0] == name:
                assert any(_inside(e, d) for d in decodes), name
    assert not any(e[4] for e in ev)
    # batch i is read once batch i + 1 is queued, the last after its own
    fetches = [e for e in ev if e[0] == "ekaid.eval.fetch"]
    for i, f in enumerate(fetches):
        assert decodes[min(i + 1, n - 1)][2] <= f[1]
        assert i + 2 >= n or f[2] <= decodes[i + 2][1]
    rec = obs.recorded()
    assert {k: v["count"] for k, v in rec["spans"].items()} == {
        **{k: n for k in EVAL[1:] + DECODE}, "ekaid.eval.inputs": inputs,
        "ekaid.eval.score": 1, **{k: 1 for k in SCORE}}
    # the decode's host time holds its two children's
    d = rec["spans"]["ekaid.eval.decode"]
    kids = sum(rec["spans"][k]["host_s"] for k in DECODE)
    assert d["host_s"] >= kids > 0
    c = rec["counts"]
    # every decode's encode, eager on the CPU
    assert (c.pop("ekaid.encode.graph"), c.pop("ekaid.encode.eager")) == (
        0, n)
    if use_cache:
        assert c["ekaid.cache.hits"] + c["ekaid.cache.misses"] > 0
    else:
        assert c == {"ekaid.score.native": 3}


@pytest.mark.parametrize("path", ["native", "plain"])
def test_scoring_spans_and_path_counts(trainer, monkeypatch, path):
    """One scoring call: the five `ekaid.score.*` spans once each inside
    `ekaid.eval.score`, and BLEU, ROUGE-L and CIDEr counted by the path
    they took."""
    if path == "plain":
        monkeypatch.setattr(cap, "_native", lambda: None)
    with _profiler() as prof:
        trainer.evaluate(use_cache=False)
    ev = _spans(prof)
    score = [e for e in ev if e[0] == "ekaid.eval.score"]
    assert len(score) == 1
    for name in SCORE:
        inner = [e for e in ev if e[0] == name]
        assert len(inner) == 1 and _inside(inner[0], score[0]), name
    rec = obs.recorded()
    assert rec["counts"] == {f"ekaid.score.{path}": 3,
                             "ekaid.encode.graph": 0,
                             "ekaid.encode.eager": _batches(trainer)}
    parts = sum(rec["spans"][k]["host_s"] for k in SCORE)
    assert rec["spans"]["ekaid.eval.score"]["host_s"] >= parts > 0


@pytest.mark.parametrize("use_cache", [True, False], ids=["cache", "wire"])
def test_evaluate_answers_unchanged_under_the_profiler(trainer, use_cache):
    plain = trainer.evaluate(use_cache=use_cache)
    with _profiler():
        traced = trainer.evaluate(use_cache=use_cache)
    assert traced[1] == plain[1] and len(plain[1]) == len(trainer.eval_ds)
    assert traced[0] == plain[0]


def test_cache_counters_match_the_cache(trainer):
    cache = trainer._eval_cache
    before = (cache.hits, cache.misses) if cache is not None else (0, 0)
    with _profiler():
        trainer.evaluate(use_cache=True)
    cache = trainer._eval_cache
    c = obs.recorded()["counts"]
    assert (c["ekaid.cache.hits"], c["ekaid.cache.misses"]) == (
        cache.hits - before[0], cache.misses - before[1])


def test_train_test_profile_writes_the_spans(tmp_path, capsys):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("speaker:\n  seq_length: 6\n"
                   "data:\n  test:\n    batch_size: 4\n")
    ptest.main(["--synthetic", "--max_batches", "2", "--device", "cpu",
                "--cfg", str(cfg), "--workdir", str(tmp_path / "w"),
                "--profile", str(tmp_path / "prof"),
                "speaker.rnn_size", "16", "speaker.input_dim", "32",
                "speaker.embed_input_dim", "96", "speaker.embed_dim", "32",
                "speaker.word_embed_size", "8",
                "change_detector.att_dim", "32", "change_detector.dim", "8",
                "change_detector.pos_emb_dim", "16",
                "question.hidden_dim", "32", "data.num_nodes", "6",
                "data.feature_dim", "24", "data.adj_pad", "10"])
    assert "Test took" in capsys.readouterr().out
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())[
        "traceEvents"]
    names = {e.get("name") for e in events}
    assert {"ekaid.eval.score", *EVAL, *DECODE} <= names
    assert all(e.get("cat") != "gpu_user_annotation" for e in events
               if str(e.get("name")).startswith("ekaid."))
