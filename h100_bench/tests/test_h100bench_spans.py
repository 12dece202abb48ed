"""The readers of the program's spans and counters (`benchlib/spans.py`,
`metrics/{score,inputs,dispatch,fetch_wait}_ms.eval.py`,
`metrics/cache_hit_rate.eval.py`): their arithmetic, nothing where
there is nothing to read, every reading from a profiled CPU run of each
eval cell at tiny widths, and the trace's reduction unchanged by the
program's host spans but for its gap labels."""

import tempfile
import threading

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

import run
from _tiny import patch
from benchlib import spans, spec, trace
from ekaid_torch.utils import observability as obs

BENCH = spec.benchmark()
SEED = 2 ** 31 + 77
MS = ("score_ms.eval", "inputs_ms.eval", "dispatch_ms.eval",
      "fetch_wait_ms.eval")
TRACED = {"summary": object()}          # a traced run's record


def _read(name, ctx):
    return spec.metric_reader(name).read(ctx)


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset_recorded()
    yield
    obs.reset_recorded()


def test_reduction_unchanged_by_program_spans_but_for_gap_labels():
    dev = [(True, 10, 20, "k1", False), (True, 50, 60, "gemm", False),
           (True, 55, 90, "copy", False)]
    window = [(False, 0, 100, trace.WINDOW, True)]
    call = [(False, 1, 99, "hb.evaluate", True),
            (True, 1, 99, "hb.evaluate", True)]     # its device copy
    prog = [(False, 21, 49, "ekaid.eval.score", False),
            (False, 2, 9, "ekaid.eval.inputs", False),
            (False, 91, 98, "ekaid.eval.fetch", False)]
    a = trace.reduce_events(window + call + dev, 1.0)
    b = trace.reduce_events(window + call + dev + prog, 1.0)
    assert (a.busy_s, a.window_s, a.device_ops) == \
        (b.busy_s, b.window_s, b.device_ops)
    assert [s for _, s in a.gaps] == [s for _, s in b.gaps]
    assert [n for n, _ in a.gaps] == ["hb.evaluate"] * 3
    assert [n for n, _ in b.gaps] == ["ekaid.eval.score",
                                      "ekaid.eval.inputs",
                                      "ekaid.eval.fetch"]


def test_span_ms_is_host_time_per_instance_or_per_other_span():
    rec = {"spans": {"a": {"count": 5, "host_s": 0.2},
                     "d": {"count": 4, "host_s": 0.1}}, "counts": {}}
    assert spans.span_ms(rec, "a") == pytest.approx(40.0)
    assert spans.span_ms(rec, "a", per="d") == pytest.approx(50.0)
    assert spans.span_ms(rec, "b") is None
    assert spans.span_ms(rec, "a", per="b") is None
    assert spans.span_ms(None, "a") is None


def test_readers_take_host_time_with_children_on_any_thread():
    def other():
        with obs.span("ekaid.eval.fetch"):
            torch.ones(64, 64) @ torch.ones(64, 64)

    cfg = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=cfg):
        for _ in range(2):
            with obs.span("ekaid.eval.decode"):
                with obs.span("ekaid.eval.inputs"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
            with obs.span("ekaid.eval.score"):
                with obs.span("ekaid.eval.detok"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
            t = threading.Thread(target=other)
            t.start()
            t.join()
    rec = spans.recorded(TRACED)
    sp = rec["spans"]
    assert all(sp[k]["count"] == 2 for k in
               ("ekaid.eval.score", "ekaid.eval.detok", "ekaid.eval.decode",
                "ekaid.eval.inputs", "ekaid.eval.fetch"))
    # a parent's host time holds its children's
    assert sp["ekaid.eval.score"]["host_s"] >= sp["ekaid.eval.detok"]["host_s"]
    for name, span in (("score_ms.eval", "ekaid.eval.score"),
                       ("dispatch_ms.eval", "ekaid.eval.decode"),
                       ("fetch_wait_ms.eval", "ekaid.eval.fetch")):
        assert _read(name, TRACED) == pytest.approx(
            1e3 * sp[span]["host_s"] / 2)
    # inputs: over the batches decoded
    assert _read("inputs_ms.eval", TRACED) == pytest.approx(
        1e3 * sp["ekaid.eval.inputs"]["host_s"] / 2)


def test_hit_rate_arithmetic():
    rec = {"spans": {}, "counts": {"h": 3, "m": 1}}
    assert spans.share(rec, "h", "m") == pytest.approx(75.0)
    assert spans.share({"spans": {}, "counts": {"h": 0, "m": 0}},
                       "h", "m") is None
    assert spans.share({"spans": {}, "counts": {}}, "h", "m") is None


@pytest.mark.parametrize("name", MS + ("cache_hit_rate.eval",))
def test_nothing_to_read_gives_none(name):
    # not traced
    assert _read(name, {"summary": None}) is None
    # traced, but no such span or counter recorded
    assert _read(name, TRACED) is None


def _profiled_calls(name):
    cell = spec.cell(name, BENCH)
    driver = spec.import_file(cell.driver_path)
    with tempfile.TemporaryDirectory() as workdir:
        ctx = run.make_ctx(cell, SEED, 1.0, torch.device("cpu"), workdir,
                           patch(cell))
        st = driver.setup(ctx)
        obs.reset_recorded()
        with profile(activities=[ProfilerActivity.CPU]):
            for k in range(2):
                driver._call(st, st["next"] + k)
        return ctx, {m["name"]: _read(m["name"], TRACED)
                     for m in spec.per_layer(BENCH, name)
                     if m["source"].startswith("program_")}


@pytest.mark.parametrize("name", ["mode2-eval-b64", "mode0-eval-b64"])
def test_every_reading_from_a_profiled_cpu_run(name):
    ctx, got = _profiled_calls(name)
    listed = {m["name"] for m in spec.per_layer(BENCH, name)}
    rec = obs.recorded()
    batches = ctx.traffic["batches_per_call"] * 2
    assert rec["spans"]["ekaid.eval.score"]["count"] == 2
    assert rec["spans"]["ekaid.eval.decode"]["count"] == batches
    for m in MS:
        assert m in listed and got[m] is not None and got[m] > 0, m
    if name == "mode2-eval-b64":
        c = rec["counts"]
        assert got["cache_hit_rate.eval"] == pytest.approx(
            100.0 * c["ekaid.cache.hits"]
            / (c["ekaid.cache.hits"] + c["ekaid.cache.misses"]))
    else:
        assert "cache_hit_rate.eval" not in listed
        assert rec["counts"] == {}


@pytest.mark.parametrize("name", ["mode2-eval-b64", "mode0-eval-b64"])
def test_traced_cpu_run_is_correct_with_the_spans(name):
    """With --trace 1 off CUDA the window is not profiled: the run is
    checked as ever and the readers read nothing."""
    cell = spec.cell(name, BENCH)
    out = run.run_cell(cell, SEED, 1.5, True, device="cpu",
                       patch=patch(cell), bench=BENCH)
    assert out["correct"], out["checks"]
    assert not set(out["metrics"]) & set(MS + ("cache_hit_rate.eval",))
