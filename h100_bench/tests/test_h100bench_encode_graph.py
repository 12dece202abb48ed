"""The reader of the program's graphed-encode counters
(`metrics/encode_graph_share.eval.py`): its arithmetic, nothing where
there is nothing to read, its place in both eval cells, and its reading
from a profiled CPU run of each, where every encode runs eagerly."""

import tempfile

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import run
from _tiny import patch
from benchlib import spec
from ekaid_torch.utils import observability as obs

BENCH = spec.benchmark()
NAME = "encode_graph_share.eval"
SEED = 2 ** 31 + 91
TRACED = {"summary": object()}          # a traced run's record
CELLS = ["mode2-eval-b64", "mode0-eval-b64"]


def _read(ctx):
    return spec.metric_reader(NAME).read(ctx)


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset_recorded()
    yield
    obs.reset_recorded()


def _counted(graph, eager):
    with profile(activities=[ProfilerActivity.CPU]):
        obs.count("ekaid.encode.graph", graph)
        obs.count("ekaid.encode.eager", eager)


@pytest.mark.parametrize("graph,eager,want", [(16, 0, 100.0), (15, 1, 93.75),
                                              (0, 16, 0.0)])
def test_share_of_the_counted_encodes(graph, eager, want):
    _counted(graph, eager)
    assert _read(TRACED) == pytest.approx(want)


def test_nothing_to_read_gives_none():
    assert _read({"summary": None}) is None          # not traced
    assert _read(TRACED) is None                     # no counter recorded
    _counted(0, 0)                                   # counted, no encode
    assert _read(TRACED) is None


@pytest.mark.parametrize("name", CELLS)
def test_reported_in_both_eval_cells(name):
    m = next(m for m in spec.per_layer(BENCH, name) if m["name"] == NAME)
    assert (m["source"], m["moves"], m["layer"]) == (
        "program_counter", "eval_pairs_per_s", "Trainer.evaluate host")


@pytest.mark.parametrize("name", CELLS)
def test_a_profiled_cpu_run_counts_every_encode_eager(name):
    cell = spec.cell(name, BENCH)
    cell_run = spec.import_file(cell.driver_path)
    with tempfile.TemporaryDirectory() as workdir:
        ctx = run.make_ctx(cell, SEED, 1.0, torch.device("cpu"), workdir,
                           patch(cell))
        st = cell_run.setup(ctx)
        obs.reset_recorded()
        with profile(activities=[ProfilerActivity.CPU]):
            for k in range(2):
                cell_run._call(st, st["next"] + k)
    rec = obs.recorded()
    decodes = rec["spans"]["ekaid.eval.decode"]["count"]
    assert decodes == 2 * ctx.traffic["batches_per_call"]
    assert rec["counts"]["ekaid.encode.eager"] == decodes
    assert rec["counts"]["ekaid.encode.graph"] == 0
    assert _read(TRACED) == 0.0
