"""The eval encode as a CUDA graph (`models/ekaid.py::EncodeGraphs`).

On the CPU: every encode runs eagerly, with the outputs of the encoder
called directly, and counts as `ekaid.encode.eager`. With a stand-in for
the capture, the path choice: a signature runs eagerly at its first
sight, is captured at its second and replayed after; a new shape starts
over; the least recently used signature leaves past the bound; a
parameter whose `p.data` was replaced drops the graphs; a swapped
`cfg` is a new signature; gradients, a dropout generator or a model
axis over 1 always run eagerly.

On a card (skipped without one), at the cells' widths (B=64, bf16,
inference-cast weights), mode2 and mode0: the graphed decode against the
eager one, bit for bit; a call's tensors untouched by the next replay;
a cast after a capture; the kernels of a trace; a capture made while
torch.profiler records (as under `train.test --profile`). Run there with
`python -m pytest --noconftest tests/test_torch_encode_graph.py -q -s`.
"""

import copy
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

from ekaid_torch.config import load_config
from ekaid_torch.data.synthetic import synthetic_batch
from ekaid_torch.models import ekaid
from ekaid_torch.models.ekaid import (GRAPH_SIGNATURES, EkaidModel,
                                      EncodeGraphs)
from ekaid_torch.utils import observability as obs
from ekaid_torch.utils.dtypes import Policy, cast_params_for_inference

ROOT = Path(__file__).resolve().parent.parent
ENC = ("pred", "att_bef", "att_aft", "feat_bef", "feat_aft", "feat_diff")


def _cfg(mode0=False, path="smoke.yaml"):
    cfg = load_config(str(ROOT / "configs" / path))
    if mode0:
        cfg = cfg.replace(data=cfg.data.replace(feature_mode="mode0"),
                          train=cfg.train.replace(setting="mode0"))
    return cfg


def _batch(cfg, B, seed=0, size=32):
    b = synthetic_batch(cfg, B, seed=seed)
    if cfg.train.setting == "mode0":
        rng = np.random.default_rng(seed)
        for k in ("d_feats", "q_feats"):
            b[k] = rng.random((B, size, size), dtype=np.float32)
    return b


@pytest.fixture(scope="module")
def small():
    """A smoke-width mode2 model on the CPU."""
    cfg = _cfg()
    return cfg, EkaidModel(cfg, cfg.speaker.vocab_size, device="cpu")


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset_recorded()
    yield
    obs.reset_recorded()


class _Replay:
    """Stands in for a captured graph: its replays run the encode."""

    def __init__(self, encode, b):
        self.encode = encode
        self.replays = 0

    def replay(self, b):
        self.replays += 1
        return self.encode(b)


@pytest.fixture
def stand_in(monkeypatch, small):
    """Graphs on the CPU, each capture a `_Replay`; yields the list of
    captures. The model starts with no signature seen."""
    captures = []

    def capture(encode, b):
        captures.append(_Replay(encode, b))
        return captures[-1]

    monkeypatch.setattr(ekaid, "GRAPH_DEVICES", ("cpu",))
    monkeypatch.setattr(ekaid, "_Graph", capture)
    _, model = small
    model.graphs = EncodeGraphs()
    yield captures
    model.graphs = EncodeGraphs()


@pytest.mark.parametrize("mode0", [False, True], ids=["mode2", "mode0"])
def test_cpu_encodes_run_eager_with_the_encoders_outputs(mode0):
    cfg = _cfg(mode0)
    model = EkaidModel(cfg, cfg.speaker.vocab_size, device="cpu")
    b = _batch(cfg, 2)
    want = model._encoder(model.tensors(b))
    for out in (model.decode(b), model.decode(b), model.encode(b)):
        for k in ENC:
            assert torch.equal(out[k], want[k]), k
    assert not model.graphs_apply()
    assert len(model.graphs._known) == 0


def test_cpu_counts_eager_under_a_profiler(small):
    cfg, model = small
    b = _batch(cfg, 2)
    with torch_profile(activities=[ProfilerActivity.CPU]):
        model.decode(b)
        model.decode(b)
        model.decode_beam(b, beam_size=2)
        model.forward(b)                  # training: not an eval encode
    assert obs.recorded()["counts"] == {"ekaid.encode.graph": 0,
                                        "ekaid.encode.eager": 3}


def _encode(model, b):
    with torch.no_grad():
        return model._encode(model.tensors(b))


def test_first_sight_eager_second_captures_third_replays(small, stand_in):
    cfg, model = small
    b = _batch(cfg, 3)
    want = model._encoder(model.tensors(b))
    with torch_profile(activities=[ProfilerActivity.CPU]):
        outs = [_encode(model, b) for _ in range(4)]
    assert len(stand_in) == 1 and stand_in[0].replays == 3
    assert obs.recorded()["counts"] == {"ekaid.encode.graph": 3,
                                        "ekaid.encode.eager": 1}
    for out in outs:
        assert all(torch.equal(out[k], want[k]) for k in ENC)
    # a new shape starts over; the old one still replays
    _encode(model, _batch(cfg, 2))
    assert len(stand_in) == 1
    _encode(model, _batch(cfg, 2))
    assert len(stand_in) == 2
    _encode(model, b)
    assert len(stand_in) == 2 and stand_in[0].replays == 4


def test_past_the_bound_the_least_recently_used_leaves(small, stand_in):
    cfg, model = small
    assert GRAPH_SIGNATURES == 4
    sizes = [1, 2, 3, 4]
    for B in sizes:                               # seen once, then captured
        _encode(model, _batch(cfg, B))
        _encode(model, _batch(cfg, B))
    assert len(stand_in) == 4
    _encode(model, _batch(cfg, 1))                # 1 is now the newest
    _encode(model, _batch(cfg, 5))                # 2 leaves
    assert len(model.graphs._known) == 4
    _encode(model, _batch(cfg, 1))
    assert len(stand_in) == 4                     # 1 replayed
    _encode(model, _batch(cfg, 2))                # 2 seen anew: eager
    assert len(stand_in) == 4
    _encode(model, _batch(cfg, 2))
    assert len(stand_in) == 5


def test_a_replaced_parameter_drops_the_graphs(small, stand_in):
    cfg, model = small
    b = _batch(cfg, 3)
    for _ in range(3):
        _encode(model, b)
    assert len(stand_in) == 1 and stand_in[0].replays == 2
    p = model.change_detector.img.kernel
    with torch.no_grad():
        p.data = p.data * 0.5
        want = model._encoder(model.tensors(b))
    out = _encode(model, b)                       # eager again
    assert len(stand_in) == 1 and stand_in[0].replays == 2
    assert all(torch.equal(out[k], want[k]) for k in ENC)
    _encode(model, b)
    _encode(model, b)
    assert len(stand_in) == 2 and stand_in[1].replays == 2
    # an update in place keeps the graph
    with torch.no_grad():
        p.mul_(2.0)
    _encode(model, b)
    assert len(stand_in) == 2 and stand_in[1].replays == 3


def test_gradients_or_a_generator_run_eager(small, stand_in):
    cfg, model = small
    b = _batch(cfg, 3)
    for _ in range(3):
        model.forward(b)                                  # gradients on
    with torch.no_grad():
        for _ in range(3):                                # dropout
            model.forward(b, gen=torch.Generator().manual_seed(0))
    assert len(model.graphs._known) == 0 and not stand_in
    try:
        model.mesh = SimpleNamespace(data=1)              # a data axis
        for _ in range(3):
            model.decode(b)
        assert len(stand_in) == 1 and stand_in[0].replays == 2
    finally:
        model.mesh = None


def test_a_swapped_config_is_a_new_signature(small, stand_in):
    """A `cfg` swapped between two encodes of one shape (as a `with`
    block that turns `pair_batch` on does) runs eagerly and is captured
    anew, on the operations the new settings choose; swapped back, the
    first graph replays."""
    cfg, model = small
    cd = model.change_detector
    b = _batch(cfg, 3)
    off = cd.cfg
    assert off.pair_batch == "off"
    on = off.replace(pair_batch="on")
    for _ in range(3):
        _encode(model, b)
    assert len(stand_in) == 1 and stand_in[0].replays == 2
    calls = []
    pair = cd._encode_image

    def counted(v, *a):
        calls.append(v.shape[0])
        return pair(v, *a)

    cd._encode_image = counted
    try:
        cd.cfg = on
        with torch.no_grad():
            want = model._encoder(model.tensors(b))
        calls.clear()
        with torch_profile(activities=[ProfilerActivity.CPU]):
            outs = [_encode(model, b) for _ in range(3)]
        # eager, captured, replayed: one [2B] pass each, and the old
        # graph never replayed under the new settings
        assert calls == [6, 6, 6] and len(stand_in) == 2
        assert stand_in[0].replays == 2 and stand_in[1].replays == 2
        assert obs.recorded()["counts"] == {"ekaid.encode.graph": 2,
                                            "ekaid.encode.eager": 1}
        for out in outs:
            assert all(torch.equal(out[k], want[k]) for k in ENC)
        cd.cfg = off.replace()                    # equal settings, new object
        calls.clear()
        _encode(model, b)
        assert calls == [3, 3] and len(stand_in) == 2
        assert stand_in[0].replays == 3
    finally:
        del cd._encode_image
        cd.cfg = off



def test_a_copy_starts_with_no_graph(small, stand_in):
    cfg, model = small
    b = _batch(cfg, 3)
    for _ in range(3):
        _encode(model, b)
    twin = copy.deepcopy(model)
    assert len(twin.graphs._known) == 0 and len(model.graphs._known) == 1
    _encode(twin, b)
    assert len(stand_in) == 1


# ------------------------------------------------------------ on a card --

B = 64


def _card_model(cfg):
    return EkaidModel(cfg, cfg.speaker.vocab_size,
                      policy=Policy.from_config(cfg.dtypes), device="cuda")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    made = {}

    def get(mode0):
        if mode0 not in made:
            cfg = _cfg(mode0, "mimic.yaml")
            model = _card_model(cfg)
            cast_params_for_inference(model, model.policy)
            batches = [_batch(cfg, B, seed=s, size=128) for s in (1, 2, 3)]
            made[mode0] = cfg, model, batches
        return made[mode0]
    return get


def _eager(model, b):
    """A decode whose encode runs eagerly: its signature's first sight,
    on graphs of its own; the model's graphs are put back after."""
    kept, model.graphs = model.graphs, EncodeGraphs()
    try:
        return model.decode(b)
    finally:
        model.graphs = kept


def _gap(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("mode0", [False, True], ids=["mode2", "mode0"])
def test_graphed_decode_equals_eager_on_cuda(card, mode0):
    """The graphed decode gives eager's tokens on every row, and its
    log-probs, module weights and six encoder outputs bit for bit; a
    call's returned tensors are untouched by the next call's replay."""
    cfg, model, batches = card(mode0)
    want = [_eager(model, b) for b in batches]
    torch.cuda.synchronize()
    got, kept = [], []
    for i in range(6):                    # eager, capture, 4 replays
        got.append(model.decode(batches[i % 3]))
        kept.append({k: v.clone() for k, v in got[-1].items()})
    torch.cuda.synchronize()
    assert len(model.graphs._known) == 1
    graph = next(iter(model.graphs._known.values()))
    for i, out in enumerate(got):
        ref = want[i % 3]
        gaps = {k: _gap(out[k], ref[k]) for k in ENC + ("logprobs",
                                                        "module_weights")}
        print(f"\n{'mode0' if mode0 else 'mode2'} call {i}: tokens equal "
              f"{torch.equal(out['seq'], ref['seq'])}, largest gaps "
              f"{max(gaps.values()):.3g} "
              f"({torch.cuda.get_device_name(0)})")
        assert torch.equal(out["seq"], ref["seq"])
        for k, g in gaps.items():
            assert g == 0.0, (k, g)
        for k in ENC:
            # fresh storage, and the values the call returned
            assert out[k].data_ptr() != graph.outputs[k].data_ptr()
            assert torch.equal(out[k], kept[i][k]), (i, k)


def test_cast_after_a_capture_gives_eager_numbers_on_cuda():
    """An f32 model captured, then cast for inference: the graphs are
    dropped, and the decode gives the eager numbers on the cast
    weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _cfg(path="mimic.yaml")
    model = _card_model(cfg)
    b = _batch(cfg, B, seed=4)
    for _ in range(3):
        model.decode(b)
    assert next(iter(model.graphs._known.values())) is not None
    cast_params_for_inference(model, model.policy)
    want = _eager(model, b)
    for i in range(3):
        out = model.decode(b)
        assert torch.equal(out["seq"], want["seq"]), i
        for k in ENC + ("logprobs", "module_weights"):
            assert torch.equal(out[k], want[k]), (i, k)
    assert next(iter(model.graphs._known.values())) is not None


def _kernels(model, b, graphed):
    if graphed:
        for _ in range(3):
            model.decode(b)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            model.decode(b) if graphed else _eager(model, b)
        torch.cuda.synchronize()
    return Counter(e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation()
                   and not e.name().startswith(("Memcpy", "Memset")))


@pytest.mark.parametrize("mode0", [False, True], ids=["mode2", "mode0"])
def test_trace_sees_the_same_kernels_on_cuda(card, mode0):
    """A trace of 2 graphed decodes shows the kernels, by name and count,
    of 2 eager ones, besides the copies into and out of the graph."""
    cfg, model, batches = card(mode0)
    eager = _kernels(model, batches[0], False)
    graphed = _kernels(model, batches[0], True)
    extra = graphed - eager
    missing = eager - graphed
    print(f"\n{'mode0' if mode0 else 'mode2'}: {sum(eager.values())} eager "
          f"kernels over 2 decodes, {sum(graphed.values())} graphed; only "
          f"graphed {dict(extra)}; only eager {dict(missing)}")
    assert not missing
    # the input and output copies are elementwise copy kernels
    assert all("copy" in k.lower() or "elementwise" in k.lower()
               for k in extra)


@pytest.mark.parametrize("mode0", [False, True], ids=["mode2", "mode0"])
def test_capture_under_a_profiler_on_cuda(card, mode0):
    """A signature seen, captured and replayed while torch.profiler
    records the CPU and CUDA activity (as `train.test --profile DIR`
    does over a whole eval): eager's numbers bit for bit, during the
    trace and after it, and the trace holds the kernels of the eager
    run and of every replay."""
    cfg, model, batches = card(mode0)
    b = batches[0]
    want = _eager(model, b)
    once = _kernels(model, b, False)                  # 2 eager decodes
    model.graphs = EncodeGraphs()
    try:
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            outs = [model.decode(b) for _ in range(4)]   # eager, capture,
            torch.cuda.synchronize()                     # 2 replays
        outs.append(model.decode(b))                     # after the trace
        torch.cuda.synchronize()
        assert isinstance(next(iter(model.graphs._known.values())),
                          ekaid._Graph)
    finally:
        model.graphs = EncodeGraphs()
    for i, out in enumerate(outs):
        assert torch.equal(out["seq"], want["seq"]), i
        for k in ENC + ("logprobs", "module_weights"):
            assert torch.equal(out[k], want[k]), (i, k)
    traced = Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and not e.is_user_annotation()
        and not e.name().startswith(("Memcpy", "Memset")))
    # 4 decodes ran their kernels: the eager one and 3 replays
    short = {k: (traced[k], 2 * n) for k, n in once.items()
             if traced[k] < 2 * n}
    print(f"\n{'mode0' if mode0 else 'mode2'}: {sum(traced.values())} "
          f"kernels over 4 profiled decodes (capture among them), "
          f"{sum(once.values())} over 2 eager; under twice those "
          f"{short} ({torch.cuda.get_device_name(0)})")
    assert not short
