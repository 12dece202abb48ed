"""The LM's decode step as a CUDA graph (`models/lm_decoder.py::
StepGraphs`).

On the CPU: every step runs eagerly, in f32 and in bf16, counts as
`ekaid.lm.eager`, and gives the tokens, log-probs and cache of the
decode written out with `prefill` and `step`. With a stand-in for the
capture, whose replays run the captured forward eagerly on the graph's
own buffers (cache, rotations, position, ids): a signature runs eagerly
at its first sight, is captured at its second and replayed after, with
the eager decode's numbers bit for bit; a new batch size or answer cap
starts over; the least recently used signature leaves past the bound;
a replaced parameter drops the graphs; a copy starts with none; an
early exit through replays returns what the whole loop returns.

On a card (skipped without one), at small widths that keep 64 routed
experts, top-6, 2 shared and B=64, in bf16: the graphed decode against
the eager one, bit for bit (tokens, log-probs and cache); the path by
sight; two batch sizes and the eviction; a parameter swap; an early
exit with EOS favoured; and, under torch.profiler, each replay's kernels
under a `cudaGraphLaunch` inside `ekaid.lm.step`, as many as an eager
step launches. Run there with `python -m pytest --noconftest
tests/test_torch_lm_graph.py -q -s`.
"""

import copy
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

from ekaid_torch.config import load_config, merge_overrides
from ekaid_torch.models import lm_decoder
from ekaid_torch.models.ekaid import GRAPH_SIGNATURES
from ekaid_torch.models.lm_decoder import END, LMDecoder, StepGraphs
from ekaid_torch.utils import observability as obs

ROOT = Path(__file__).resolve().parent.parent
#: small widths with DeepSeek-V2-Lite's expert layout: 64 routed
#: experts, top-6, 2 shared; layer 0 dense, layers 1-2 MoE
LM = {"vocab_size": 512, "hidden_size": 128, "intermediate_size": 256,
      "moe_intermediate_size": 64, "num_hidden_layers": 3,
      "num_attention_heads": 4, "num_key_value_heads": 4,
      "n_routed_experts": 64, "num_experts_per_tok": 6,
      "n_shared_experts": 2, "kv_lora_rank": 64, "qk_nope_head_dim": 32,
      "qk_rope_head_dim": 16, "v_head_dim": 32, "bos_token_id": 500,
      "eos_token_id": 501}
#: the question's length
LQ = 6


def _cfg():
    return merge_overrides(load_config(str(ROOT / "configs" / "smoke.yaml")),
                           {"decoder": "lm", "lm": LM})


def _lm(dtype=torch.float32, device="cpu", seed=0):
    cfg = _cfg()
    with torch.device(device):
        lm = LMDecoder(cfg)
    with torch.no_grad():
        lm._reset(torch.Generator().manual_seed(seed))
    return lm.to(dtype).eval()


def _inputs(lm, B, seed=0, distinct=None):
    """The encoder's outputs the prompt reads, and a question: B rows,
    or `distinct` rows repeated to B."""
    cfg = _cfg()
    dev = lm.lm_head.weight.device
    g = torch.Generator().manual_seed(seed)
    n = distinct or B
    N, D = cfg.data.num_nodes, cfg.change_detector.att_dim
    enc = {"nodes_bef": torch.randn(n, N, D, generator=g),
           "nodes_aft": torch.randn(n, N, D, generator=g),
           "feat_bef": torch.randn(n, D, generator=g),
           "feat_diff": torch.randn(n, D, generator=g),
           "feat_aft": torch.randn(n, D, generator=g)}
    q = torch.randint(0, LM["bos_token_id"], (n, LQ), generator=g)
    rows = torch.arange(B) % n
    return ({k: v[rows].to(dev) for k, v in enc.items()},
            q[rows].to(dev))


@torch.no_grad()
def _loop(lm, enc, q, T=None):
    """The greedy decode written out with `prefill` and `step`: seq,
    logprobs and the cache."""
    T = T or lm.seq_length
    eos = lm.lm_cfg.eos_token_id
    x = lm.prompt(enc, q)
    B, L, _ = x.shape
    cache = lm.new_cache(B, L + T - 1)
    rot = lm.rope(cache.length)
    logits = lm.prefill(x, cache, rot)
    pos = torch.full((1,), L, dtype=torch.long, device=x.device)
    seq = torch.full((B, T), END, dtype=torch.int32, device=x.device)
    lps = torch.zeros(B, T, device=x.device)
    ended = torch.zeros(B, dtype=torch.bool, device=x.device)
    for t in range(T):
        tok = logits.argmax(-1)
        lp = logits.gather(1, tok[:, None])[:, 0] - torch.logsumexp(
            logits, -1)
        lps[:, t] = lp * ~ended
        ended = ended | (tok == eos)
        seq[:, t] = torch.where(ended, END, tok).to(torch.int32)
        if t + 1 < T:
            logits = lm.step(torch.where(ended, eos, tok), cache, pos, rot)
            pos += 1
    return {"seq": seq, "logprobs": lps}, cache.data


def _counts():
    c = obs.recorded()["counts"]
    return {k: c.get(k) for k in ("ekaid.lm.steps", "ekaid.lm.graph",
                                  "ekaid.lm.eager")}


def _favour_eos(lm, decode, factor=40.0):
    """Makes EOS's logit `factor` x a token's, so that a row ends at a
    step where that token's logit is positive: the first token of 0-63
    under which `decode(lm)` ends every row, at different steps.
    Returns that decode's outputs."""
    w = lm.lm_head.weight
    eos = lm.lm_cfg.eos_token_id
    kept = w[eos].clone()
    for token in range(64):
        with torch.no_grad():
            w[eos] = factor * w[token]
        out = decode(lm)
        seq = out["seq"]
        ends = (seq == END).int().argmax(1)
        if bool((seq == END).any(1).all()) and ends.min() < ends.max():
            return out
    with torch.no_grad():
        w[eos] = kept
    raise AssertionError("no token of 0-63 ends every row")


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset_recorded()
    yield
    obs.reset_recorded()


# ------------------------------------------------------------ the CPU --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cpu_steps_run_eager_with_the_loops_numbers(dtype):
    lm = _lm(dtype)
    enc, q = _inputs(lm, 3)
    want, want_cache = _loop(lm, enc, q)
    caches = []
    new = lm.new_cache

    def spy(b, n):
        caches.append(new(b, n))
        return caches[-1]

    lm.new_cache = spy
    with torch_profile(activities=[ProfilerActivity.CPU]):
        outs = [lm.generate(enc, q) for _ in range(3)]
    T = lm.seq_length
    assert not lm_decoder.graphs_apply(lm.prompt(enc, q))
    assert len(lm.step_graphs._known) == 0 and len(caches) == 3
    assert _counts() == {"ekaid.lm.steps": 3 * T, "ekaid.lm.graph": 0,
                         "ekaid.lm.eager": 3 * T}
    for out, cache in zip(outs, caches):
        assert torch.equal(out["seq"], want["seq"])
        assert torch.equal(out["logprobs"], want["logprobs"])
        assert torch.equal(cache.data, want_cache)


class _Replay(lm_decoder._StepGraph):
    """Stands in for a captured step: a replay runs the forward the
    capture would have recorded, eagerly, on the graph's own buffers."""

    def _capture(self, forward):
        self.forward = forward
        self.replays = 0

    def replay(self, ids):
        self.replays += 1
        self.ids.copy_(ids)
        self.logits = self.forward()
        return self.logits


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs on the CPU, each capture a `_Replay`; yields the list of
    captures."""
    captures = []

    def capture(lm, batch, length):
        captures.append(_Replay(lm, batch, length))
        return captures[-1]

    monkeypatch.setattr(lm_decoder, "graphs_apply", lambda x: True)
    monkeypatch.setattr(lm_decoder, "_StepGraph", capture)
    yield captures


def _sig(graphs):
    return [(s[0], s[1], g is not None) for s, g in graphs._known.items()]


def test_first_sight_eager_second_captures_third_replays(stand_in):
    lm = _lm()
    enc, q = _inputs(lm, 3)
    want, want_cache = _loop(lm, enc, q)
    T = lm.seq_length
    L = 2 * _cfg().data.num_nodes + 3 + LQ + 1
    with torch_profile(activities=[ProfilerActivity.CPU]):
        outs = [lm.generate(enc, q)]
        assert _sig(lm.step_graphs) == [(3, L + T - 1, False)]
        assert not stand_in
        outs += [lm.generate(enc, q) for _ in range(3)]
    assert _sig(lm.step_graphs) == [(3, L + T - 1, True)]
    assert len(stand_in) == 1 and stand_in[0].replays == 3 * (T - 1)
    assert _counts() == {"ekaid.lm.steps": 4 * T, "ekaid.lm.graph": 3 * T,
                         "ekaid.lm.eager": T}
    for out in outs:
        assert torch.equal(out["seq"], want["seq"])
        assert torch.equal(out["logprobs"], want["logprobs"])
    # the graph's cache, zeroed and filled again by each decode
    assert torch.equal(stand_in[0].cache.data, want_cache)
    assert int(stand_in[0].pos) == L + T - 1
    # another input of the same signature replays the same graph
    enc2, q2 = _inputs(lm, 3, seed=1)
    want2, cache2 = _loop(lm, enc2, q2)
    out2 = lm.generate(enc2, q2)
    assert len(stand_in) == 1 and stand_in[0].replays == 4 * (T - 1)
    assert torch.equal(out2["seq"], want2["seq"])
    assert torch.equal(out2["logprobs"], want2["logprobs"])
    assert torch.equal(stand_in[0].cache.data, cache2)


def test_batch_sizes_and_caps_are_signatures_the_oldest_leaves(stand_in):
    lm = _lm()
    assert GRAPH_SIGNATURES == 4
    inputs = {B: _inputs(lm, B, seed=B) for B in (1, 2, 3, 4, 5)}

    def gen(B, T=None):
        enc, q = inputs[B]
        out = lm.generate(enc, q, max_len=T)
        want, _ = _loop(lm, enc, q, T)
        assert torch.equal(out["seq"], want["seq"]), (B, T)
        assert torch.equal(out["logprobs"], want["logprobs"]), (B, T)

    for B in (1, 2, 3, 4):                  # seen once, then captured
        gen(B)
        gen(B)
    assert len(stand_in) == 4
    assert [s[0] for s in _sig(lm.step_graphs)] == [1, 2, 3, 4]
    gen(1)                                  # 1 is now the newest
    gen(5)                                  # 2 leaves
    assert [s[0] for s in _sig(lm.step_graphs)] == [3, 4, 1, 5]
    gen(1)
    assert len(stand_in) == 4               # 1 replayed
    gen(2)                                  # 2 seen anew: eager
    assert len(stand_in) == 4
    gen(2)
    assert len(stand_in) == 5
    # another answer cap is another cache length: eager, then captured
    gen(2, T=5)
    assert len(stand_in) == 5
    gen(2, T=5)
    assert len(stand_in) == 6 and stand_in[-1].cache.length == \
        stand_in[-2].cache.length - (lm.seq_length - 5)


def test_a_replaced_parameter_drops_the_graphs(stand_in):
    lm = _lm()
    enc, q = _inputs(lm, 3)
    for _ in range(3):
        lm.generate(enc, q)
    assert len(stand_in) == 1
    replays = stand_in[0].replays
    p = lm.layers[1].mlp.experts.up_proj
    with torch.no_grad():
        p.data = p.data * 0.5
    want, _ = _loop(lm, enc, q)
    out = lm.generate(enc, q)                       # eager again
    assert len(stand_in) == 1 and stand_in[0].replays == replays
    assert _sig(lm.step_graphs) == [(3, stand_in[0].cache.length, False)]
    assert torch.equal(out["seq"], want["seq"])
    lm.generate(enc, q)
    out = lm.generate(enc, q)
    assert len(stand_in) == 2
    assert torch.equal(out["logprobs"], want["logprobs"])
    # an update in place keeps the graph
    with torch.no_grad():
        p.mul_(2.0)
    lm.generate(enc, q)
    assert len(stand_in) == 2


def test_a_copy_starts_with_no_graph(stand_in):
    lm = _lm()
    enc, q = _inputs(lm, 3)
    for _ in range(3):
        lm.generate(enc, q)
    twin = copy.deepcopy(lm)
    assert len(twin.step_graphs._known) == 0
    assert len(lm.step_graphs._known) == 1
    twin.generate(enc, q)
    assert len(stand_in) == 1


def test_early_exit_through_replays_returns_the_whole_loop(stand_in):
    lm = _lm()
    enc, q = _inputs(lm, 8, seed=2)
    T = 30
    want = _favour_eos(lm, lambda m: _loop(m, enc, q, T)[0])
    ends = (want["seq"] == END).int().argmax(1)
    assert ends.max() < T - 1
    outs = []
    with torch_profile(activities=[ProfilerActivity.CPU]):
        for early in (True, True, True, False):     # eager, capture, ...
            outs.append(lm.generate(enc, q, max_len=T, early_exit=early))
    # each early exit stops at the step after the last row's end
    run = obs.recorded()["counts"]["ekaid.lm.steps"]
    assert run == 3 * (int(ends.max()) + 1) + T
    assert len(stand_in) == 1
    for out in outs:
        assert torch.equal(out["seq"], want["seq"])
        assert torch.equal(out["logprobs"], want["logprobs"])


# ------------------------------------------------------------ on a card --

B = 64


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph and the grouped "
                    "products run only there")
    return torch.device("cuda")


def _card_lm(card, seed=0):
    lm = _lm(torch.bfloat16, card, seed)
    assert lm_decoder.graphs_apply(lm.lm_head.weight)
    return lm


def _eager(lm, enc, q, **kw):
    """A decode on graphs of its own, so its signature's first sight:
    eager; the LM's graphs are put back after. Returns the outputs and
    the cache."""
    kept, lm.step_graphs = lm.step_graphs, StepGraphs()
    caches = []
    new = lm.new_cache

    def spy(b, n):
        caches.append(new(b, n))
        return caches[-1]

    lm.new_cache = spy
    try:
        out = lm.generate(enc, q, **kw)
    finally:
        lm.step_graphs = kept
        del lm.new_cache
    return out, caches[0].data


def _graph(lm):
    graphs = [g for g in lm.step_graphs._known.values() if g is not None]
    assert len(graphs) == 1
    return graphs[0]


def _same(out, want, tag):
    assert torch.equal(out["seq"], want["seq"]), tag
    assert torch.equal(out["logprobs"], want["logprobs"]), tag


def test_graphed_generate_equals_eager_on_cuda(card):
    """Eager, captured, then replayed decodes of three inputs: the eager
    decode's tokens, log-probs and cache, bit for bit, and counted by
    path."""
    lm = _card_lm(card)
    inputs = [_inputs(lm, B, seed=s) for s in (1, 2, 3)]
    want = [_eager(lm, *x) for x in inputs]
    T = lm.seq_length
    got = []
    with torch_profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            out = lm.generate(*inputs[i % 3])
            torch.cuda.synchronize()
            got.append(out)
            if i == 0:
                assert _sig(lm.step_graphs)[0][2] is False
            else:
                graph = _graph(lm)
                assert isinstance(graph, lm_decoder._StepGraph)
                assert torch.equal(graph.cache.data, want[i % 3][1]), i
    assert _counts() == {"ekaid.lm.steps": 6 * T, "ekaid.lm.graph": 5 * T,
                         "ekaid.lm.eager": T}
    for i, out in enumerate(got):
        _same(out, want[i % 3][0], i)
    rows = {tuple(r) for r in got[1]["seq"].tolist()}
    print(f"\n{len(rows)} distinct answers of {B}, "
          f"{torch.cuda.get_device_name(0)}")


def test_batch_sizes_and_eviction_on_cuda(card):
    """B=64 and B=32 are two graphs, each giving its eager numbers;
    past `GRAPH_SIGNATURES` sizes the least recently used leaves and is
    seen anew."""
    lm = _card_lm(card)
    sizes = [64, 32, 16, 8, 4]
    inputs = {b: _inputs(lm, b, seed=b) for b in sizes}
    want = {b: _eager(lm, *inputs[b])[0] for b in sizes}
    for b in (64, 32):
        for i in range(3):
            _same(lm.generate(*inputs[b]), want[b], (b, i))
    graphs = [g for g in lm.step_graphs._known.values()]
    assert len(graphs) == 2 and all(graphs)
    assert graphs[0].cache.data.shape[1] == 64
    assert graphs[1].cache.data.shape[1] == 32
    for b in (16, 8, 4):
        _same(lm.generate(*inputs[b]), want[b], b)
        _same(lm.generate(*inputs[b]), want[b], b)
    assert [s[0] for s in _sig(lm.step_graphs)] == [32, 16, 8, 4]
    _same(lm.generate(*inputs[64]), want[64], "64 anew")
    assert [s[0] for s in _sig(lm.step_graphs)] == [16, 8, 4, 64]
    assert _sig(lm.step_graphs)[-1][2] is False


def test_a_parameter_swap_drops_the_graphs_on_cuda(card):
    lm = _card_lm(card)
    enc, q = _inputs(lm, B, seed=4)
    for _ in range(3):
        lm.generate(enc, q)
    old = _graph(lm)
    p = lm.layers[2].mlp.experts.down_proj
    with torch.no_grad():
        p.data = p.data * 2.0
    want, cache = _eager(lm, enc, q)
    out = lm.generate(enc, q)                     # eager again
    assert _sig(lm.step_graphs)[0][2] is False
    _same(out, want, "after the swap")
    for i in range(2):
        _same(lm.generate(enc, q), want, i)
    assert _graph(lm) is not old
    assert torch.equal(_graph(lm).cache.data, cache)


def test_early_exit_with_eos_favoured_on_cuda(card):
    """Rows end at different steps; the early exit, eager or through
    replays, returns what the whole loop returns. The 64 rows repeat 8
    prompts, so that one token can end them all."""
    lm = _card_lm(card)
    enc, q = _inputs(lm, B, seed=5, distinct=8)
    T = 30
    whole = _favour_eos(lm, lambda m: _eager(m, enc, q, max_len=T,
                                             early_exit=False)[0])
    ends = (whole["seq"] == END).int().argmax(1)
    print(f"\nrows end at steps {int(ends.min())}-{int(ends.max())}")
    eager, _ = _eager(lm, enc, q, max_len=T)
    _same(eager, whole, "eager early exit")
    with torch_profile(activities=[ProfilerActivity.CPU]):
        outs = [lm.generate(enc, q, max_len=T) for _ in range(3)]
        torch.cuda.synchronize()
    # the host runs ahead of the replays, so the loop may stop later
    # than the last row's end; what it returns is the whole loop's
    steps = obs.recorded()["counts"]["ekaid.lm.steps"]
    print(f"{steps} steps run over 3 early-exit decodes of cap {T}")
    for i, out in enumerate(outs):
        _same(out, whole, i)
    _same(lm.generate(enc, q, max_len=T, early_exit=False), whole, "whole")


def _device_ops(prof):
    """(device ops by the correlation id of their launch, host events):
    the kineto events of a finished profile."""
    by_corr = Counter()
    host = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and e.correlation_id():
                by_corr[e.correlation_id()] += 1
        else:
            host.append((e.name(), e.start_ns(),
                         e.start_ns() + e.duration_ns(),
                         e.start_thread_id(), e.correlation_id()))
    return by_corr, host


def test_replayed_kernels_sit_under_a_graph_launch_in_the_step_span_on_cuda(
        card):
    """Under torch.profiler: each replayed step's kernels carry the
    correlation id of one `cudaGraphLaunch` made inside an
    `ekaid.lm.step` span, as many as an eager step's forward launches
    (the step and the position's increment)."""
    lm = _card_lm(card)
    enc, q = _inputs(lm, B, seed=6)
    for _ in range(2):                      # seen, then captured
        lm.generate(enc, q)
    torch.cuda.synchronize()
    g = _graph(lm)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        lm.generate(enc, q)
        torch.cuda.synchronize()
    by_corr, host = _device_ops(prof)
    spans = sorted((a, b, tid) for n, a, b, tid, _ in host
                   if n == "ekaid.lm.step")
    launches = [(a, tid, c) for n, a, _, tid, c in host
                if n.startswith("cudaGraphLaunch")]
    assert len(spans) == lm.seq_length
    assert len(launches) == lm.seq_length - 1
    for a, tid, _ in launches:
        assert any(s <= a <= e and t == tid for s, e, t in spans)
    per_replay = [by_corr[c] for _, _, c in launches]
    # an eager step's forward, on the graph's buffers at a position
    # inside the cache (the decode left it one past the end)
    g.pos.fill_(g.cache.length - 1)
    with torch.no_grad(), torch_profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p2:
        g._forward(lm)
        torch.cuda.synchronize()
    eager = sum(_device_ops(p2)[0].values())
    print(f"\nan eager step's forward {eager} device ops; replays "
          f"{min(per_replay)}-{max(per_replay)} a launch "
          f"({torch.cuda.get_device_name(0)})")
    assert all(n == eager for n in per_replay), Counter(per_replay)
