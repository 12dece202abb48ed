"""The language-model answer decoder: DeepSeek-V2 (`models/deepseek_v2.py`)
behind a LLaVA-1.5 projector, in place of the `DynamicSpeaker` LSTM
where the config's `decoder` is 'lm'.

A batch's prompt is one sequence a row:

  1. the change encoder's relation-encoded nodes of the main image and
     of the reference image (`nodes_bef`, `nodes_aft`, [B, N, att_dim]),
     then its pooled `feat_bef`, `feat_diff` and `feat_aft`, 2N + 3
     vectors through the projector (`mlp2x_gelu`: att_dim -> hidden,
     GELU, hidden -> hidden);
  2. the question's ids, pads kept, so that every row has the same
     length, through the LM's own embedding table (the dataset's word
     ids are taken as the LM's ids);
  3. BOS.

The prefill runs the prompt through every layer, writing the latent
cache, and the last position's logits give the first token. Then
greedy decode steps through the cache, one token a step, up to
`speaker.seq_length` tokens: step t picks token t (argmax, the lowest
id among equal maxima) and, but at the last step, runs it through the
model for the next logits. A row ends at EOS: its EOS position and
every later one read `END` (-1), the log-prob of EOS kept at its
position and 0 after. The loop stops early once every row has ended,
read from a flag copied to pinned host memory behind each step (the
loop never waits for it), so a decode that stops early returns what
the whole loop would.

Where the routed experts run as grouped products (bf16 on CUDA), a
step's forward is replayed as a CUDA graph per signature (`StepGraphs`:
rows, cache length, dtype, device), in place of its ~2,000 launches:
the graph reads the ids and the position and writes the cache and the
logits at fixed addresses, which the decode takes for its own; the
prefill and each step's bookkeeping (argmax, log-prob, the END writes,
the end flags) stay eager. Elsewhere every step runs eagerly.

Under a profiler the decode is traced as spans `ekaid.lm.connect` (the
projector and the prompt's assembly), `ekaid.lm.prefill` and one
`ekaid.lm.step` a step, with the counters `ekaid.lm.prefill_tokens`
(rows x prompt length), `ekaid.lm.steps`, and `ekaid.lm.graph` or
`ekaid.lm.eager` (one a step, by whether the decode's forwards replay
a graph) (`utils/observability.py`).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import torch
from torch import nn

from ekaid_torch.models.deepseek_v2 import (DeepseekV2, RMSNorm,
                                            grouped_products_apply)
from ekaid_torch.utils.observability import count, span

#: a decoded position at or after the row's EOS
END = -1
#: the std of the seeded weights (the published initializer_range)
INIT_STD = 0.02


class LMDecoder(DeepseekV2):
    """The LM with the projector in front. `cfg` is the whole Config:
    `lm` the LM, `change_detector.att_dim` the projector's input width,
    `speaker.seq_length` the answer's cap."""

    def __init__(self, cfg):
        super().__init__(cfg.lm)
        D = cfg.lm.hidden_size
        self.seq_length = cfg.speaker.seq_length
        self.projector = nn.Sequential(
            nn.Linear(cfg.change_detector.att_dim, D), nn.GELU(),
            nn.Linear(D, D))
        self.step_graphs = StepGraphs()

    def _reset(self, gen: torch.Generator):
        """Seeded weights on the parameters' device: matrices and tables
        N(0, INIT_STD), norms 1, biases 0, drawn from a generator there
        seeded by one draw of `gen`."""
        dev = self.lm_head.weight.device
        g = torch.Generator(device=dev)
        g.manual_seed(int(torch.randint(2 ** 62, (1,), generator=gen)))
        norms = {id(m.weight) for m in self.modules()
                 if isinstance(m, RMSNorm)}
        for name, p in self.named_parameters():
            if id(p) in norms:
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=g, device=dev)
                        * INIT_STD)

    def prompt(self, enc: Dict[str, torch.Tensor],
               question: torch.Tensor) -> torch.Tensor:
        """The prompt's embeddings [B, 2N + 3 + Lq + 1, hidden]."""
        dt = self.lm_head.weight.dtype
        vis = torch.cat([enc["nodes_bef"], enc["nodes_aft"],
                         enc["feat_bef"][:, None], enc["feat_diff"][:, None],
                         enc["feat_aft"][:, None]], 1).to(dt)
        ids = torch.cat([question.long(), torch.full_like(
            question[:, :1], self.lm_cfg.bos_token_id, dtype=torch.long)], 1)
        return torch.cat([self.projector(vis), self.embed_tokens(ids)], 1)

    @torch.no_grad()
    def generate(self, enc: Dict[str, torch.Tensor], question: torch.Tensor,
                 max_len: Optional[int] = None,
                 early_exit: bool = True) -> Dict[str, torch.Tensor]:
        """Greedy answers: seq [B, T] int32 (LM ids, END from each row's
        EOS on) and logprobs [B, T] f32."""
        T = max_len or self.seq_length
        eos = self.lm_cfg.eos_token_id
        with span("ekaid.lm.connect"):
            x = self.prompt(enc, question)
        B, L, _ = x.shape
        dev = x.device
        graph = self.step_graphs(self, B, L + T - 1) if graphs_apply(x) \
            else None
        if graph is None:
            cache = self.new_cache(B, L + T - 1)
            rot = self.rope(cache.length)
            pos = torch.full((1,), L, dtype=torch.long, device=dev)
        else:
            cache, rot, pos = graph.cache, graph.rot, graph.pos
            cache.data.zero_()
            pos.fill_(L)
        with span("ekaid.lm.prefill"):
            logits = self.prefill(x, cache, rot)
        count("ekaid.lm.prefill_tokens", B * L)
        seq = torch.full((B, T), END, dtype=torch.int32, device=dev)
        lps = torch.zeros(B, T, dtype=torch.float32, device=dev)
        ended = torch.zeros(B, dtype=torch.bool, device=dev)
        watch = _EndWatch(T, dev)
        for t in range(T):
            if early_exit and watch.all_ended():
                break
            with span("ekaid.lm.step"):
                tok = logits.argmax(-1)
                lp = logits.gather(1, tok[:, None])[:, 0] - torch.logsumexp(
                    logits, -1)
                live = ~ended
                lps[:, t] = lp * live
                ended = ended | (tok == eos)
                seq[:, t] = torch.where(ended, END, tok).to(torch.int32)
                watch.post(t, ended)
                if t + 1 < T:
                    ids = torch.where(ended, eos, tok)
                    if graph is None:
                        logits = self.step(ids, cache, pos, rot)
                        pos += 1
                    else:
                        logits = graph.replay(ids)
            count("ekaid.lm.steps", 1)
            count("ekaid.lm.graph", int(graph is not None))
            count("ekaid.lm.eager", int(graph is None))
        return {"seq": seq, "logprobs": lps}


class _EndWatch:
    """Whether every row has ended, read without waiting on the device:
    on CUDA each step's flag is copied to pinned host memory behind the
    step and read once its event has completed; elsewhere read at
    once."""

    def __init__(self, steps: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.done = False
        if self.cuda:
            self.flags = torch.zeros(steps, dtype=torch.bool,
                                     pin_memory=True)
            self.events = []

    def post(self, t: int, ended: torch.Tensor) -> None:
        if not self.cuda:
            self.done = bool(ended.all())
            return
        self.flags[t].copy_(ended.all(), non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.events.append((t, ev))

    def all_ended(self) -> bool:
        if self.cuda:
            while not self.done and self.events and self.events[0][1].query():
                t, _ = self.events.pop(0)
                self.done = bool(self.flags[t])
        return self.done


def graphs_apply(x: torch.Tensor) -> bool:
    """Whether the decode steps over the prompt `x` replay a CUDA graph:
    where the routed experts run as grouped products (bf16 on CUDA),
    which read nothing back to the host. The per-expert loop reads its
    slices' lengths on the host, so its steps run eagerly."""
    return grouped_products_apply(x)


class _StepGraph:
    """One captured decode step (`DeepseekV2.step`, then the position's
    increment) and the buffers it reads and writes at fixed addresses:
    the latent cache, the rotations, the position, the ids and the
    logits. A replay's logits are overwritten by the next replay, which
    the stream orders after every read of them."""

    def __init__(self, lm: DeepseekV2, batch: int, length: int):
        self.cache = lm.new_cache(batch, length)
        self.rot = lm.rope(length)
        dev = self.rot.device
        self.pos = torch.zeros(1, dtype=torch.long, device=dev)
        self.ids = torch.zeros(batch, dtype=torch.long, device=dev)
        self._capture(lambda: self._forward(lm))

    def _forward(self, lm: DeepseekV2) -> torch.Tensor:
        logits = lm.step(self.ids, self.cache, self.pos, self.rot)
        self.pos += 1
        return logits

    def _capture(self, forward) -> None:
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.rot.device):
            # other threads (a loader, a server's) may use the device
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.logits = forward()

    def replay(self, ids: torch.Tensor) -> torch.Tensor:
        """The logits [B, V] of `ids` [B] at the position, which then
        moves on by one."""
        self.ids.copy_(ids)
        self.graph.replay()
        return self.logits


class StepGraphs:
    """The decode step replayed as a CUDA graph per signature: rows,
    cache length, and the LM's dtype and device. The last
    `GRAPH_SIGNATURES` signatures are kept, least recently used out
    (`models/ekaid.py::EncodeGraphs` keeps the encoder's by the same
    rules).

    A signature runs eagerly at its first sight, the run that settles
    the libraries' choices of algorithm and workspace; it is captured at
    its second and replayed from then on. A graph reads the parameters
    at the addresses they had when it was captured, so every graph is
    dropped when a parameter's identity, storage or dtype changes (a
    cast, a load that replaces `p.data`, a move to another device); an
    update in place keeps them. A copy starts with no graph."""

    def __init__(self):
        #: signature -> None (seen once) or its `_StepGraph`, oldest first
        self._known: "OrderedDict[tuple, Optional[_StepGraph]]" = \
            OrderedDict()
        self._params: Optional[list] = None

    def __deepcopy__(self, memo):
        return StepGraphs()

    def __call__(self, lm: DeepseekV2, batch: int,
                 length: int) -> Optional[_StepGraph]:
        """The graph of `lm`'s step at `batch` rows over a cache of
        `length` positions, or None where the signature runs eagerly."""
        # imported here: models/ekaid.py imports this module
        from ekaid_torch.models.ekaid import GRAPH_SIGNATURES, _state_key
        params = []
        _state_key(lm, params, [])
        if params != self._params:
            self._known.clear()
            self._params = params
        w = lm.lm_head.weight
        sig = (batch, length, w.dtype, w.device)
        if sig not in self._known:
            self._known[sig] = None
            while len(self._known) > GRAPH_SIGNATURES:
                self._known.popitem(last=False)
            return None
        self._known.move_to_end(sig)
        graph = self._known[sig]
        if graph is None:
            graph = self._known[sig] = _StepGraph(lm, batch, length)
        return graph
