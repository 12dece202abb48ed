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

Under a profiler the decode is traced as spans `ekaid.lm.connect` (the
projector and the prompt's assembly), `ekaid.lm.prefill` and one
`ekaid.lm.step` a step, with the counters `ekaid.lm.prefill_tokens`
(rows x prompt length) and `ekaid.lm.steps`
(`utils/observability.py`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ekaid_torch.models.deepseek_v2 import DeepseekV2, RMSNorm
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
        cache = self.new_cache(B, L + T - 1)
        rot = self.rope(cache.length)
        with span("ekaid.lm.prefill"):
            logits = self.prefill(x, cache, rot)
        count("ekaid.lm.prefill_tokens", B * L)
        seq = torch.full((B, T), END, dtype=torch.int32, device=dev)
        lps = torch.zeros(B, T, dtype=torch.float32, device=dev)
        ended = torch.zeros(B, dtype=torch.bool, device=dev)
        pos = torch.full((1,), L, dtype=torch.long, device=dev)
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
                    logits = self.step(torch.where(ended, eos, tok), cache,
                                       pos, rot)
                    pos += 1
            count("ekaid.lm.steps", 1)
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

