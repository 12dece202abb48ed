"""Answer decoder: the two-LSTM speaker, greedy decode (counterpart of
`ekaid_tpu/models/decoder.py`).

The step (`DynamicCore`): a module-attention LSTM on [fused, h_lang]
gives 3-way weights over (bef, diff, aft); a POS head pos1 -> weight_pos
-> softmax -> pos2; a gate on [h_lang, ppos, att]; the language LSTM on
[word embedding, gate * att]; logits over the answer vocab. Free-running
decode primes with `bos_token` (2, as the reference model does), bans
NULL at the first step, optionally bans repeating the previous token,
and stops when every row has emitted 0.

The loop runs in `models/greedy_decode.py`: the CUDA kernel on the card,
its plain version on the CPU. Teacher forcing, multinomial sampling and
beam search are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ekaid_torch.models.greedy_decode import decode_weights, greedy_decode
from ekaid_torch.models.layers import DenseT, LSTMCell, normal_table
from ekaid_torch.utils.dtypes import F32, Policy


class DynamicCore(nn.Module):
    """The parameters of one decode step."""

    def __init__(self, cfg, policy: Policy = F32):
        super().__init__()
        E, R, D = cfg.embed_dim, cfg.rnn_size, cfg.input_dim
        G = 2 * R + D
        self.module_att_lstm = LSTMCell(E + R, R, policy)
        self.weight_fc = DenseT(R, 3, policy=policy)
        self.pos1 = DenseT(R, R, policy=policy)
        self.weight_pos = DenseT(R, cfg.pos_classes, policy=policy)
        self.pos2 = DenseT(cfg.pos_classes, R, policy=policy)
        self.gate1x = DenseT(G, G, policy=policy)
        self.gate2x = DenseT(G, D, policy=policy)
        self.lang_lstm = LSTMCell(cfg.word_embed_size + D, R, policy)


class DynamicSpeaker(nn.Module):
    def __init__(self, cfg, policy: Policy = F32):
        super().__init__()
        self.cfg = cfg
        self.policy = policy
        self.word_emb = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.word_embed_size))
        self.embed = DenseT(cfg.embed_input_dim, cfg.embed_dim,
                            policy=policy)
        self.core = DynamicCore(cfg, policy)
        self.logit = DenseT(cfg.rnn_size, cfg.vocab_size, policy=policy)
        self._weights_key = None
        self._weights = None

    def _reset(self, gen):
        self.word_emb.copy_(normal_table(self.word_emb.shape, gen))

    def _fused(self, feat_bef, feat_diff, feat_aft):
        """fused = relu(embed([bef, diff, aft])) [B, E] and the stacked
        feats [B, 3, D] (bef, diff, aft), in the compute dtype."""
        cast = self.policy.cast_compute
        bef, dif, aft = cast(feat_bef), cast(feat_diff), cast(feat_aft)
        fused = torch.relu(self.embed(torch.cat([bef, dif, aft], dim=-1)))
        return fused, torch.stack([bef, dif, aft], dim=1)

    def decode_weights(self) -> Dict[str, torch.Tensor]:
        """The decode weights in the compute dtype, prepared once per
        parameter set (rebuilt when a parameter moves or changes)."""
        key = tuple((p.data_ptr(), p._version, p.device)
                    for p in self.parameters())
        if key != self._weights_key:
            self._weights = decode_weights(self, self.cfg, self.policy)
            self._weights_key = key
        return self._weights

    def sample(self, feat_bef, feat_aft, feat_diff) -> Dict[str, torch.Tensor]:
        """Greedy free-running decode: seq [B, T] int32, logprobs [B, T]
        and module_weights [B, T, 3] f32 (rows zeroed past EOS)."""
        fused, feats = self._fused(feat_bef, feat_diff, feat_aft)
        return greedy_decode(self.decode_weights(), self.cfg, self.policy,
                             fused, feats)
