"""Answer decoder: the two-LSTM speaker (counterpart of
`ekaid_tpu/models/decoder.py`).

The step (`DynamicCore`): a module-attention LSTM on [fused, h_lang]
gives 3-way weights over (bef, diff, aft); a POS head pos1 -> weight_pos
-> softmax -> pos2; a gate on [h_lang, ppos, att]; the language LSTM on
[word embedding, gate * att]; logits over the answer vocab.

Two modes:
  * `teacher_forcing`, the training path: step i reads seq[:, i] and
    predicts seq[:, i + 1], with scheduled sampling, one dropout mask a
    step, the `train_hoist` input products and the `remat` choices. It
    is plain torch under autograd, as the reference's scan is XLA.
  * `sample`, free-running decode: primes with `bos_token` (2, as the
    reference model does), bans NULL at the first step, optionally bans
    repeating the previous token, and stops when every row has emitted
    0. Greedy, with `decode_kernel` 'auto' or 'pallas': the loop runs in
    `models/greedy_decode.py`, the CUDA kernel K1 on the card and its
    plain version on the CPU. Greedy with 'xla', and every multinomial
    decode (`sample_max=False`): the torch step loop `_sample_loop` on
    either device, as the reference runs its XLA loop; its step is the
    core's, or with `weight_quant='int8'` the core on int8 weights
    (`models/quant.py`). K1 refuses both knobs, as the reference's
    kernel does.
  * `sample_beam`, diverse-group beam search: plain torch on either
    device (the reference runs it as XLA, with no kernel of its own),
    one `DynamicCore` step a group and time step.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from ekaid_torch.models.greedy_decode import decode_weights, greedy_decode
from ekaid_torch.models.layers import (DenseT, LSTMCell, apply_mask,
                                       dropout, normal_table)
from ekaid_torch.utils.dtypes import F32, Policy
from ekaid_torch.utils.platform import resolve_decode_kernel

#: the POS head's dropout rate on its logits (a constant of the model)
POS_DROPOUT = 0.5


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
        self.cfg = cfg
        self.policy = policy

    def forward(self, xt, fused, feats, state, masks=None, mod_pre=None,
                lang_xt_pre=None):
        """One step. xt [B, W] word embedding (None with lang_xt_pre);
        fused [B, E]; feats [B, 3, D]; state (h_mod, c_mod, h_lang,
        c_lang); masks: (vpos, dpos, gate_h) dropout masks or None;
        mod_pre [B, 4R] = fused @ module_att_lstm.w_ih[:E] and
        lang_xt_pre [B, 4R] = xt @ lang_lstm.w_ih[:W], precomputed by
        teacher forcing's hoist (`LSTMCell.pre_product`). Returns
        h_lang, the new state, the POS logits and the module weights
        [B, 3]."""
        c, p = self.cfg, self.policy
        cast = p.cast_compute
        h_mod, c_mod, prev_h, c_lang = state
        m_vpos, m_dpos, m_gate = masks if masks is not None else (None,) * 3
        keep_lm = 1.0 - c.drop_prob_lm
        if mod_pre is None:
            h_mod, c_mod = self.module_att_lstm(
                torch.cat([fused, prev_h], dim=-1), h_mod, c_mod)
        else:
            h_mod, c_mod = self.module_att_lstm(
                prev_h, h_mod, c_mod, pre=mod_pre, pre_width=c.embed_dim)
        module_weights = torch.softmax(p.cast_softmax(self.weight_fc(h_mod)),
                                       dim=-1)
        vpos = apply_mask(torch.relu(self.pos1(prev_h)), m_vpos, keep_lm)
        dpos = apply_mask(self.weight_pos(vpos), m_dpos, 1.0 - POS_DROPOUT)
        ppos = self.pos2(cast(torch.softmax(p.cast_softmax(dpos), dim=-1)))
        att_feat = p.mm(cast(module_weights)[:, None, :],
                        cast(feats))[:, 0]
        gate_in = torch.cat([prev_h, ppos, att_feat], dim=-1)
        gate_h = apply_mask(torch.relu(self.gate1x(gate_in)), m_gate,
                            keep_lm)
        gate = torch.sigmoid(self.gate2x(gate_h))
        if lang_xt_pre is None:
            h_lang, c_lang = self.lang_lstm(
                torch.cat([xt, gate * att_feat], dim=-1), prev_h, c_lang)
        else:
            h_lang, c_lang = self.lang_lstm(
                gate * att_feat, prev_h, c_lang, pre=lang_xt_pre,
                pre_width=c.word_embed_size)
        return h_lang, (h_mod, c_mod, h_lang, c_lang), dpos, module_weights


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

    def _fused(self, feat_bef, feat_diff, feat_aft,
               gen: Optional[torch.Generator] = None):
        """fused = relu(embed([bef, diff, aft])) [B, E] (dropped when a
        generator is given) and the stacked feats [B, 3, D] (bef, diff,
        aft), in the compute dtype."""
        cast = self.policy.cast_compute
        bef, dif, aft = cast(feat_bef), cast(feat_diff), cast(feat_aft)
        fused = dropout(
            torch.relu(self.embed(torch.cat([bef, dif, aft], dim=-1))),
            self.cfg.drop_prob_lm, gen)
        return fused, torch.stack([bef, dif, aft], dim=1)

    def _embed_word(self, it, mask=None):
        """relu(word_emb[it]) in the compute dtype, then the step's
        dropout mask (Embedding -> ReLU -> Dropout). F.embedding, not
        indexing: its gradient sums repeated tokens in a fixed order on
        the CPU too."""
        x = torch.relu(self.policy.cast_compute(
            F.embedding(it.long(), self.word_emb)))
        return apply_mask(x, mask, 1.0 - self.cfg.drop_prob_lm)

    def _out_logprobs(self, h_lang, dpos, mask=None):
        """Answer and POS log-probs of a step, in the softmax dtype; the
        answer head reads h_lang through the step's dropout mask."""
        p = self.policy
        out = apply_mask(h_lang, mask, 1.0 - self.cfg.drop_prob_lm)
        logp = torch.log_softmax(p.cast_softmax(self.logit(out)), dim=-1)
        return logp, torch.log_softmax(p.cast_softmax(dpos), dim=-1)

    def _step_masks(self, T, B, gen, device):
        """Every dropout mask of the T steps, drawn up front in one go
        per site: word [T, B, W], vpos [T, B, R], dpos [T, B, P], gate_h
        [T, B, 2R+D] and out [T, B, R] (bool, True = kept). Drawing them
        outside the step keeps a recomputed step (remat) on its masks."""
        c = self.cfg
        keep_lm = 1.0 - c.drop_prob_lm
        sizes = (c.word_embed_size, c.rnn_size, c.pos_classes,
                 2 * c.rnn_size + c.input_dim, c.rnn_size)
        keeps = (keep_lm, keep_lm, 1.0 - POS_DROPOUT, keep_lm, keep_lm)
        return [torch.rand(T, B, n, generator=gen, device=device) < k
                for n, k in zip(sizes, keeps)]

    def teacher_forcing(self, feat_bef, feat_aft, feat_diff, seq,
                        ss_prob: float = 0.0,
                        gen: Optional[torch.Generator] = None,
                        ss_gen: Optional[torch.Generator] = None
                        ) -> Dict[str, torch.Tensor]:
        """Teacher-forced log-probs: seq [B, T+1] (seq[:, 0] = <start>)
        -> logprobs [B, T, V], pos_logprobs [B, T, P], module_weights
        [B, T, 3]; step i predicts seq[:, i + 1]. T follows seq, so a
        batch trimmed to a length bucket runs a shorter loop.

        gen: dropout draws (None: no dropout). ss_gen: scheduled
        sampling draws, used when gen is given and ss_prob > 0: from
        step 1 on, each row's input is replaced with probability ss_prob
        by a categorical draw from the previous step's log-probs.

        cfg.train_hoist runs fused @ module_att_lstm.w_ih[:E] once and
        the T word projections as one product (no effect under
        scheduled sampling). cfg.remat: 'none' keeps every step's
        activations for the backward, 'full' recomputes each step
        (`torch.utils.checkpoint`), 'dots' keeps the step's matrix
        products and recomputes the rest; the gradients are the same.
        cfg.scan_unroll has no meaning for this Python loop and is
        ignored."""
        c, p = self.cfg, self.policy
        cast = p.cast_compute
        B, T = feat_bef.shape[0], seq.shape[1] - 1
        dev = feat_bef.device
        train = gen is not None
        use_ss = train and ss_prob > 0.0
        fused, feats = self._fused(feat_bef, feat_diff, feat_aft, gen)
        masks = (self._step_masks(T, B, gen, dev) if train
                 else [[None] * T] * 5)
        tokens = seq[:, :T].long().t()                        # [T, B]
        if use_ss:
            coins = torch.rand(T, B, generator=ss_gen, device=dev)
            noise = torch.rand(T, B, c.vocab_size, generator=ss_gen,
                               device=dev)
        hoist = c.train_hoist and not use_ss
        mod_pre = lang_pre = None
        if hoist:
            core = self.core
            mod_pre = core.module_att_lstm.pre_product(fused)
            emb = torch.relu(cast(F.embedding(tokens, self.word_emb)))
            if train:
                emb = apply_mask(emb, masks[0], 1.0 - c.drop_prob_lm)
            lang_pre = core.lang_lstm.pre_product(emb)        # [T, B, 4R]

        def step(it, state, m_word, m_vpos, m_dpos, m_gate, m_out, lpre):
            core_masks = None if m_vpos is None else (m_vpos, m_dpos, m_gate)
            if lpre is not None:
                h_lang, state, dpos, mw = self.core(
                    None, fused, feats, state, core_masks, mod_pre, lpre)
            else:
                xt = self._embed_word(it, m_word)
                h_lang, state, dpos, mw = self.core(
                    xt, fused, feats, state, core_masks)
            logp, logp_pos = self._out_logprobs(h_lang, dpos, m_out)
            return (*state, logp, logp_pos, mw)

        run = step
        if train and c.remat == "full":
            def run(*args):
                return checkpoint.checkpoint(step, *args, use_reentrant=False)
        elif train and c.remat == "dots":
            def run(*args):
                return checkpoint.checkpoint(
                    step, *args, use_reentrant=False,
                    context_fn=_keep_products)
        elif c.remat not in ("none", "full", "dots"):
            raise ValueError(f"unknown speaker.remat {c.remat!r}")

        z = torch.zeros(B, c.rnn_size, dtype=p.compute_dtype, device=dev)
        state = (z, z, z, z)
        logps, logps_pos, mws = [], [], []
        for i in range(T):
            it = tokens[i]
            if use_ss and i >= 1:
                # Gumbel-max: a categorical draw from the last log-probs
                prev = logps[-1].detach()
                gumbel = -torch.log(-torch.log(
                    noise[i].clamp(min=torch.finfo(noise.dtype).tiny)))
                sample = torch.argmax(prev + gumbel, dim=-1)
                it = torch.where(coins[i] < ss_prob, sample, it)
            out = run(it, state, *(m[i] for m in masks),
                      None if lang_pre is None else lang_pre[i])
            state = out[:4]
            logps.append(out[4])
            logps_pos.append(out[5])
            mws.append(out[6])
        return {"logprobs": torch.stack(logps, dim=1),
                "pos_logprobs": torch.stack(logps_pos, dim=1),
                "module_weights": torch.stack(mws, dim=1)}

    def decode_weights(self) -> Dict[str, torch.Tensor]:
        """The decode weights in the compute dtype, prepared once per
        parameter set (rebuilt when a parameter moves or changes)."""
        key = tuple((p.data_ptr(), p._version, p.device)
                    for p in self.parameters())
        if key != self._weights_key:
            self._weights = decode_weights(self, self.cfg, self.policy)
            self._weights_key = key
        return self._weights

    def sample(self, feat_bef, feat_aft, feat_diff, sample_max: bool = True,
               temperature: Optional[float] = None,
               gumbel: Optional[torch.Tensor] = None,
               gen: Optional[torch.Generator] = None,
               early_exit: bool = True) -> Dict[str, torch.Tensor]:
        """Free-running decode: seq [B, T] int32 (0 from each row's end
        on), logprobs [B, T] and module_weights [B, T, 3] f32 (rows
        zeroed where seq is 0).

        Greedy (sample_max) follows cfg.decode_kernel
        (`greedy_path`): 'auto' and 'pallas' run `greedy_decode` (K1 on
        a CUDA tensor, its plain twin on a CPU tensor; it always stops
        once every row has ended, and early_exit does not apply);
        'pallas_interpret' runs the plain twin, on CPU tensors only;
        'xla' runs the torch step loop on either device, argmax token
        and max logprob a step. Multinomial decodes run the torch loop
        whatever the name: at step t the token is argmax(gumbel[t] +
        logp / temp), a categorical draw from the tempered log-probs
        (Gumbel-max, as the reference's `jax.random.categorical`
        draws), with logp after the NULL ban at step 0 and the decoding
        constraint; the logprob kept is the drawn token's un-tempered
        logp. temperature defaults to cfg.temperature. gumbel [T, B, V]
        f32: the draws (the tests pass the reference's); else they come
        from `gen`, a torch.Generator on the model's device.

        The loop's step follows cfg.weight_quant and cfg.fused_core
        (`_loop_step`). As in the reference, a decode with either knob
        raises unless decode_kernel is 'xla'. early_exit stops the loop
        once every row has emitted 0: seq and module_weights are those
        of the full loop, and logprobs differ only at the steps after
        the last row ended (0 there; the full loop keeps the later
        steps' logprobs, as the reference's scan does)."""
        if not sample_max:
            refuse_knobs(self.cfg)
        elif greedy_path(self.cfg, feat_bef.device) == "kernel":
            fused, feats = self._fused(feat_bef, feat_diff, feat_aft)
            return greedy_decode(self.decode_weights(), self.cfg,
                                 self.policy, fused, feats)
        return self._sample_loop(feat_bef, feat_aft, feat_diff, sample_max,
                                 temperature, gumbel, gen, early_exit)

    def _loop_step(self):
        """The torch loop's step: the core on int8 weights when
        weight_quant is 'int8' (made once per decode call), else the core
        itself. fused_core takes the core too: the reference's merged
        step-start products are a TPU scheduling choice over the same
        parameters and math, which moves only the order of the f32
        sums."""
        if self.cfg.weight_quant == "int8":
            from ekaid_torch.models.quant import make_quant_core_step
            return make_quant_core_step(self.core, self.policy)
        return self.core

    @torch.no_grad()
    def _sample_loop(self, feat_bef, feat_aft, feat_diff, sample_max,
                     temperature, gumbel, gen, early_exit):
        c, p = self.cfg, self.policy
        B, T, V = feat_bef.shape[0], c.seq_length, c.vocab_size
        dev = feat_bef.device
        temp = temperature if temperature is not None else c.temperature
        if not sample_max:
            if gumbel is None:
                if gen is None:
                    raise ValueError("multinomial decode needs its draws: "
                                     "pass gumbel or a torch.Generator gen")
                gumbel = gumbel_draws((T, B, V), gen)
            if tuple(gumbel.shape) != (T, B, V):
                raise ValueError(f"gumbel draws {tuple(gumbel.shape)}, want "
                                 f"{(T, B, V)}")
        step = self._loop_step()
        fused, feats = self._fused(feat_bef, feat_diff, feat_aft)
        z = torch.zeros(B, c.rnn_size, dtype=p.compute_dtype, device=dev)
        state = (z, z, z, z)
        it = torch.full((B,), c.bos_token, dtype=torch.long, device=dev)
        unfinished = torch.ones(B, dtype=torch.bool, device=dev)
        vocab = torch.arange(V, device=dev)
        seq = torch.zeros(B, T, dtype=torch.int32, device=dev)
        lps = torch.zeros(B, T, dtype=torch.float32, device=dev)
        mws = torch.zeros(B, T, 3, dtype=torch.float32, device=dev)
        for t in range(T):
            if early_exit and not bool(unfinished.any()):
                break
            h_lang, state, dpos, mw = step(self._embed_word(it), fused,
                                           feats, state)
            logp = self._out_logprobs(h_lang, dpos)[0]
            if t == 0:
                logp[:, 0] = -math.inf
            elif c.decoding_constraint:
                logp = logp.masked_fill(vocab == it[:, None], -math.inf)
            if sample_max:
                lp = logp.max(-1).values
                # the lowest index among the maxima, as jnp.argmax
                nxt = torch.where(logp == lp[:, None], vocab, V).min(-1).values
            else:
                nxt = torch.argmax(gumbel[t].to(logp.dtype) + logp / temp,
                                   -1)
                lp = logp.gather(1, nxt[:, None])[:, 0]
            unfinished = unfinished & (nxt > 0)
            nxt = nxt * unfinished
            seq[:, t] = nxt.to(torch.int32)
            lps[:, t] = lp.float()
            mws[:, t] = mw.float()
            it = nxt
        mws = mws * (seq > 0)[..., None].float()
        return {"seq": seq, "logprobs": lps, "module_weights": mws}

    @torch.no_grad()
    def sample_beam(self, feat_bef, feat_aft, feat_diff,
                    beam_size: Optional[int] = None,
                    group_size: Optional[int] = None,
                    diversity_lambda: Optional[float] = None
                    ) -> Dict[str, torch.Tensor]:
        """Diverse-group beam search with the reference's semantics:

          * each beam is primed with `bos_token`; index 1 is banned
            (1000 off its logprob); the decoding constraint bans the
            beam's previous token;
          * at a group's first local step only beam 0 expands (all its
            beams are the same);
          * candidates rank on the diversity-augmented running sum; a
            beam that emits 0 competes for its group's best and its sum
            is then killed at -1000;
          * the G groups of beam_size / G beams run on a staggered
            schedule: group g is at local step t - g at step t, and the
            groups advance in order within a step, so group g's
            diversity penalty reads the earlier groups' current token
            rows (history that their later forks rewrote included). Each
            occurrence of a token among an earlier group's beams at the
            same local step takes `diversity_lambda` off its logprob
            once more;
          * a group's answer is its best finished beam, or its best live
            beam where that sum is higher.

        Returns seq [B, T] int32 and logprob [B] (group 0's best), and
        group_seqs [B, G, T] and group_logprobs [B, G] over the groups.
        Ties between candidates go to the lower flat index (beam, then
        token), as in XLA's top_k."""
        c, p = self.cfg, self.policy
        beams = beam_size or c.beam_size
        G = group_size if group_size is not None else c.group_size
        lam = (diversity_lambda if diversity_lambda is not None
               else c.diversity_lambda)
        if beams % G:
            raise ValueError(f"beam_size {beams} not divisible by "
                             f"group_size {G}")
        W = beams // G
        B, T, V = feat_bef.shape[0], c.seq_length, c.vocab_size
        dev, sdt = feat_bef.device, p.softmax_dtype
        fused, feats = self._fused(*(x.repeat_interleave(W, dim=0) for x in
                                     (feat_bef, feat_diff, feat_aft)))
        vocab = torch.arange(V, device=dev)
        ban_one = torch.where(vocab == 1, 1000.0, 0.0)
        neg = torch.tensor(-1e9, dtype=sdt, device=dev)
        rows = torch.arange(B, device=dev)[:, None]

        def group_step(gs, lt, prev_rows):
            state, it, seqs, sums, best_seq, best_p = gs
            h_lang, state, dpos, _ = self.core(self._embed_word(it), fused,
                                               feats, state)
            logp = (self._out_logprobs(h_lang, dpos)[0] - ban_one
                    ).view(B, W, V)
            if c.decoding_constraint and lt > 0:
                logp = logp.masked_fill(
                    vocab == it.view(B, W, 1).long(), -math.inf)
            if prev_rows is not None:
                toks = prev_rows.permute(1, 0, 2).reshape(B, -1).long()
                counts = torch.zeros(B, V, device=dev).scatter_add_(
                    1, toks, torch.ones(toks.shape, device=dev))
                logp = logp - (lam * counts)[:, None, :].to(logp.dtype)
            cand = sums[:, :, None] + logp
            if lt == 0:
                cand[:, 1:] = neg
            top_p, top_i = torch.sort(cand.view(B, W * V), dim=1,
                                      descending=True, stable=True)
            top_p, top_i = top_p[:, :W], top_i[:, :W]
            src, tok = top_i // V, (top_i % V).to(torch.int32)
            flat_src = (rows * W + src).view(-1)
            state = tuple(x[flat_src] for x in state)
            seqs = seqs[rows, src]
            seqs[:, :, lt] = tok
            finished = tok == 0
            cand_best = torch.where(finished, top_p, neg)
            arg = cand_best.argmax(1)
            grp_best = cand_best.gather(1, arg[:, None])[:, 0]
            improve = grp_best > best_p
            best_seq = torch.where(improve[:, None], seqs[rows[:, 0], arg],
                                   best_seq)
            best_p = torch.where(improve, grp_best, best_p)
            sums = torch.where(finished, torch.tensor(-1000.0, dtype=sdt,
                                                      device=dev), top_p)
            return state, tok.view(-1), seqs, sums, best_seq, best_p

        z = torch.zeros(B * W, c.rnn_size, dtype=p.compute_dtype, device=dev)
        gstates = [((z, z, z, z),
                    torch.full((B * W,), c.bos_token, dtype=torch.int32,
                               device=dev),
                    torch.zeros(B, W, T, dtype=torch.int32, device=dev),
                    torch.zeros(B, W, dtype=sdt, device=dev),
                    torch.zeros(B, T, dtype=torch.int32, device=dev),
                    torch.full((B,), -math.inf, dtype=sdt, device=dev))
                   for _ in range(G)]
        for t in range(T + G - 1):
            for g in range(G):
                lt = t - g
                if not 0 <= lt < T:
                    continue
                prev = (torch.stack([gstates[q][2][:, :, lt]
                                     for q in range(g)]) if g else None)
                gstates[g] = group_step(gstates[g], lt, prev)
        g_seqs, g_ps = [], []
        for _, _, seqs, sums, best_seq, best_p in gstates:
            arg = sums.argmax(1)
            alive = sums.gather(1, arg[:, None])[:, 0]
            use = alive > best_p
            g_seqs.append(torch.where(use[:, None], seqs[rows[:, 0], arg],
                                      best_seq))
            g_ps.append(torch.where(use, alive, best_p))
        return {"seq": g_seqs[0], "logprob": g_ps[0],
                "group_seqs": torch.stack(g_seqs, dim=1),
                "group_logprobs": torch.stack(g_ps, dim=1)}


def refuse_knobs(cfg) -> None:
    """Raise, as the reference does for any decode, where weight_quant
    or fused_core is set with a decode_kernel other than 'xla'."""
    if resolve_decode_kernel(cfg.decode_kernel) != "xla" and (
            cfg.weight_quant != "none" or cfg.fused_core):
        raise ValueError(
            f"speaker.decode_kernel={cfg.decode_kernel!r} runs the greedy "
            "kernel, which cannot compose with speaker.weight_quant / "
            "speaker.fused_core; set speaker.decode_kernel='xla' to decode "
            "through the torch step loop")


def greedy_path(cfg, device: torch.device) -> str:
    """Where a greedy decode of the speaker config `cfg` on `device`
    runs: 'loop' (the torch step loop) for decode_kernel 'xla', else
    'kernel' (`greedy_decode`: K1 on a CUDA device, its plain twin on
    the CPU). Raises for a knob with a kernel name (`refuse_knobs`) and
    for 'pallas_interpret' (the plain twin, the reference's CPU debug
    mode) off the CPU."""
    kernel = resolve_decode_kernel(cfg.decode_kernel)
    if kernel == "xla":
        return "loop"
    refuse_knobs(cfg)
    if kernel == "pallas_interpret" and torch.device(device).type != "cpu":
        raise ValueError("speaker.decode_kernel='pallas_interpret' runs "
                         "the kernel's plain twin on CPU tensors only; "
                         f"this decode is on {device}")
    return "kernel"


def gumbel_draws(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws, f32, on the generator's device:
    -log(-log(u)) with u uniform in [tiny, 1), so no log(0)."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))


#: the matrix products whose outputs remat 'dots' keeps
_PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default, torch.ops.aten.matmul.default}


def _keep_products():
    """Selective-checkpoint contexts that save the outputs of the matrix
    products and recompute everything else (remat 'dots')."""
    def policy(ctx, op, *args, **kwargs):
        return (checkpoint.CheckpointPolicy.MUST_SAVE if op in _PRODUCTS
                else checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)

    return checkpoint.create_selective_checkpoint_contexts(policy)
