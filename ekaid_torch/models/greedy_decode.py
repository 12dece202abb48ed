"""The whole greedy answer loop: CUDA kernel and plain-torch version.

Counterpart of `ekaid_tpu/models/pallas_decode.py` (its Pallas kernel
`_decode_kernel` runs the loop on the TPU). The kernel for the card is
`ekaid_torch/csrc/greedy_decode.cu`, one cooperative launch per decode
with the early exit decided on the device; its source note states what
bounds it on an H100 and what its design does about that.

`greedy_decode` launches the kernel for CUDA tensors and never falls
back. It runs `greedy_decode_plain` only for tensors on the CPU. Both
take the speaker's decode weights (`decode_weights`) and return what
`DynamicSpeaker.sample(sample_max=True)` returns: seq [B, T] int32,
logprobs [B, T] f32, module_weights [B, T, 3] f32 (rows zeroed past
EOS; untouched steps stay 0).

Rounding points, shared by both: every product accumulates in f32 over
its whole K and rounds once to the compute dtype; bias adds and sums of
products run in the compute dtype; LSTM gates, softmaxes and the gate
sigmoid run in f32 from the rounded inputs.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ekaid_torch.models.layers import lstm_gates
from ekaid_torch.utils.dtypes import Policy

#: decode weights, in the kernel's pointer order
WEIGHT_NAMES = (
    "wemb", "wih_mod", "whh_mod", "b_mod", "wfc", "bfc", "wpos1", "bpos1",
    "wwp", "bwp", "wpos2", "bpos2", "wg1", "bg1", "wg2", "bg2",
    "wih_x", "wih_a", "whh_lang", "b_lang", "wlogit", "blogit")


def decode_weights(speaker, cfg, policy: Policy) -> Dict[str, torch.Tensor]:
    """Compute-dtype, contiguous copies of a DynamicSpeaker's decode
    weights; lang_lstm.w_ih is split at word_embed_size."""
    core, W = speaker.core, cfg.word_embed_size
    src = {
        "wemb": speaker.word_emb,
        "wih_mod": core.module_att_lstm.w_ih,
        "whh_mod": core.module_att_lstm.w_hh,
        "b_mod": core.module_att_lstm.b,
        "wfc": core.weight_fc.kernel, "bfc": core.weight_fc.bias,
        "wpos1": core.pos1.kernel, "bpos1": core.pos1.bias,
        "wwp": core.weight_pos.kernel, "bwp": core.weight_pos.bias,
        "wpos2": core.pos2.kernel, "bpos2": core.pos2.bias,
        "wg1": core.gate1x.kernel, "bg1": core.gate1x.bias,
        "wg2": core.gate2x.kernel, "bg2": core.gate2x.bias,
        "wih_x": core.lang_lstm.w_ih[:W], "wih_a": core.lang_lstm.w_ih[W:],
        "whh_lang": core.lang_lstm.w_hh, "b_lang": core.lang_lstm.b,
        "wlogit": speaker.logit.kernel, "blogit": speaker.logit.bias,
    }
    with torch.no_grad():
        return {k: policy.cast_compute(src[k]).contiguous()
                for k in WEIGHT_NAMES}


def _check_knobs(cfg):
    if cfg.weight_quant != "none" or cfg.fused_core:
        raise ValueError(
            "the greedy decode kernel replaces the whole decode loop and "
            "cannot compose with speaker.weight_quant / speaker.fused_core")


def _gates(z, c_prev, dt):
    """LSTM gate math in f32 from the rounded z; h, c rounded back."""
    h, c = lstm_gates(z.float(), c_prev.float())
    return h.to(dt), c.to(dt)


def greedy_decode_plain(w: Dict[str, torch.Tensor], cfg, policy: Policy,
                        fused: torch.Tensor, feats: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
    """The kernel's loop in plain torch, step for step. fused [B, E] and
    feats [B, 3, D] (bef, diff, aft) in the compute dtype."""
    _check_knobs(cfg)
    dt = policy.compute_dtype
    f32 = torch.float32

    def mm(a, b):
        return (a.float() @ b.float()).to(dt)

    B, T, R, V = fused.shape[0], cfg.seq_length, cfg.rnn_size, cfg.vocab_size
    dev = fused.device
    f_bef, f_dif, f_aft = feats.unbind(1)
    h_mod = c_mod = h_lang = c_lang = torch.zeros(B, R, dtype=dt, device=dev)
    it = torch.full((B,), cfg.bos_token, dtype=torch.long, device=dev)
    unfin = torch.ones(B, dtype=torch.bool, device=dev)
    seq = torch.zeros(B, T, dtype=torch.int32, device=dev)
    lps = torch.zeros(B, T, dtype=f32, device=dev)
    mws = torch.zeros(B, T, 3, dtype=f32, device=dev)
    vocab = torch.arange(V, device=dev)
    rows = torch.arange(B, device=dev)
    for t in range(T):
        if not bool(unfin.any()):
            break
        xt = torch.relu(w["wemb"][it])
        z_mod = (mm(torch.cat([fused, h_lang], -1), w["wih_mod"])
                 + mm(h_mod, w["whh_mod"]) + w["b_mod"])
        h_mod, c_mod = _gates(z_mod, c_mod, dt)
        mw = torch.softmax((mm(h_mod, w["wfc"]) + w["bfc"]).to(f32), -1)
        vpos = torch.relu(mm(h_lang, w["wpos1"]) + w["bpos1"])
        dpos = mm(vpos, w["wwp"]) + w["bwp"]
        ppos = (mm(torch.softmax(dpos.to(f32), -1).to(dt), w["wpos2"])
                + w["bpos2"])
        mw_c = mw.to(dt)
        att = (mw_c[:, 0:1] * f_bef + mw_c[:, 1:2] * f_dif
               + mw_c[:, 2:3] * f_aft)
        gate_h = torch.relu(
            mm(torch.cat([h_lang, ppos, att], -1), w["wg1"]) + w["bg1"])
        gate = torch.sigmoid(
            (mm(gate_h, w["wg2"]) + w["bg2"]).to(f32)).to(dt)
        z_lang = (mm(xt, w["wih_x"]) + mm(gate * att, w["wih_a"])
                  + mm(h_lang, w["whh_lang"]) + w["b_lang"])
        h_lang, c_lang = _gates(z_lang, c_lang, dt)
        logits = (mm(h_lang, w["wlogit"]) + w["blogit"]).to(f32)
        m = logits.max(-1, keepdim=True).values
        logp = logits - (m + torch.log(torch.exp(logits - m).sum(
            -1, keepdim=True)))
        if t == 0:
            logp[:, 0] = -float("inf")
        elif cfg.decoding_constraint:
            logp[rows, it] = -float("inf")
        lp = logp.max(-1).values
        # lowest index among the maxima
        nxt = torch.where(logp == lp[:, None], vocab, V).min(-1).values
        unfin = unfin & (nxt > 0)
        nxt = nxt * unfin
        seq[:, t] = nxt.to(torch.int32)
        lps[:, t] = lp
        mws[:, t] = mw * (nxt > 0)[:, None].to(f32)
        it = nxt
    return {"seq": seq, "logprobs": lps, "module_weights": mws}


def greedy_decode(w: Dict[str, torch.Tensor], cfg, policy: Policy,
                  fused: torch.Tensor, feats: torch.Tensor,
                  phase_ns: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """The greedy decode: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. `greedy_decode.launches` counts kernel
    launches. `phase_ns`, an int64 CUDA tensor of 7 zeros, receives the
    kernel's time in each of its seven phases, summed over the steps."""
    if fused.device.type == "cpu":
        return greedy_decode_plain(w, cfg, policy, fused, feats)
    if fused.device.type != "cuda":
        raise ValueError(f"greedy_decode: no kernel for {fused.device}")
    return _launch(w, cfg, policy, fused, feats, phase_ns)


greedy_decode.launches = 0
greedy_decode.last_grid = 0       # blocks of the last launch


def _launch(w, cfg, policy, fused, feats, phase_ns):
    from ekaid_torch import kernels
    _check_knobs(cfg)
    dt = policy.compute_dtype
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dt not in codes:
        raise ValueError(f"greedy_decode kernel: no {dt} instance")
    B, E = fused.shape
    T, R, D = cfg.seq_length, cfg.rnn_size, cfg.input_dim
    W, V, P = cfg.word_embed_size, cfg.vocab_size, cfg.pos_classes
    shapes = {
        "wemb": (V, W), "wih_mod": (E + R, 4 * R), "whh_mod": (R, 4 * R),
        "b_mod": (4 * R,), "wfc": (R, 3), "bfc": (3,), "wpos1": (R, R),
        "bpos1": (R,), "wwp": (R, P), "bwp": (P,), "wpos2": (P, R),
        "bpos2": (R,), "wg1": (2 * R + D, 2 * R + D), "bg1": (2 * R + D,),
        "wg2": (2 * R + D, D), "bg2": (D,), "wih_x": (W, 4 * R),
        "wih_a": (D, 4 * R), "whh_lang": (R, 4 * R), "b_lang": (4 * R,),
        "wlogit": (R, V), "blogit": (V,)}
    feats2d = feats.reshape(B, 3 * D)
    named = [(k, w[k], shapes[k]) for k in WEIGHT_NAMES]
    named += [("fused", fused, (B, E)), ("feats", feats2d, (B, 3 * D))]
    for name, x, shape in named:
        if x.device != fused.device or x.dtype != dt:
            raise ValueError(f"greedy_decode: {name} is {x.dtype} on "
                             f"{x.device}, want {dt} on {fused.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"greedy_decode: {name} has shape "
                             f"{tuple(x.shape)}, want contiguous {shape}")

    dev = fused.device
    seq = torch.zeros(B, T, dtype=torch.int32, device=dev)
    lps = torch.zeros(B, T, dtype=torch.float32, device=dev)
    mws = torch.zeros(B, T, 3, dtype=torch.float32, device=dev)
    state = [torch.zeros(n, dtype=dt, device=dev) for n in (
        2 * B * R, B * R, B * R, B * R)]           # h_mod x2, c_mod, h, c
    work = [torch.empty(n, dtype=dt, device=dev) for n in (
        B * R, B * 4 * R, B * 4 * R, B * D, B * R, B * (2 * R + D), B * D)]
    mw = torch.empty(B * 3, dtype=torch.float32, device=dev)
    logits = torch.empty(B * V, dtype=torch.float32, device=dev)
    tok = torch.full((B,), cfg.bos_token, dtype=torch.int32, device=dev)
    unfin = torch.ones(B, dtype=torch.int32, device=dev)
    counts = torch.zeros(T, dtype=torch.int32, device=dev)
    bufs = ([x for _, x, _ in named] + [seq, lps, mws] + state + work
            + [mw, logits, tok, unfin, counts])
    if phase_ns is not None and (phase_ns.shape != (7,) or phase_ns.dtype
                                 != torch.int64 or phase_ns.device != dev):
        raise ValueError("phase_ns must be an int64 [7] tensor on the "
                         "decode's device")
    ptrs = (ctypes.c_void_p * (len(bufs) + 1))(
        *[x.data_ptr() for x in bufs],
        None if phase_ns is None else phase_ns.data_ptr())
    dims = (ctypes.c_int * 9)(B, T, E, R, D, W, V, P,
                              int(bool(cfg.decoding_constraint)))
    grid = ctypes.c_int(0)
    lib = kernels.load("greedy_decode")
    if (lib.ekaid_num_pointer_slots(), lib.ekaid_num_dims()) != (
            len(ptrs), len(dims)):
        raise RuntimeError("greedy_decode: the library's argument layout "
                           "differs from this wrapper's; rebuild it")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ekaid_greedy_decode(
            codes[dt], ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(dims, ctypes.c_void_p), stream,
            ctypes.addressof(grid))
    kernels.check(lib, err, "greedy_decode kernel launch")
    greedy_decode.launches += 1
    greedy_decode.last_grid = grid.value
    return {"seq": seq, "logprobs": lps, "module_weights": mws}
