"""The whole greedy answer loop: CUDA kernel and plain-torch version.

Counterpart of `ekaid_tpu/models/pallas_decode.py` (its Pallas kernel
`_decode_kernel` runs the loop on the TPU). The kernel for the card is
`ekaid_torch/csrc/greedy_decode.cu`, one cooperative launch per decode
with the early exit decided on the device; its source note states what
bounds it on an H100 and what its design does about that. This module
computes the kernel's work plan (`decode_plan`: how each product phase
is cut into units) and packs the product weights for it
(`pack_weight`); the kernel computes none of it.

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
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ekaid_torch.models.layers import lstm_gates
from ekaid_torch.utils.dtypes import Policy

#: decode weights, in the kernel's pointer order
WEIGHT_NAMES = (
    "wemb", "wih_mod", "whh_mod", "b_mod", "wfc", "bfc", "wpos1", "bpos1",
    "wwp", "bwp", "wpos2", "bpos2", "wg1", "bg1", "wg2", "bg2",
    "wih_x", "wih_a", "whh_lang", "b_lang", "wlogit", "blogit")

# ---- the kernel's work plan ------------------------------------------------
#
# The product phases (1, 3, 4, 5, 6) are cut into units: one unit is up to
# 64 batch rows (a row group) x `nu` weight columns (a column tile) x one
# K-slice of `ks` rows of one product. Each unit writes its f32 partial to
# scratch; the unit that takes the last ticket of its (tile, row group)
# sums the slices in slice order, rounds once and runs the epilogue. The
# plan fixes every shape here; the kernel reads it and computes none of it.

#: epilogue kinds, as the kernel's `Kind` enum
MOD, VPOS, ZX, ZH, G1, G2, LANG, LOGIT = range(8)
KIND_NAMES = ("mod_lstm", "vpos", "zx", "zh", "gate1x", "gate2x",
              "lang_lstm", "logits")
#: the product phases, as the kernel runs them (phases 2 and 7 are per row)
PHASE_KINDS = ((MOD, VPOS, ZX, ZH), (G1,), (G2,), (LANG,), (LOGIT,))
ROWS_PER_GROUP = 64
MAX_JOBS = 4
JOB_INTS = 16
PHASE_INTS = 2 + MAX_JOBS * JOB_INTS
KS_CHOICES = (512, 256, 128, 64, 32, 16)
NU_CHOICES = (64, 32, 16)
GATE_NU_CHOICES = (64, 32)      # 16 or 8 hidden units a gate: whole chunks
# shared memory of the product phases, as the kernel lays it out: the
# activation rows (bu_pad x lda) and the weight ring, which the split-K
# sums take over once a unit's loop is done
RING_STAGES = 5
STAGE_BYTES = 8192
SMEM_LIMIT = 232448


def blocks_per_sm(itemsize: int) -> int:
    """The kernel's blocks an SM where shared memory allows, as its
    `BlocksPerSm`: two for bf16 (128 registers), one for f32."""
    return 2 if itemsize == 2 else 1


@dataclass(frozen=True)
class Job:
    """One kind of tile in a phase: `ntiles` column tiles of `nu` columns
    over `groups` row groups, each cut into the K-slices of its products
    (the module LSTM has two, rounded separately)."""
    kind: int
    nu: int
    ntiles: int
    ks: int
    ks_of: Tuple[int, ...]          # K of each product
    n: int                          # weight columns (the row length)
    gates: bool                     # tile = 4 gates x nu/4 hidden units
    unit_begin: int
    part_begin: int                 # floats, within the phase's scratch
    ticket_begin: int

    def slices(self, p: int) -> int:
        return -(-self.ks_of[p] // self.ks)

    @property
    def slices_total(self) -> int:
        return sum(self.slices(p) for p in range(len(self.ks_of)))

    def columns(self, tile: int) -> List[Optional[int]]:
        """Weight column of each tile column, None where it is padding."""
        if not self.gates:
            return [c if c < self.n else None
                    for c in range(tile * self.nu, (tile + 1) * self.nu)]
        hid, r = self.nu // 4, self.n // 4
        return [q * r + tile * hid + j if tile * hid + j < r else None
                for q in range(4) for j in range(hid)]

    def k_bounds(self, p: int, s: int) -> Tuple[int, int]:
        return s * self.ks, min((s + 1) * self.ks, self.ks_of[p])


@dataclass(frozen=True)
class DecodePlan:
    bu_pad: int                     # rows of a unit, padded to 16
    groups: int                     # row groups of up to 64 rows
    lda: int                        # activation row stride in shared memory
    smem: int                       # dynamic shared memory, bytes
    part_floats: int                # split-K scratch, the largest phase
    tickets: int                    # ticket counters, the largest phase
    phases: Tuple[Tuple[Job, ...], ...]

    def units(self, phase: int) -> int:
        return sum(j.ntiles * self.groups * j.slices_total
                   for j in self.phases[phase])

    def array(self) -> List[int]:
        """The plan as the kernel reads it: PHASE_INTS int32 a phase."""
        out = []
        for phase, jobs in enumerate(self.phases):
            row = [len(jobs), self.units(phase)]
            for j in jobs:
                k1 = j.ks_of[1] if len(j.ks_of) > 1 else 0
                s1 = j.slices(1) if len(j.ks_of) > 1 else 0
                row += [j.kind, j.nu, j.ntiles, j.ks, len(j.ks_of),
                        j.ks_of[0], j.slices(0), k1, s1, j.unit_begin,
                        j.ntiles * self.groups * j.slices_total,
                        j.part_begin, j.ticket_begin, j.n, int(j.gates),
                        j.n // 4 if j.gates else j.n]
            out += row + [0] * (PHASE_INTS - len(row))
        return out


def product_smem(bu_pad: int, lda: int, itemsize: int) -> int:
    """Shared memory of a product unit: the input rows and the weight ring
    (later the split-K buffer). The reducing unit stages its f32
    partials over all of it."""
    return bu_pad * lda * itemsize + RING_STAGES * STAGE_BYTES


def reducer_smem(kind: int, slices: int, bu_pad: int, nu: int,
                 itemsize: int) -> int:
    """Shared memory the reducing unit stages: the f32 partials of every
    slice, then its epilogue's operands (the bias; the LSTM cell, and zx
    and zh for the language LSTM; att for gate2x)."""
    ops = nu
    if kind in (MOD, LANG):
        ops += bu_pad * nu // 4 + (2 * bu_pad * nu if kind == LANG else 0)
    elif kind == G2:
        ops += bu_pad * nu
    return slices * bu_pad * nu * 4 + ops * itemsize


def _products(kind, E, R, D, W, V):
    """(K of each product, weight columns, gate tile) of a kind."""
    G = 2 * R + D
    return {MOD: ((E + R, R), 4 * R, True), VPOS: ((R,), R, False),
            ZX: ((W,), 4 * R, False), ZH: ((R,), 4 * R, False),
            G1: ((G,), G, False), G2: ((G,), D, False),
            LANG: ((D,), 4 * R, True), LOGIT: ((R,), V, False)}[kind]


def decode_plan(B: int, E: int, R: int, D: int, W: int, V: int, P: int,
                sms: int, itemsize: int = 2) -> DecodePlan:
    """The kernel's work plan for a batch of B rows on `sms` SMs, for
    weights and activations of `itemsize` bytes.

    Each phase takes the (slice length, column tile) whose unit count
    reaches `sms` at the least cost, counted in elements: the rounds of
    units over blocks_per_sm(itemsize) x sms blocks times a unit's
    weight and activation tiles, plus the reducing unit's read of the
    f32 partials. Where no choice reaches `sms`, the one with the most
    units. Raises ValueError on shapes the kernel cannot take."""
    if min(B, E, R, D, W, V, P) < 1 or sms < 1:
        raise ValueError(f"decode_plan: non-positive shape B={B} E={E} "
                         f"R={R} D={D} W={W} V={V} P={P} sms={sms}")
    bu = min(B, ROWS_PER_GROUP)
    bu_pad = -(-bu // 16) * 16
    groups = -(-B // ROWS_PER_GROUP)
    # the activation tile holds the longest slice any phase may take
    k_max = max(k for kind in range(8) for k in _products(kind, E, R, D, W,
                                                           V)[0])
    lda = min(max(KS_CHOICES), -(-k_max // 64) * 64)
    phases = []
    for kinds in PHASE_KINDS:
        gates = _products(kinds[0], E, R, D, W, V)[2]
        best = None
        for ks in KS_CHOICES:
            for nu in GATE_NU_CHOICES if gates else NU_CHOICES:
                units, cost_red, fits = 0, 0, True
                for kind in kinds:
                    kp, n, g = _products(kind, E, R, D, W, V)
                    ntiles = -(-(n // 4 if g else n) // (nu // 4 if g else nu))
                    s = sum(-(-k // ks) for k in kp)
                    units += ntiles * groups * s
                    cost_red = max(cost_red, s * bu_pad * nu * 2)
                    fits &= reducer_smem(kind, s, bu_pad, nu, itemsize) <= \
                        product_smem(bu_pad, lda, itemsize)
                if not fits:
                    continue            # the reducer's staging must fit
                rounds = -(-units // (blocks_per_sm(itemsize) * sms))
                cost = rounds * ks * (nu + bu_pad) + cost_red
                key = (units < sms, -units if units < sms else cost, -ks)
                if best is None or key < best[0]:
                    best = (key, ks, nu)
        if best is None:
            raise ValueError(f"decode_plan: no unit plan fits phase "
                             f"{[KIND_NAMES[k] for k in kinds]}")
        _, ks, nu = best
        jobs, unit, part, ticket = [], 0, 0, 0
        for kind in kinds:
            kp, n, g = _products(kind, E, R, D, W, V)
            ntiles = -(-(n // 4 if g else n) // (nu // 4 if g else nu))
            j = Job(kind, nu, ntiles, ks, kp, n, g, unit, part, ticket)
            jobs.append(j)
            unit += ntiles * groups * j.slices_total
            part += ntiles * groups * j.slices_total * bu_pad * nu
            ticket += ntiles * groups
        phases.append(tuple(jobs))
    products = product_smem(bu_pad, lda, itemsize)
    per_row = 4 * (2 * R + 2 * (3 + P))          # phase 2's row buffers
    smem = max(products, per_row)
    if smem > SMEM_LIMIT:
        raise ValueError(f"decode_plan: {smem} bytes of shared memory "
                         f"(R={R}, P={P}) exceed {SMEM_LIMIT}")
    part_floats = max(sum(j.ntiles * groups * j.slices_total * bu_pad * j.nu
                          for j in jobs) for jobs in phases)
    tickets = max(sum(j.ntiles * groups for j in jobs) for jobs in phases)
    return DecodePlan(bu_pad, groups, lda, smem, part_floats, tickets,
                      tuple(phases))


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


#: the per-step intermediates `scratch=True` returns, as the kernel keeps
#: them: [B, n] in the compute dtype, logits f32
SCRATCH_NAMES = ("vpos", "zx", "zh", "h_mod", "gate_h", "ga", "h_lang",
                 "logits")


def greedy_decode_plain(w: Dict[str, torch.Tensor], cfg, policy: Policy,
                        fused: torch.Tensor, feats: torch.Tensor,
                        scratch: bool = False) -> Dict[str, torch.Tensor]:
    """The kernel's loop in plain torch, step for step. fused [B, E] and
    feats [B, 3, D] (bef, diff, aft) in the compute dtype. With
    `scratch`, the result also holds the last step's SCRATCH_NAMES."""
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
        zx, ga = mm(xt, w["wih_x"]), gate * att
        zh = mm(h_lang, w["whh_lang"])
        z_lang = zx + mm(ga, w["wih_a"]) + zh + w["b_lang"]
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
        step = {"vpos": vpos, "zx": zx, "zh": zh, "h_mod": h_mod,
                "gate_h": gate_h, "ga": ga, "h_lang": h_lang,
                "logits": logits}
    out = {"seq": seq, "logprobs": lps, "module_weights": mws}
    if scratch:
        out.update(step)
    return out


def greedy_decode(w: Dict[str, torch.Tensor], cfg, policy: Policy,
                  fused: torch.Tensor, feats: torch.Tensor,
                  phase_ns: Optional[torch.Tensor] = None,
                  scratch: bool = False) -> Dict[str, torch.Tensor]:
    """The greedy decode: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. `greedy_decode.launches` counts kernel
    launches. `phase_ns`, an int64 CUDA tensor of 7 zeros, receives the
    kernel's time in each of its seven phases, summed over the steps.
    `scratch` adds the last step's intermediates (SCRATCH_NAMES), to
    hold each phase against the plain version's."""
    if fused.device.type == "cpu":
        return greedy_decode_plain(w, cfg, policy, fused, feats, scratch)
    if fused.device.type != "cuda":
        raise ValueError(f"greedy_decode: no kernel for {fused.device}")
    return _launch(w, cfg, policy, fused, feats, phase_ns, scratch)


greedy_decode.launches = 0
greedy_decode.last_grid = 0       # blocks of the last launch


#: the weight of each product of each kind, in product order
PRODUCT_WEIGHTS = {MOD: ("wih_mod", "whh_mod"), VPOS: ("wpos1",),
                   ZX: ("wih_x",), ZH: ("whh_lang",), G1: ("wg1",),
                   G2: ("wg2",), LANG: ("wih_a",), LOGIT: ("wlogit",)}


def pack_weight(w: torch.Tensor, job: Job) -> torch.Tensor:
    """A product weight [K, N] packed for the kernel, tile-major: [ntiles,
    K, nu] with packed[t, k, j] = w[k, job.columns(t)[j]], zero where the
    tile column is padding. A unit's K-slice of a tile is then one
    contiguous slab."""
    cols = [[c if c is not None else 0 for c in job.columns(t)]
            for t in range(job.ntiles)]
    valid = [[c is not None for c in job.columns(t)]
             for t in range(job.ntiles)]
    idx = torch.tensor(cols, device=w.device)
    mask = torch.tensor(valid, device=w.device)
    return (w[:, idx] * mask.to(w.dtype)).permute(1, 0, 2).contiguous()


#: (source tensors, their versions and tile widths, packed), newest last
_packed: List[tuple] = []


def _packed_weights(w, plan: DecodePlan) -> Dict[str, torch.Tensor]:
    """The product weights packed for `plan`, made once per parameter set
    and tile widths (the last few kept). An entry holds its source
    tensors and is found only for those same tensors, unchanged since:
    another set cannot take their addresses while the entry lives."""
    jobs = {j.kind: j for js in plan.phases for j in js}
    names = [(n, kind) for kind, ns in PRODUCT_WEIGHTS.items() for n in ns]
    src = tuple(w[n] for n, _ in names)
    key = tuple((x._version, jobs[kind].nu) for x, (_, kind) in zip(src,
                                                                       names))
    for held, k, packed in _packed:
        if k == key and all(a is b for a, b in zip(held, src)):
            return packed
    with torch.no_grad():
        packed = {n: pack_weight(w[n], jobs[kind]) for n, kind in names}
    _packed.append((src, key, packed))
    del _packed[:-4]
    return packed


_plans: Dict[tuple, tuple] = {}


def _device_plan(dims: tuple, dev: torch.device) -> tuple:
    """decode_plan for the card's SM count, and its int32 copy on `dev`
    (made once per shape and device)."""
    key = (dims, str(dev))
    if key not in _plans:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = decode_plan(*dims[:-1], sms=sms, itemsize=dims[-1])
        _plans[key] = plan, torch.tensor(plan.array(), dtype=torch.int32,
                                         device=dev)
    return _plans[key]


def _check_inputs(w, cfg, policy, fused, feats):
    """The shapes, dtypes and devices the kernel takes; returns the plan's
    dims (B, E, R, D, W, V, P)."""
    _check_knobs(cfg)
    dt = policy.compute_dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"greedy_decode kernel: no {dt} instance")
    B, E = fused.shape
    R, D = cfg.rnn_size, cfg.input_dim
    W, V, P = cfg.word_embed_size, cfg.vocab_size, cfg.pos_classes
    shapes = {
        "wemb": (V, W), "wih_mod": (E + R, 4 * R), "whh_mod": (R, 4 * R),
        "b_mod": (4 * R,), "wfc": (R, 3), "bfc": (3,), "wpos1": (R, R),
        "bpos1": (R,), "wwp": (R, P), "bwp": (P,), "wpos2": (P, R),
        "bpos2": (R,), "wg1": (2 * R + D, 2 * R + D), "bg1": (2 * R + D,),
        "wg2": (2 * R + D, D), "bg2": (D,), "wih_x": (W, 4 * R),
        "wih_a": (D, 4 * R), "whh_lang": (R, 4 * R), "b_lang": (4 * R,),
        "wlogit": (R, V), "blogit": (V,)}
    named = [(k, w[k], shapes[k]) for k in WEIGHT_NAMES]
    named += [("fused", fused, (B, E)), ("feats", feats, (B, 3, D))]
    for name, x, shape in named:
        if x.device != fused.device or x.dtype != dt:
            raise ValueError(f"greedy_decode: {name} is {x.dtype} on "
                             f"{x.device}, want {dt} on {fused.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"greedy_decode: {name} has shape "
                             f"{tuple(x.shape)}, want contiguous {shape}")
    return B, E, R, D, W, V, P


def _launch(w, cfg, policy, fused, feats, phase_ns, scratch=False):
    from ekaid_torch import kernels
    dims = _check_inputs(w, cfg, policy, fused, feats)
    B, E, R, D, W, V, P = dims
    T, dt, dev = cfg.seq_length, policy.compute_dtype, fused.device
    if phase_ns is not None and (phase_ns.shape != (7,) or phase_ns.dtype
                                 != torch.int64 or phase_ns.device != dev):
        raise ValueError("phase_ns must be an int64 [7] tensor on the "
                         "decode's device")
    plan, plan_dev = _device_plan(dims + (dt.itemsize,), dev)
    seq = torch.zeros(B, T, dtype=torch.int32, device=dev)
    lps = torch.zeros(B, T, dtype=torch.float32, device=dev)
    mws = torch.zeros(B, T, 3, dtype=torch.float32, device=dev)
    state = [torch.zeros(n, dtype=dt, device=dev) for n in (
        2 * B * R, B * R, B * R, B * R)]           # h_mod x2, c_mod, h, c
    # vpos, zx, zh, att, ppos, gate_h, ga
    work = [torch.empty(B, n, dtype=dt, device=dev) for n in (
        R, 4 * R, 4 * R, D, R, 2 * R + D, D)]
    mw = torch.empty(B * 3, dtype=torch.float32, device=dev)
    logits = torch.empty(B, V, dtype=torch.float32, device=dev)
    tok = torch.full((B,), cfg.bos_token, dtype=torch.int32, device=dev)
    unfin = torch.ones(B, dtype=torch.int32, device=dev)
    counts = torch.zeros(T, dtype=torch.int32, device=dev)
    part = torch.empty(plan.part_floats, dtype=torch.float32, device=dev)
    tickets = torch.zeros(plan.tickets, dtype=torch.int32, device=dev)
    # the products read their weights packed tile-major
    packed = _packed_weights(w, plan)
    bufs = ([packed.get(k, w[k]) for k in WEIGHT_NAMES]
            + [fused, feats, seq, lps, mws]
            + state + work + [mw, logits, tok, unfin, counts, plan_dev,
                              part, tickets])
    ptrs = (ctypes.c_void_p * (len(bufs) + 1))(
        *[x.data_ptr() for x in bufs],
        None if phase_ns is None else phase_ns.data_ptr())
    dims_c = (ctypes.c_int * 13)(
        B, T, E, R, D, W, V, P, int(bool(cfg.decoding_constraint)),
        plan.bu_pad, plan.groups, plan.lda, plan.smem)
    grid = ctypes.c_int(0)
    lib = kernels.load("greedy_decode")
    if (lib.ekaid_num_pointer_slots(), lib.ekaid_num_dims()) != (
            len(ptrs), len(dims_c)):
        raise RuntimeError("greedy_decode: the library's argument layout "
                           "differs from this wrapper's; rebuild it")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ekaid_greedy_decode(
            {torch.float32: 0, torch.bfloat16: 1}[dt],
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(dims_c, ctypes.c_void_p), stream,
            ctypes.addressof(grid))
    kernels.check(lib, err, "greedy_decode kernel launch")
    greedy_decode.launches += 1
    greedy_decode.last_grid = grid.value
    out = {"seq": seq, "logprobs": lps, "module_weights": mws}
    if scratch:
        # the step that ran last wrote h_mod's buffer (steps run) % 2
        live = (counts > 0).int().cumprod(0).sum().item()
        ran = min(T, live + 1)
        out.update(zip(("vpos", "zx", "zh"), work[:3]))
        out.update(gate_h=work[5], ga=work[6], logits=logits,
                   h_mod=state[0].view(2, B, R)[ran % 2],
                   h_lang=state[2].view(B, R))
    return out
