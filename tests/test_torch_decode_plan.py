"""The greedy decode kernel's work plan (`greedy_decode.decode_plan`).

The plan cuts the kernel's product phases into units of up to 64 batch
rows x a column tile x one K-slice; the kernel reads it and computes none
of it, so its coverage, padding and unit counts are checked here, on the
CPU, for the flagship and the smoke dims at the batches the card runs.
"""

import re
from pathlib import Path

import pytest
import torch

from _torch_port import port_cfg, tiny_cfg
from ekaid_torch.config import load_config
from ekaid_torch.models import greedy_decode as gd
from ekaid_torch.utils.dtypes import F32

SMS = 132
BATCHES = (1, 5, 64, 80)


def _dims(cfg):
    sp = cfg.speaker
    return (sp.embed_dim, sp.rnn_size, sp.input_dim, sp.word_embed_size,
            sp.vocab_size, sp.pos_classes)


DIMS = {"flagship": _dims(load_config()), "smoke": _dims(port_cfg(tiny_cfg()))}
CASES = [(name, b) for name in DIMS for b in BATCHES]


def _plan(name, B):
    return gd.decode_plan(B, *DIMS[name], sms=SMS)


def _units(plan, job):
    """Every unit of a job: (tile, group, product, slice)."""
    for s in range(job.slices_total):
        for tg in range(job.ntiles * plan.groups):
            p = 0 if s < job.slices(0) else 1
            sl = s - (job.slices(0) if p else 0)
            yield tg // plan.groups, tg % plan.groups, p, sl


@pytest.mark.parametrize("name,B", CASES)
def test_every_product_column_and_k_covered_once(name, B):
    plan = _plan(name, B)
    assert plan.groups == -(-B // 64)
    kinds = []
    for jobs in plan.phases:
        for job in jobs:
            kinds.append(job.kind)
            seen = {}
            for tile, grp, p, sl in _units(plan, job):
                k0, k1 = job.k_bounds(p, sl)
                for col in job.columns(tile):
                    if col is None:
                        continue
                    key = (grp, p, col)
                    seen.setdefault(key, []).append((k0, k1))
            for p, K in enumerate(job.ks_of):
                for grp in range(plan.groups):
                    for col in range(job.n):
                        spans = sorted(seen.pop((grp, p, col)))
                        assert spans[0][0] == 0 and spans[-1][1] == K
                        assert all(a[1] == b[0]
                                   for a, b in zip(spans, spans[1:]))
            assert not seen
    assert sorted(kinds) == list(range(8))


@pytest.mark.parametrize("name,B", CASES)
def test_each_weight_read_once_a_step_up_to_64_rows(name, B):
    """A unit spans all rows of a batch of <= 64, so each weight element
    is in exactly one unit a step; above 64, once per row group."""
    plan = _plan(name, B)
    assert plan.bu_pad == -(-min(B, 64) // 16) * 16
    for jobs in plan.phases:
        for job in jobs:
            reads = {}
            for tile, grp, p, sl in _units(plan, job):
                k0, k1 = job.k_bounds(p, sl)
                for col in job.columns(tile):
                    if col is not None:
                        for k in (k0, k1 - 1):
                            reads[(p, k, col)] = reads.get((p, k, col), 0) + 1
            assert set(reads.values()) == {plan.groups}
            assert plan.groups == (1 if B <= 64 else 2)


@pytest.mark.parametrize("name,B", CASES)
def test_slices_are_multiples_of_16_and_padding_stays_in_the_weight(name, B):
    plan = _plan(name, B)
    for jobs in plan.phases:
        for job in jobs:
            assert job.ks % 16 == 0 and job.nu in gd.NU_CHOICES
            for p, K in enumerate(job.ks_of):
                for s in range(job.slices(p)):
                    k0, k1 = job.k_bounds(p, s)
                    assert k0 % 16 == 0 and k0 < k1 <= K
                    assert k1 % 16 == 0 or k1 == K
            for tile in range(job.ntiles):
                cols = job.columns(tile)
                assert len(cols) == job.nu
                assert all(c is None or 0 <= c < job.n for c in cols)
            # the last tile holds at least one column, the ones before are full
            assert any(c is not None for c in job.columns(job.ntiles - 1))
            assert all(c is not None for t in range(job.ntiles - 1)
                       for c in job.columns(t))
    assert plan.lda % 64 == 0
    assert plan.lda >= max(min(j.ks, -(-k // 16) * 16)
                            for js in plan.phases for j in js for k in j.ks_of)
    for itemsize in (2, 4):
        plan = gd.decode_plan(B, *DIMS[name], sms=SMS, itemsize=itemsize)
        need = gd.product_smem(plan.bu_pad, plan.lda, itemsize)
        assert need <= plan.smem <= gd.SMEM_LIMIT
        # the split-K sums of a unit fit the ring: 8 warps (bf16) or 16
        # thread groups of 4 columns (f32) along K
        assert 128 * plan.bu_pad * 4 <= gd.RING_STAGES * gd.STAGE_BYTES
        # the reducing unit stages every slice's f32 partial there too,
        # and its epilogue's operands after them
        for jobs in plan.phases:
            for job in jobs:
                red = gd.reducer_smem(job.kind, job.slices_total, plan.bu_pad,
                                      job.nu, itemsize)
                assert job.slices_total * plan.bu_pad * job.nu * 4 < red
                assert red <= need
    # bf16 at flagship width: two blocks an SM (113 KB each at most)
    if name == "flagship":
        assert _plan(name, B).smem <= 113 * 1024 - 2048


@pytest.mark.parametrize("name,B", CASES)
def test_gate_tiles_hold_the_four_gates_of_the_same_hidden_units(name, B):
    R = DIMS[name][1]
    plan = _plan(name, B)
    gate_kinds = set()
    for jobs in plan.phases:
        for job in jobs:
            if not job.gates:
                continue
            gate_kinds.add(job.kind)
            hid = job.nu // 4
            assert job.n == 4 * R and hid % 8 == 0
            for tile in range(job.ntiles):
                cols = job.columns(tile)
                for j in range(hid):
                    four = [cols[q * hid + j] for q in range(4)]
                    if four[0] is None:
                        assert four == [None] * 4
                        continue
                    h = four[0]
                    assert four == [h, R + h, 2 * R + h, 3 * R + h]
                    assert h == tile * hid + j
    assert gate_kinds == {gd.MOD, gd.LANG}


def _max_units(job_kinds, dims, groups):
    """The most units a phase could have: 16-row slices and the narrowest
    tiles its jobs share (a phase with gate tiles takes gate widths)."""
    total = 0
    gates = any(gd._products(k, *dims[:5])[2] for k in job_kinds)
    nu = min(gd.GATE_NU_CHOICES if gates else gd.NU_CHOICES)
    for kind in job_kinds:
        kp, n, g = gd._products(kind, *dims[:5])
        cols = n // 4 if g else n
        total += -(-cols // (nu // 4 if g else nu)) * groups * sum(
            -(-k // 16) for k in kp)
    return total


@pytest.mark.parametrize("name,B", CASES)
def test_each_phase_fills_the_card_where_its_k_allows(name, B):
    plan = _plan(name, B)
    for phase, jobs in enumerate(plan.phases):
        units = plan.units(phase)
        if _max_units(gd.PHASE_KINDS[phase], DIMS[name], plan.groups) >= SMS:
            assert units >= SMS, (phase, units)
    if name == "flagship":          # every flagship phase reaches the card
        assert all(plan.units(p) >= SMS for p in range(5))


@pytest.mark.parametrize("name,B", CASES)
def test_the_array_the_kernel_reads(name, B):
    plan = _plan(name, B)
    arr = plan.array()
    assert len(arr) == 5 * gd.PHASE_INTS
    for phase, jobs in enumerate(plan.phases):
        row = arr[phase * gd.PHASE_INTS:(phase + 1) * gd.PHASE_INTS]
        assert row[:2] == [len(jobs), plan.units(phase)]
        unit = part = ticket = 0
        for i, job in enumerate(jobs):
            f = row[2 + i * gd.JOB_INTS:2 + (i + 1) * gd.JOB_INTS]
            n_units = job.ntiles * plan.groups * job.slices_total
            assert f[0] == job.kind and f[1] == job.nu and f[3] == job.ks
            assert f[9:13] == [unit, n_units, part, ticket]
            assert f[6] + f[8] == job.slices_total
            unit += n_units
            part += n_units * plan.bu_pad * job.nu
            ticket += job.ntiles * plan.groups
        assert unit == plan.units(phase)
        assert part <= plan.part_floats and ticket <= plan.tickets


@pytest.mark.parametrize("name,B", [("smoke", 5), ("smoke", 80)])
def test_packed_weights_hold_each_tile_column(name, B):
    """pack_weight: packed[t, k, j] is the weight at the tile column's
    weight column, zero on padding; each kind packs its products."""
    plan = _plan(name, B)
    g = torch.Generator().manual_seed(1)
    for jobs in plan.phases:
        for job in jobs:
            assert len(gd.PRODUCT_WEIGHTS[job.kind]) == len(job.ks_of)
            for K in job.ks_of:
                w = torch.randn(K, job.n, generator=g)
                packed = gd.pack_weight(w, job)
                assert packed.shape == (job.ntiles, K, job.nu)
                assert packed.is_contiguous()
                for t in range(job.ntiles):
                    for j, col in enumerate(job.columns(t)):
                        want = w[:, col] if col is not None else 0 * w[:, 0]
                        assert torch.equal(packed[t, :, j], want)


def test_kernel_constants_match_the_plan():
    """The kernel's copy of the plan's layout constants."""
    src = (Path(gd.__file__).resolve().parent.parent / "csrc"
           / "greedy_decode.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRingStages") == gd.RING_STAGES
    assert const("kStageBytes") == gd.STAGE_BYTES
    assert const("kMaxJobs") == gd.MAX_JOBS
    assert const("kJobInts") == gd.JOB_INTS
    assert const("kRowsPerGroup") == gd.ROWS_PER_GROUP
    kinds = re.search(r"enum Kind \{([^}]*)\}", src).group(1)
    assert [k.strip() for k in kinds.split(",")] == [
        "MOD", "VPOS", "ZX", "ZH", "G1", "G2", "LANG", "LOGIT"]
    fields = re.search(r"enum JobField \{([^}]*)\}", src).group(1)
    assert len([f for f in fields.split(",") if f.strip()]) == gd.JOB_INTS
    # blocks an SM: the plan's cost model counts the kernel's rounds
    blocks = dict(re.findall(
        r"struct BlocksPerSm(<__nv_bfloat16>)? \{ static constexpr int "
        r"v = (\d+); \}", src))
    assert int(blocks["<__nv_bfloat16>"]) == gd.blocks_per_sm(2)
    assert int(blocks[""]) == gd.blocks_per_sm(4)


def _aliased_set(store, plan, seed):
    """A product-weight set whose tensors are new tensor objects on
    `store`, as when the allocator hands a dropped set's memory to a new
    one: the same addresses and versions, other values."""
    g = torch.Generator().manual_seed(seed)
    jobs = {j.kind: j for js in plan.phases for j in js}
    w, off = {}, 0
    for kind, names in gd.PRODUCT_WEIGHTS.items():
        for n, K in zip(names, jobs[kind].ks_of):
            shape = (K, jobs[kind].n)
            x = torch.empty(0).set_(store, off, shape)
            x.copy_(torch.randn(shape, generator=g))
            w[n], off = x, off + K * jobs[kind].n
    return w


def test_packed_weights_follow_their_own_parameter_set():
    """Set 1 at X, set 2 at Y, set 1 dropped, set 3 at X again: each
    takes its own packing, never the one cached for set 1."""
    plan = _plan("smoke", 5)
    jobs = {j.kind: j for js in plan.phases for j in js}
    kinds = {n: kind for kind, ns in gd.PRODUCT_WEIGHTS.items() for n in ns}
    gd._packed.clear()
    total = sum(K * j.n for j in jobs.values() for K in j.ks_of)
    x_store = torch.empty(total).untyped_storage()
    y_store = torch.empty(total).untyped_storage()

    def check(w):
        packed = gd._packed_weights(w, plan)
        for n, x in w.items():
            assert torch.equal(packed[n], gd.pack_weight(x, jobs[kinds[n]]))

    set1 = _aliased_set(x_store, plan, 1)
    check(set1)
    set2 = _aliased_set(y_store, plan, 2)
    check(set2)
    ptrs1 = {n: x.data_ptr() for n, x in set1.items()}
    del set1
    set3 = _aliased_set(x_store, plan, 3)
    assert {n: x.data_ptr() for n, x in set3.items()} == ptrs1
    check(set3)
    check(set2)
    # a parameter changed in place packs anew; an unchanged set is reused
    first = gd._packed_weights(set3, plan)
    assert gd._packed_weights(set3, plan) is first
    set3["wlogit"].mul_(2)
    check(set3)
    gd._packed.clear()


@pytest.mark.parametrize("bad", [
    dict(B=0), dict(R=0), dict(sms=0),
    dict(P=60000),                  # phase 2's row buffers overflow
])
def test_plan_raises_on_shapes_it_cannot_take(bad):
    args = dict(B=4, E=64, R=32, D=64, W=24, V=148, P=16, sms=SMS)
    args.update(bad)
    with pytest.raises(ValueError, match="decode_plan"):
        gd.decode_plan(**args)


def test_wrapper_raises_before_launching(monkeypatch):
    """The wrapper checks shapes, then takes the plan, before it loads
    the kernel: a shape the plan cannot take raises ValueError."""
    cfg = port_cfg(tiny_cfg()).speaker
    B, (E, R, D, W, V, P) = 2, DIMS["smoke"]

    class Props:
        multi_processor_count = SMS

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())
    big = cfg.replace(pos_classes=60000)
    shapes = {"wemb": (V, W), "wih_mod": (E + R, 4 * R),
              "whh_mod": (R, 4 * R), "b_mod": (4 * R,), "wfc": (R, 3),
              "bfc": (3,), "wpos1": (R, R), "bpos1": (R,),
              "wwp": (R, 60000), "bwp": (60000,), "wpos2": (60000, R),
              "bpos2": (R,), "wg1": (2 * R + D, 2 * R + D),
              "bg1": (2 * R + D,), "wg2": (2 * R + D, D), "bg2": (D,),
              "wih_x": (W, 4 * R), "wih_a": (D, 4 * R),
              "whh_lang": (R, 4 * R), "b_lang": (4 * R,), "wlogit": (R, V),
              "blogit": (V,)}
    w = {k: torch.zeros(s) for k, s in shapes.items()}
    fused, feats = torch.zeros(B, E), torch.zeros(B, 3, D)
    with pytest.raises(ValueError, match="decode_plan"):
        gd._launch(w, big, F32, fused, feats, None)
    with pytest.raises(ValueError, match="wemb has shape"):
        gd._launch(dict(w, wemb=torch.zeros(V, W + 1)), big, F32, fused,
                   feats, None)
    gd._plans.clear()


def test_plain_scratch_is_the_last_step():
    """`scratch=True` returns the step's intermediates; at one step the
    logits give the step-0 token and logprob."""
    cfg = port_cfg(tiny_cfg()).speaker.replace(seq_length=1)
    E, R, D, W, V, P = DIMS["smoke"]
    g = torch.Generator().manual_seed(0)
    shapes = {"wemb": (V, W), "wih_mod": (E + R, 4 * R),
              "whh_mod": (R, 4 * R), "b_mod": (4 * R,), "wfc": (R, 3),
              "bfc": (3,), "wpos1": (R, R), "bpos1": (R,), "wwp": (R, P),
              "bwp": (P,), "wpos2": (P, R), "bpos2": (R,),
              "wg1": (2 * R + D, 2 * R + D), "bg1": (2 * R + D,),
              "wg2": (2 * R + D, D), "bg2": (D,), "wih_x": (W, 4 * R),
              "wih_a": (D, 4 * R), "whh_lang": (R, 4 * R),
              "b_lang": (4 * R,), "wlogit": (R, V), "blogit": (V,)}
    w = {k: torch.randn(s, generator=g) * 0.1 for k, s in shapes.items()}
    B = 3
    fused = torch.randn(B, E, generator=g)
    feats = torch.randn(B, 3, D, generator=g)
    out = gd.greedy_decode(w, cfg, F32, fused, feats, scratch=True)
    want = {"vpos": R, "zx": 4 * R, "zh": 4 * R, "h_mod": R,
            "gate_h": 2 * R + D, "ga": D, "h_lang": R, "logits": V}
    assert set(gd.SCRATCH_NAMES) == set(want)
    for k, n in want.items():
        assert tuple(out[k].shape) == (B, n)
    assert not out["zh"].any()          # h_lang is 0 at step 0
    logp = torch.log_softmax(out["logits"], -1)
    logp[:, 0] = -float("inf")
    torch.testing.assert_close(logp.max(-1).values, out["logprobs"][:, 0])
    assert torch.equal(logp.argmax(-1).int(), out["seq"][:, 0])
    plain = gd.greedy_decode_plain(w, cfg, F32, fused, feats)
    assert set(plain) == {"seq", "logprobs", "module_weights"}
