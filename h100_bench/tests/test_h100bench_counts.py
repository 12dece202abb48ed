"""The operation and byte counts behind k1_roofline.* and mfu.*: K1's
against phase 5 of chip_smoke.py (its arithmetic copied here, not
imported), the model's against hand counts and against torch's FLOP
counter over the reference at small shapes."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _tiny import dims
from benchlib import counts, program
from benchlib.env import BENCH_DIR

PEAK_BF16 = 989e12
HBM = 3.35e12


def flagship(name="ekaid-mode2"):
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    return program.model_dims(cfg, cfg["overlay"])


def phase5(m, B, steps):
    """chip_smoke.py phase 5's K1 operations and bytes, copied."""
    E, R, D = m["embed_dim"], m["rnn_size"], m["input_dim"]
    W, V, P = m["word_embed_size"], m["vocab_size"], m["pos_classes"]
    G = 2 * R + D
    macs_row = ((E + R) * 4 * R + R * 4 * R + R * 3 + R * R + R * P + P * R
                + G * G + G * D + W * 4 * R + D * 4 * R + R * 4 * R + R * V)
    ops = 2.0 * B * macs_row * steps
    return ops, max(ops / PEAK_BF16, 0) * 1e3


def test_k1_count_equals_phase5_at_flagship_widths():
    m = flagship()
    ops, bound_ms = phase5(m, 64, 90)
    k = counts.k1_bound(m, 64, 90)
    assert k["ops"] == ops
    assert k["bound_by"] == "operations"
    assert k["bound_s"] * 1e3 == pytest.approx(bound_ms)
    assert k["bound_s"] * 1e3 == pytest.approx(0.170, abs=5e-4)


def test_k1_bytes_are_the_programs_decode_weights_once():
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.utils.dtypes import BF16
    m = flagship()
    cfg = json.loads((BENCH_DIR / "configs" / "ekaid-mode2.json").read_text())
    model = EkaidModel(program.program_config(cfg["overlay"]), ntoken=147,
                       policy=BF16, device="cpu", seed=0)
    w = model.speaker.decode_weights()
    wbytes = sum(x.numel() * x.element_size() for x in w.values())
    B, T = 64, m["seq_length"]
    io = wbytes + B * m["embed_dim"] * 2 + B * 3 * m["input_dim"] * 2 \
        + B * T * (4 + 4 + 12)
    assert counts.k1_bound(m, B, 90)["bytes"] == io


def test_k1_count_by_hand_at_small_shapes():
    m = dict(embed_dim=2, rnn_size=1, input_dim=2, word_embed_size=1,
             vocab_size=3, pos_classes=1, seq_length=4)
    # G = 4: 3*4 + 4 + 3 + 1 + 1 + 1 + 16 + 8 + 4 + 8 + 4 + 3
    assert counts.decode_macs_per_row_step(m) == 65
    assert counts.k1_bound(m, 2, 3)["ops"] == 2 * 2 * 65 * 3
    assert counts.model_step_macs(m) == 65 + 6


def test_steps_run_counts_to_the_last_token():
    seq = torch.tensor([[5, 6, 0, 0, 0], [7, 0, 0, 0, 0]])
    assert counts.steps_run(seq) == 3
    assert counts.steps_run(torch.ones(2, 5, dtype=torch.long)) == 5
    assert counts.steps_run(torch.zeros(2, 5, dtype=torch.long)) == 1


def test_trunk_by_hand():
    # R101 at 128^2 (the mode0 images): 16 cells of 2048 channels
    assert counts.trunk_cells(128) == 16
    # one bottleneck stage of depth 1 at a 4x4 input, channels 8
    s = counts.trunk_ops(8, depths=(1,), channels=(8,))
    # stem 7x7 3->64 at 4x4, pool to 2x2, then 1x1 64->2, 3x3 2->2,
    # 1x1 2->8 and the 1x1 64->8 shortcut at 2x2
    want = 2 * (3 * 64 * 49 * 16 + (64 * 2 + 2 * 2 * 9 + 2 * 8 + 64 * 8) * 4)
    assert s == want


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _inputs(m, B, seed=3):
    from benchlib import data
    c = {"qa_rows": B, "images": 2 * B, "pairing": "disjoint",
         "questions_per_pair": 1, "question_types": [[5, 6, 7]]}
    corpus = data.make_corpus(c, m, seed, "cpu")
    return data.batch(corpus, list(range(B)), m, "cpu")


@pytest.mark.parametrize("config", ["ekaid-mode2", "ekaid-mode0"])
def test_encoder_and_decode_counts_against_the_flop_counter(config):
    _, _, m = dims(config)
    ref = program.reference(m, "cpu")
    B, T = 2, m["seq_length"]
    b = _inputs(m, B)
    with torch.no_grad():
        enc_flops = _flops(lambda: ref.encode(b))
        assert enc_flops == pytest.approx(counts.encoder_ops(m, B),
                                          rel=1e-9)
        enc = ref.encode(b)
        seq = torch.full((B, T), 5, dtype=torch.long)
        dec_flops = _flops(lambda: ref.speaker.run(enc, seq))
    assert dec_flops == pytest.approx(
        counts.fused_ops(m, B) + 2.0 * B * counts.model_step_macs(m) * T,
        rel=1e-9)
    assert counts.eval_ops(m, B, T) == pytest.approx(enc_flops + dec_flops)



def test_mfu_reads_the_traced_busy_time():
    from benchlib import layers
    from benchlib.trace import Summary
    s = Summary(window_s=2.0, busy_s=0.5, device_ops={"k": (0.5, 3)})
    assert layers.mfu({"summary": s, "model_ops": 0.01 * 989e12 * 0.5}) \
        == pytest.approx(1.0)
    assert layers.mfu({"summary": None, "model_ops": 1e12}) is None
    assert layers.mfu({"summary": s, "model_ops": 0}) is None
