"""The LM cell (`dsv2lite-eval-b64`, `drivers/eval_lm.py`) on the CPU at
small widths: a whole run past the harness's look for a chip reads
`correct` true, and false with a token altered where the decode
produces it, with half of each batch left undecoded, and with the
float8 reference in the program's place. Then its pieces: the launch
correlation (`benchlib/launches.py`), the readers of its three metrics
(nothing to read gives None), its counts (`benchlib/counts_lm.py`)
against the program's parameters at the published widths, and the
seeded weights, made alike for the program and the reference."""

import pytest
import torch

import run
from benchlib import counts_lm, launches, spec
from benchlib.env import BENCH_DIR

BENCH = spec.benchmark()
CELL = "dsv2lite-eval-b64"
eval_lm = spec.import_file(BENCH_DIR / "drivers" / "eval_lm.py")
SEED = 2 ** 32 + 5
#: small widths of every kind of layer; 8 nodes, 8-token answers. The
#: hidden size stays at 1024 so that the seeded N(0, 0.02) weights give
#: logits spread as at the published widths (std ~0.6; at 64 they are
#: nearly flat, and the control's float8 error hides in them)
LM = {"vocab_size": 1024, "hidden_size": 1024, "intermediate_size": 256,
      "moe_intermediate_size": 64, "num_hidden_layers": 4,
      "num_attention_heads": 4, "num_key_value_heads": 4,
      "n_routed_experts": 8, "num_experts_per_tok": 3,
      "n_shared_experts": 2, "kv_lora_rank": 64, "qk_nope_head_dim": 32,
      "qk_rope_head_dim": 16, "v_head_dim": 32, "bos_token_id": 1000,
      "eos_token_id": 1001}
PATCH = {
    "overlay": {
        "change_detector": {"att_dim": 32, "att_head": 4, "dim": 16,
                            "pos_emb_dim": 16, "nongt_dim": 8},
        "speaker": {"input_dim": 32, "rnn_size": 16, "embed_input_dim": 96,
                    "embed_dim": 24, "word_embed_size": 12,
                    "seq_length": 8},
        "data": {"num_nodes": 8, "feature_dim": 16, "adj_pad": 10,
                 "train": {"batch_size": 8}, "test": {"batch_size": 8}},
        "lm": LM, "dtypes": {"compute_dtype": "float32"}},
    "traffic": {"corpus": {"qa_rows": 64, "images": 32}}}


def run_cpu(faults=(), control=""):
    cell = spec.cell(CELL, BENCH)
    return run.run_cell(cell, SEED, 1.5, False, device="cpu", patch=PATCH,
                        faults=faults, bench=BENCH, control=control)


def failed(out):
    return sorted(k for k, c in out["checks"].items()
                  if not (c["value"] is not None and c["value"] <= c["limit"]))


def test_sound_run_is_correct():
    out = run_cpu()
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"token_gap_mean", "logprob_rms",
                                  "answers_wrong"}
    assert out["window_log"]["lm_param_dtypes"] == ["torch.float32"]
    # 4 layers, 8 rows, prompt 2 x 8 + 3 + 20 + 1 = 40 and 7 answer
    # positions fed back; 64 + 16 values a token and layer
    assert out["window_log"]["cache_shape"] == [4, 8, 47, 80]
    assert out["window_log"]["steps"] == [8, 8]


@pytest.mark.parametrize("fault", ["alter_token", "half_batch"])
def test_fault_is_caught(fault):
    out = run_cpu(faults=(fault,))
    assert not out["correct"] and failed(out), out["checks"]


def test_control_fails():
    """The references in float8 e4m3 in the program's place fail both
    numbers (read here 0.077 and 0.18 against the limits 0.01 and 0.1)."""
    out = run_cpu(control="fp8")
    assert failed(out) == ["logprob_rms", "token_gap_mean"], out["checks"]


def test_launches_inside_spans():
    """A device operation counts for the span its launch call started
    in, on the span's thread, whenever it ran on the device."""
    ev = [(False, 0, 100, "ekaid.lm.step", 1, 0, False),
          (False, 200, 300, "ekaid.lm.step", 1, 0, False),
          (False, 400, 500, "ekaid.lm.prefill", 1, 0, False),
          (False, 10, 12, "cudaLaunchKernel", 1, 7, False),
          (False, 20, 22, "cudaLaunchKernel", 2, 8, False),   # other thread
          (False, 150, 152, "cudaLaunchKernel", 1, 9, False),  # no span
          (False, 210, 212, "cudaMemcpyAsync", 1, 10, False),
          (False, 410, 412, "cudaLaunchKernel", 1, 11, False),
          (False, 420, 422, "aten::mm", 1, 12, False),         # not a launch
          (True, 190, 260, "gemm", 0, 7, False),
          (True, 30, 35, "gemm", 0, 8, False),
          (True, 160, 170, "gemm", 0, 9, False),
          (True, 600, 650, "Memcpy DtoH", 0, 10, False),
          (True, 700, 900, "gemm", 0, 11, False),
          (True, 900, 950, "gemm", 0, 12, False)]
    got = launches.reduce_launches(ev, ("ekaid.lm.step", "ekaid.lm.prefill",
                                        "ekaid.lm.connect"))
    assert got["ekaid.lm.step"] == {"spans": 2, "device_s": 120e-9,
                                    "ops": 2}
    assert got["ekaid.lm.prefill"] == {"spans": 1, "device_s": 200e-9,
                                       "ops": 1}
    assert got["ekaid.lm.connect"] == {"spans": 0, "device_s": 0.0,
                                       "ops": 0}


@pytest.mark.parametrize("name", ["mfu.lmeval", "lm_step_roofline.lmeval",
                                  "lm_prefill_ms.lmeval"])
def test_readers_read_nothing_without_the_lm(name):
    reader = spec.metric_reader(name)
    assert reader.read({"summary": None}) is None
    assert reader.read({"summary": object(), "lm_decodes": 0, "lm": {},
                        "model_ops": 0.0, "step_bound_s": 0.0}) is None


def test_readers_arithmetic():
    from benchlib.trace import Summary
    ctx = {"summary": Summary(2.0, 1.0, {"k": (1.0, 3)}), "lm_decodes": 2,
           "model_ops": 989e12 * 0.03, "step_bound_s": 0.9,
           "lm": {"ekaid.lm.step": {"spans": 180, "device_s": 1.8,
                                    "ops": 9},
                  "ekaid.lm.prefill": {"spans": 2, "device_s": 0.3,
                                       "ops": 4}}}
    read = {n: spec.metric_reader(n).read(ctx) for n in
            ("mfu.lmeval", "lm_step_roofline.lmeval",
             "lm_prefill_ms.lmeval")}
    assert read == pytest.approx({"mfu.lmeval": 3.0,
                                  "lm_step_roofline.lmeval": 50.0,
                                  "lm_prefill_ms.lmeval": 150.0})


def test_counts_against_the_program_at_published_widths():
    from ekaid_torch.config import load_config
    from ekaid_torch.models.lm_decoder import LMDecoder
    cfg = load_config("configs/mimic_dsv2lite.yaml")
    lm = BENCH_LM()
    with torch.device("meta"):
        prog = LMDecoder(cfg)
    by = {"embed": "embed_tokens.", "head": "lm_head.",
          "projector": "projector.", "routed": ".experts.",
          "gate": ".mlp.gate.", "shared": ".shared_experts."}
    p = counts_lm.params(lm, 1024)
    n = {k: 0 for k in p}
    for name, t in prog.named_parameters():
        part = next((k for k, s in by.items() if s in name), None)
        if part is None:
            part = ("attention" if ".self_attn." in name else
                    "norms" if name.endswith("norm.weight") else "dense")
        n[part] += t.numel()
    assert n == p
    assert sum(p.values()) - p["projector"] == 15_706_484_224
    assert counts_lm.cache_values(lm) == 576
    b = counts_lm.step_bound(lm, 64, 127)
    assert b["bound_by"] == "bytes"
    # 15.49 B parameters read a step (all but the embedding table)
    assert 9.2e-3 < b["bound_s"] < 9.4e-3
    # the whole eval batch: ~36.7 TFLOP of prefill, ~0.31 of each step
    assert counts_lm.prefill_ops(lm, 64, 128) == pytest.approx(36.7e12,
                                                              rel=0.02)


def BENCH_LM():
    return spec.cell(CELL, BENCH).config["overlay"]["lm"]


def test_config_file_holds_the_catalog_entry_and_the_program_reads_it():
    """Every key of the published config sits at the top of the file and,
    beside the token ids, in the overlay's `lm` section, which the
    program reads as its defaults."""
    import dataclasses
    from ekaid_torch.config import LMConfig
    config = spec.cell(CELL, BENCH).config
    lm = config["overlay"]["lm"]
    catalog = {k: v for k, v in config.items()
               if k in lm and k not in ("overlay",)}
    assert len(catalog) == 32 and config["reduced"] == []
    assert all(lm[k] == v for k, v in catalog.items())
    assert dataclasses.asdict(LMConfig()) == {
        **lm, "rope_scaling": {**lm["rope_scaling"]}}


def test_seeded_weights_alike_on_both_sides():
    shapes = {"layers.1.mlp.experts.up_proj": (4, 3, 5),
              "layers.0.input_layernorm.weight": (5,),
              "projector.0.bias": (5,), "lm_head.weight": (9, 5)}
    w = eval_lm.SeededWeights(shapes, SEED, "cpu", eos=4)
    for name, shape in shapes.items():
        a = eval_lm.lm_weight(name, shape, SEED, "cpu", 4)
        assert a.dtype == torch.bfloat16
        assert torch.equal(w[name], a.float())
    assert torch.equal(w["layers.0.input_layernorm.weight"], torch.ones(5))
    assert (w["lm_head.weight"][4] == 0).all()
    assert not torch.equal(w["lm_head.weight"],
                           eval_lm.lm_weight("lm_head.weight", (9, 5),
                                             SEED + 1, "cpu", 4).float())
    x = w["layers.1.mlp.experts.up_proj"]
    assert 0.005 < float(x.std()) < 0.05
