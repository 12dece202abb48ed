"""Tiny sizes for CPU runs of the benchmark's cells: the cell's files
with the widths, corpus and window cut down, and the program's compute
dtype set by `dtype`."""

import copy

OVERLAY = {
    "change_detector": {"att_dim": 32, "att_head": 4, "dim": 16,
                        "pos_emb_dim": 16, "nongt_dim": 8},
    "speaker": {"input_dim": 32, "rnn_size": 16, "embed_input_dim": 96,
                "embed_dim": 24, "word_embed_size": 12, "seq_length": 8},
    "data": {"num_nodes": 8, "feature_dim": 16, "adj_pad": 10,
             "train": {"batch_size": 8}, "test": {"batch_size": 8}}}
TRAFFIC = {
    "eval": {"corpus": {"qa_rows": 64, "images": 32}, "batches_per_call": 2,
             "warm_calls": 1}}


def patch(cell, dtype: str = "float32") -> dict:
    overlay = copy.deepcopy(OVERLAY)
    overlay["dtypes"] = {"compute_dtype": dtype}
    return {"overlay": overlay, "config": {"image_size": 64},
            "traffic": copy.deepcopy(TRAFFIC[cell.workload["driver"]])}


def dims(name: str = "ekaid-mode2", dtype: str = "float32"):
    from benchlib import program, spec
    bench = spec.benchmark()
    cell = next(spec.cell(w["name"], bench) for w in bench["workloads"]
                if w["config"] == name)
    p = patch(cell, dtype)
    config = program.merge(cell.config, p["config"])
    overlay = program.merge(config["overlay"], p["overlay"])
    return config, overlay, program.model_dims(config, overlay)
