"""Operation and byte counts from shapes, and the chip's peaks.

The counts follow the model's mathematics and the steps actually
decoded, never how the program computes them: a multiply-add is two
operations, each input byte is read once and each output byte written
once. K1's count is the arithmetic its bound has used since the kernel
was ported (the decode's products per row and step, the bf16 weights,
the fused inputs and the per-step outputs).

Peaks: one NVIDIA H100 SXM at its 700 W limit, from NVIDIA's data sheet
(dense, without sparsity).
"""

from __future__ import annotations

from typing import Sequence

PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
#: the peak a model step's operations are held against (the
#: configuration's compute dtype, bfloat16)
MFU_PEAK = PEAK_OPS["bfloat16"]


def _dims(m: dict):
    E, R, D = m["embed_dim"], m["rnn_size"], m["input_dim"]
    W, V, P = m["word_embed_size"], m["vocab_size"], m["pos_classes"]
    return E, R, D, W, V, P, 2 * R + D


def decode_macs_per_row_step(m: dict) -> int:
    """Multiply-adds of one decode step for one row (the speaker core's
    products and the logits)."""
    E, R, D, W, V, P, G = _dims(m)
    return ((E + R) * 4 * R + R * 4 * R + R * 3 + R * R + R * P + P * R
            + G * G + G * D + W * 4 * R + D * 4 * R + R * 4 * R + R * V)


def model_step_macs(m: dict) -> int:
    """A decode step's multiply-adds for one row as the model computes
    them: K1's products and the attended feature (module weights [3] x
    feats [3, D])."""
    return decode_macs_per_row_step(m) + 3 * m["input_dim"]


def decode_weight_elems(m: dict) -> int:
    """Elements of the decode's weights and biases (the word table
    included), each read once a decode."""
    E, R, D, W, V, P, G = _dims(m)
    return (V * W + (E + R) * 4 * R + R * 4 * R + 4 * R + R * 3 + 3
            + R * R + R + R * P + P + P * R + R + G * G + G + G * D + D
            + W * 4 * R + D * 4 * R + R * 4 * R + 4 * R + R * V + V)


def k1_bound(m: dict, rows: int, steps: int, itemsize: int = 2) -> dict:
    """K1's least time for one greedy decode of `rows` rows that ran
    `steps` steps: the larger of its operations over the bf16 peak and
    its bytes over HBM bandwidth."""
    E, R, D, W, V, P, G = _dims(m)
    T = m["seq_length"]
    ops = 2.0 * rows * decode_macs_per_row_step(m) * steps
    nbytes = (decode_weight_elems(m) * itemsize + rows * E * itemsize
              + rows * 3 * D * itemsize + rows * T * (4 + 4 + 12))
    ops_s = ops / PEAK_OPS["bfloat16"]
    bytes_s = nbytes / HBM_BYTES_PER_S
    return {"ops": ops, "bytes": nbytes, "bound_s": max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def steps_run(seq) -> int:
    """Steps a greedy decode ran: one past the last step any row emitted
    a token, at most the sequence length."""
    live = (seq > 0).any(dim=0).nonzero()
    return min(seq.shape[1], int(live.max()) + 2) if len(live) else 1


# ---- the model's forward, in operations ------------------------------------

def question_ops(m: dict, rows: int) -> float:
    H, L = m["embed_dim"], m["question_len"]
    macs = L * (600 * 3 * H + H * 3 * H + H * H + H + H)
    return 2.0 * rows * macs


def relation_ops(m: dict, rows: int, n: int, pos: bool,
                 labels: int) -> float:
    """One relation encoder over one image of `n` nodes whose graph has
    `labels` edge labels (the implicit graph: one, and positions)."""
    A, Q, heads = m["att_dim"], m["embed_dim"], m["att_head"]
    M = min(m["nongt_dim"], n)
    macs = (n * M * labels              # label bias
            + n * (A + Q) * A           # self_weights
            + n * A * A + M * A * A   # query, key
            + n * M * A               # affinities, all heads
            + n * heads * M * A       # weighted values, whole width a head
            + n * heads * A * A)      # linear_out_2
    if pos:
        macs += n * M * m["pos_emb_dim"] * heads
    return 2.0 * rows * macs


def conv_ops(cin: int, cout: int, k: int, hout: int, wout: int) -> float:
    return 2.0 * cin * cout * k * k * hout * wout


def trunk_ops(size: int, depths: Sequence[int] = (3, 4, 23, 3),
              channels: Sequence[int] = (256, 512, 1024, 2048)) -> float:
    """The R101 trunk (7x7/2 stem, 3x3/2 max pool, bottlenecks with the
    stride on the 3x3) on one size x size image of 3 channels."""
    def out(s, stride):
        return (s + stride - 1) // stride
    s = out(size, 2)
    ops = conv_ops(3, 64, 7, s, s)
    s = out(s, 2)
    prev = 64
    for stage, (depth, ch) in enumerate(zip(depths, channels)):
        for b in range(depth):
            stride = 2 if (b == 0 and stage > 0) else 1
            w = ch // 4
            so = out(s, stride)
            ops += conv_ops(prev, w, 1, s, s) + conv_ops(w, w, 3, so, so)
            ops += conv_ops(w, ch, 1, so, so)
            if stride != 1 or prev != ch:
                ops += conv_ops(prev, ch, 1, so, so)
            s, prev = so, ch
    return ops


def trunk_cells(size: int) -> int:
    s = size
    for _ in range(5):
        s = (s + 1) // 2
    return s * s


def encoder_ops(m: dict, rows: int) -> float:
    """The change encoder for `rows` study pairs: both images through the
    front end, the question, fusion and pooling."""
    A, Q, dim = m["att_dim"], m["embed_dim"], m["dim"]
    ops = question_ops(m, rows)
    if m["setting"] == "mode0":
        S = m["image_size"]
        n = trunk_cells(S)
        per_image = (trunk_ops(S) / 1.0 + 2.0 * n * 2048 * A
                     + 2.0 * n * A * A                    # img
                     + 2.0 * 3 * n * (A + Q) * A          # SSRE q, k, v
                     + 2.0 * 2 * n * n * A)               # scores, context
        ops += 2 * rows * per_image
    else:
        n = m["num_nodes"]
        per_image = (2.0 * n * m["feature_dim"] * A
                     + relation_ops(m, 1, n, False, m["sem_label_num"])
                     + relation_ops(m, 1, n, False, m["spa_label_num"])
                     + relation_ops(m, 1, n, True, 1))
        ops += 2 * rows * per_image
    ops += 2.0 * rows * n * A * A * 6          # context/gate products
    ops += 2.0 * rows * 2 * n * (3 * A * dim + dim)
    ops += 2.0 * rows * A * 6
    return ops


def fused_ops(m: dict, rows: int) -> float:
    return 2.0 * rows * 3 * m["input_dim"] * m["embed_dim"]


def eval_ops(m: dict, rows: int, steps: int) -> float:
    """One greedy eval batch: encoder, the fused input and the steps run."""
    return (encoder_ops(m, rows) + fused_ops(m, rows)
            + 2.0 * rows * model_step_macs(m) * steps)

