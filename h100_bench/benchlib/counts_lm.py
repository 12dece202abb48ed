"""Operations and bytes of the LM answer decoder (DeepSeek-V2 behind a
projector), from shapes, the steps run and the cache lengths.

The counts follow the model's mathematics, never how the program
computes it: a multiply-add is two operations; each token's projections
(its query, latent, keys and values, output) are counted once, at the
step that brings the token in, and its attention over c positions as
c x heads x (qk_head_dim + v_head_dim) multiply-adds; an MoE layer
counts the experts a token is routed to and the shared experts, never
the experts it is not routed to; the prompt's logits only at its last
position. So the absorbed decode step (W_UK folded into the query) and
the expanded one count the same.

Bytes (the least a decode step must move): every weight of the LM read
once a step, the embedding table but for the rows looked up (all
routed experts of every MoE layer: at 64 rows a step and 6 experts a
token nearly every expert is hit, and the bound is the same for every
routing), the latent cache read at its length (positions 0 to the
step's own) and the step's latents written, in the parameters' dtype.

`lm` is the `lm` section of a configuration (the published config.json
names); `att_dim` the projector's input width.
"""

from __future__ import annotations

from benchlib.counts import HBM_BYTES_PER_S, MFU_PEAK, encoder_ops

#: bytes of a parameter and of a cached value (bf16)
ITEMSIZE = 2


def _attn_dims(lm: dict):
    H = lm["num_attention_heads"]
    dn, dr, dv = lm["qk_nope_head_dim"], lm["qk_rope_head_dim"], \
        lm["v_head_dim"]
    return H, dn, dr, dv, lm["kv_lora_rank"]


def is_moe(lm: dict, i: int) -> bool:
    return i >= lm["first_k_dense_replace"] and i % lm["moe_layer_freq"] == 0


def params(lm: dict, att_dim: int) -> dict:
    """Parameter counts by part: embed, head, attention (all layers),
    dense (dense-MLP layers), routed (all experts), shared, gate, norms,
    projector."""
    D, V = lm["hidden_size"], lm["vocab_size"]
    H, dn, dr, dv, r = _attn_dims(lm)
    attn = D * H * (dn + dr) + D * (r + dr) + r + r * H * (dn + dv) \
        + H * dv * D
    I, E = lm["moe_intermediate_size"], lm["n_routed_experts"]
    out = {"embed": V * D, "head": V * D, "attention": 0, "dense": 0,
           "routed": 0, "shared": 0, "gate": 0,
           "norms": D * (2 * lm["num_hidden_layers"] + 1),
           "projector": att_dim * D + D + D * D + D}
    for i in range(lm["num_hidden_layers"]):
        out["attention"] += attn
        if is_moe(lm, i):
            out["routed"] += E * 3 * D * I
            out["shared"] += 3 * D * I * lm["n_shared_experts"]
            out["gate"] += E * D
        else:
            out["dense"] += 3 * D * lm["intermediate_size"]
    return out


def token_macs(lm: dict) -> int:
    """Multiply-adds of one token through every layer, attention over
    its context aside: projections, the MLP or the routed and shared
    experts and the gate."""
    D = lm["hidden_size"]
    H, dn, dr, dv, r = _attn_dims(lm)
    macs = 0
    for i in range(lm["num_hidden_layers"]):
        macs += D * H * (dn + dr) + D * (r + dr) + r * H * (dn + dv) \
            + H * dv * D
        if is_moe(lm, i):
            I = lm["moe_intermediate_size"]
            macs += 3 * D * I * (lm["num_experts_per_tok"]
                                 + lm["n_shared_experts"])
            macs += lm["n_routed_experts"] * D
        else:
            macs += 3 * D * lm["intermediate_size"]
    return macs


def attention_macs(lm: dict, context: int) -> int:
    """One token attending over `context` positions, every layer."""
    H, dn, dr, dv, _ = _attn_dims(lm)
    return lm["num_hidden_layers"] * context * H * (dn + dr + dv)


def head_macs(lm: dict) -> int:
    return lm["hidden_size"] * lm["vocab_size"]


def projector_ops(lm: dict, att_dim: int, rows: int, vectors: int) -> float:
    D = lm["hidden_size"]
    return 2.0 * rows * vectors * (att_dim * D + D * D)


def prefill_ops(lm: dict, rows: int, length: int) -> float:
    """The prompt of `length` positions, causal, and its last logits."""
    ctx = length * (length + 1) // 2
    return 2.0 * rows * (length * token_macs(lm) + attention_macs(lm, 1)
                         * ctx + head_macs(lm))


def step_ops(lm: dict, rows: int, position: int) -> float:
    """One decode step's forward of the token at `position` (0-based;
    it attends over position + 1 places) and its logits."""
    return 2.0 * rows * (token_macs(lm) + attention_macs(lm, position + 1)
                         + head_macs(lm))


def weight_bytes_per_step(lm: dict, rows: int) -> float:
    p = params(lm, 0)
    n = sum(v for k, v in p.items() if k not in ("embed", "projector"))
    return ITEMSIZE * (n + rows * lm["hidden_size"])


def cache_values(lm: dict) -> int:
    """Values the cache holds a token and layer."""
    return lm["kv_lora_rank"] + lm["qk_rope_head_dim"]


def step_bound(lm: dict, rows: int, position: int) -> dict:
    """The least time of one decode step's forward at `position`: the
    larger of its operations over the bf16 peak and its bytes over HBM
    bandwidth."""
    ops = step_ops(lm, rows, position)
    cache = ITEMSIZE * rows * lm["num_hidden_layers"] * cache_values(lm) \
        * (position + 2)              # read 0..position, write position
    nbytes = weight_bytes_per_step(lm, rows) + cache
    ops_s, bytes_s = ops / MFU_PEAK, nbytes / HBM_BYTES_PER_S
    return {"ops": ops, "bytes": nbytes, "bound_s": max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def steps_needed(seq) -> int:
    """Steps a decode of `seq` [B, T] (END, negative, from each row's EOS
    on) needs: up to the step where its last row ended, or T."""
    ended = seq < 0
    if not bool(ended.any(dim=1).all()):
        return seq.shape[1]
    return int(ended.int().argmax(dim=1).max()) + 1


def decode_bound_s(lm: dict, rows: int, prompt: int, steps: int) -> float:
    """The least time of a decode's steps: the forwards of steps 0 to
    steps - 2 (the last step picks its token and runs no forward)."""
    return sum(step_bound(lm, rows, prompt + t)["bound_s"]
               for t in range(steps - 1))


def eval_ops(dims: dict, lm: dict, rows: int, prompt: int,
             steps: int) -> float:
    """One greedy eval batch: the change encoder, the projector, the
    prefill and the decode steps' forwards."""
    vectors = 2 * dims["num_nodes"] + 3
    return (encoder_ops(dims, rows)
            + projector_ops(lm, dims["att_dim"], rows, vectors)
            + prefill_ops(lm, rows, prompt)
            + sum(step_ops(lm, rows, prompt + t) for t in range(steps - 1)))
